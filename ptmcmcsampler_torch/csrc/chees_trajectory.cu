// ChEES trajectory kernel for Hopper (sm_90a).
//
// Replaces ptmcmcsampler_tpu/ops/chees_pallas.py::_chees_kernel. For every
// chain of the [T, C] batch it runs a whitened leapfrog trajectory of the
// chain's own length nsteps, with the chain's own step size and no
// divergence break, and writes the end point (q1, p1, logp1):
//
//   x = chol^T q,  (logp, g) = model(x, beta),  grad_white = chol @ g
//   p += eps/2 grad;  q += eps p;  recompute;  p += eps/2 grad
//   logp1 = NaN ? -inf : logp
//
// Design. One thread per chain, the block 256 threads. Loads and stores use
// the port's chain-minor layout directly: element (t, d, c) of a [T, D, C]
// array is at t*D*C + d*C + c, so neighbouring threads touch neighbouring
// addresses and no transpose is needed around the call. D is a template
// parameter; q, p, the gradient and chol live in registers. Each thread
// loops to its own nsteps and computes its starting logp and gradient
// itself, as the Pallas kernel does. The model is a device functor giving
// the tempered value and gradient (beta*ll + lp, beta*grad ll), from
// models.cuh.
//
// What bounds it on an H100. At the main path's shape (N = 8 * 16384 =
// 131072 chains, D = 2) the kernel reads q0, p0, eps, nsteps (24 bytes a
// chain, plus beta and chol) and writes q1, p1, logp1 (20 bytes a chain):
// about 5.8 MB, under 2 us at 3.35 TB/s. Each leapfrog step of the curved
// model is about 70 floating-point operations and 4 transcendental ones
// (exp, log1p, exp, exp), times the mean nsteps (tens): about 1 GFLOP a
// call, some 15 us at the 67 TFLOP/s f32 rate. The steps of one chain are a
// serial chain of dependent operations, and 131072 threads are only ~1000
// per SM, so at this size the kernel is bound by launch and latency, not by
// bytes or operations. Making it fast is later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared -Xcompiler -fPIC (see ptmcmcsampler_torch/ops/build.py). No fast
// math: expf and log1pf are the accurate versions. --fmad=false keeps each
// multiply and add rounded on its own, in the order the plain PyTorch version
// (ops/chees.py) evaluates them: trajectories on the stiff flank of the
// banana are chaotic, and a one-ulp difference from a contracted FMA grows to
// order one within tens of steps.

#include <cuda_runtime.h>

#include "models.cuh"

namespace {

using ptmc::whitened_value_grad;

template <class Model>
__global__ void __launch_bounds__(256)
chees_trajectory_kernel(const float* __restrict__ q0, const float* __restrict__ p0,
                        const float* __restrict__ beta, const float* __restrict__ eps,
                        const int* __restrict__ nsteps, const float* __restrict__ chol_in,
                        float* __restrict__ q1, float* __restrict__ p1,
                        float* __restrict__ logp1, int T, int C) {
  constexpr int D = Model::D;
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= (long long)T * C) return;
  const int t = (int)(n / C);
  const int c = (int)(n % C);
  const long long base = (long long)t * D * C + c;

  float chol[D][D];
  ptmc::load_chol<D>(chol_in, chol);

  float q[D], p[D], g[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = q0[base + (long long)d * C];
    p[d] = p0[base + (long long)d * C];
  }
  const float b = __ldg(beta + t);
  const float e = eps[n];
  const float he = 0.5f * e;
  const int ns = nsteps[n];

  float logp = whitened_value_grad<Model>(chol, q, b, g);
  for (int i = 0; i < ns; ++i) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      p[d] = p[d] + he * g[d];
      q[d] = q[d] + e * p[d];
    }
    logp = whitened_value_grad<Model>(chol, q, b, g);
#pragma unroll
    for (int d = 0; d < D; ++d) p[d] = p[d] + he * g[d];
  }

#pragma unroll
  for (int d = 0; d < D; ++d) {
    q1[base + (long long)d * C] = q[d];
    p1[base + (long long)d * C] = p[d];
  }
  logp1[n] = isnan(logp) ? -INFINITY : logp;
}

template <class Model>
int launch(const float* q0, const float* p0, const float* beta, const float* eps,
           const int* nsteps, const float* chol, float* q1, float* p1, float* logp1,
           int T, int C, void* stream) {
  const long long n = (long long)T * C;
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  chees_trajectory_kernel<Model><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      q0, p0, beta, eps, nsteps, chol, q1, p1, logp1, T, C);
  return (int)cudaGetLastError();
}

}  // namespace

// All arrays are device pointers: q0, p0, q1, p1 [T, D, C]; beta [T];
// eps, nsteps, logp1 [T, C]; chol [D, D] row-major. Launches on `stream`,
// does not synchronise and allocates nothing. Returns cudaGetLastError().
extern "C" int chees_trajectory_curved(const float* q0, const float* p0, const float* beta,
                                       const float* eps, const int* nsteps,
                                       const float* chol, float* q1, float* p1,
                                       float* logp1, int T, int C, void* stream) {
  return launch<ptmc::CurvedLikelihood>(q0, p0, beta, eps, nsteps, chol, q1, p1, logp1, T, C,
                                  stream);
}
