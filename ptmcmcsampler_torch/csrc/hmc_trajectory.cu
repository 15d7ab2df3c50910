// HMC trajectory kernel for Hopper (sm_90a).
//
// Replaces ptmcmcsampler_tpu/ops/hmc_pallas.py::_trajectory_kernel. For every
// chain of the [T, C] batch it runs a whitened leapfrog trajectory with the
// fixed step size eps to the chain's own length nsteps, and stops early at
// the break test (joint1 - 1000) < joint0, keeping the point it stopped at
// (nutsjump.py:285-287). It writes the end position q1 and the kinetic-energy
// correction
//
//   qxy = (joint1 - joint0) - (logp1 - logp0),  NaN -> -inf,
//
// with joint = logp - p.p/2 (NaN -> -inf), so the outer MH ratio equals the
// Hamiltonian error (see ptmcmcsampler_tpu/proposals/gradient.py make_hmc).
//
// Design. As chees_trajectory.cu: one thread per chain, 256 threads a block,
// the chain-minor [T, D, C] arrays read and written in place (element
// (t, d, c) at t*D*C + d*C + c, so neighbouring threads touch neighbouring
// addresses), D a template parameter, q, p, the gradient and chol in
// registers, the model a device functor from models.cuh. Each thread loops to
// its own nsteps and leaves the loop at its own break, where the Pallas
// kernel masks a static loop of nmax - 1 steps.
//
// The break test is the reference's, as the JAX package keeps it: it holds
// unless a step raised the joint by 1000 or more, so nearly every trajectory
// ends after its first step whatever its nsteps.
//
// What bounds it on an H100. At the path's shape (N = 8 * 16384 = 131072
// chains, D = 2) it reads q0, p0, nsteps (20 bytes a chain) and writes q1,
// qxy (12 bytes): about 4.2 MB, 1.3 us at 3.35 TB/s. A leapfrog step of the
// curved model is about 74 operations; two evaluations a chain (the start
// and the one step the break leaves) are about 20 MFLOP, 0.3 us at the
// 67 TFLOP/s f32 rate. So it is bound by bytes and by launch latency. Were
// trajectories to run their nsteps (mean about 25), each chain's steps would
// be one serial chain of dependent operations and a warp would run as long
// as its longest trajectory: latency and warp divergence would bound it.
//
// Built with --fmad=false and without fast math (ops/build.py), so it rounds
// every operation as its plain version in ops/hmc.py does.

#include <cuda_runtime.h>

#include "models.cuh"

namespace {

using ptmc::log_hamiltonian;
using ptmc::whitened_value_grad;

template <class Model>
__global__ void __launch_bounds__(256)
hmc_trajectory_kernel(const float* __restrict__ q0, const float* __restrict__ p0,
                      const float* __restrict__ beta, const int* __restrict__ nsteps,
                      const float* __restrict__ chol_in, float eps,
                      float* __restrict__ q1, float* __restrict__ qxy, int T, int C) {
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
  const float he = 0.5f * eps;
  const int ns = nsteps[n];

  const float logp0 = whitened_value_grad<Model>(chol, q, b, g);
  const float joint0 = log_hamiltonian<D>(logp0, p);
  float logp = logp0;
  float joint = joint0;
  for (int i = 0; i < ns; ++i) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      p[d] = p[d] + he * g[d];
      q[d] = q[d] + eps * p[d];
    }
    logp = whitened_value_grad<Model>(chol, q, b, g);
#pragma unroll
    for (int d = 0; d < D; ++d) p[d] = p[d] + he * g[d];
    joint = log_hamiltonian<D>(logp, p);
    if ((joint - 1000.0f) < joint0) break;  // the break test: keep this point
  }

#pragma unroll
  for (int d = 0; d < D; ++d) q1[base + (long long)d * C] = q[d];
  const float r = (joint - joint0) - (logp - logp0);
  qxy[n] = isnan(r) ? -INFINITY : r;
}

template <class Model>
int launch(const float* q0, const float* p0, const float* beta, const int* nsteps,
           const float* chol, float eps, float* q1, float* qxy, int T, int C,
           void* stream) {
  const long long n = (long long)T * C;
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  hmc_trajectory_kernel<Model><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      q0, p0, beta, nsteps, chol, eps, q1, qxy, T, C);
  return (int)cudaGetLastError();
}

}  // namespace

// All arrays are device pointers: q0, p0, q1 [T, D, C]; beta [T]; nsteps
// (int32), qxy [T, C]; chol [D, D] row-major. Launches on `stream`, does not
// synchronise and allocates nothing. Returns cudaGetLastError().
extern "C" int hmc_trajectory_curved(const float* q0, const float* p0, const float* beta,
                                     const int* nsteps, const float* chol, float eps,
                                     float* q1, float* qxy, int T, int C, void* stream) {
  return launch<ptmc::CurvedLikelihood>(q0, p0, beta, nsteps, chol, eps, q1, qxy, T, C,
                                        stream);
}
