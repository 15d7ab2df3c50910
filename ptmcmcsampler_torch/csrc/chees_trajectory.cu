// ChEES trajectory kernel and fused ChEES step for Hopper (sm_90a).
//
// Replaces ptmcmcsampler_tpu/ops/chees_pallas.py::_chees_kernel. Two entries
// share one kernel template.
//
// chees_trajectory_curved, the direct counterpart of _chees_kernel: for
// every chain of the [T, C] batch a whitened leapfrog trajectory of the
// chain's own length nsteps, with the chain's own step size and no
// divergence break; it writes the end point (q1, p1, logp1):
//
//   x = chol^T q,  (logp, g) = model(x, beta),  grad_white = chol @ g
//   p += eps/2 grad;  q += eps p;  recompute;  p += eps/2 grad
//   logp1 = NaN ? -inf : logp
//
// chees_step_curved, the per-chain part of a ChEES step
// (proposals/chees.py core; ptmcmcsampler_tpu/proposals/chees.py:80-166,
// :235) folded around the same trajectory:
//
//   eps = eps > 0 ? eps : eps0,  tlen = max(tlen, eps)
//   nsteps = clamp(ceil(u * tlen / eps), 1, max_steps)
//   q0 = chol_inv^T x,  logp0 = the trajectory's first evaluation
//   k0 = r0.r0/2,  (z1, r1, logp1) = the trajectory,  k1 = r1.r1/2
//   denergy = (logp1 - k1) - (logp0 - k0),  qxy = k0 - k1  (NaN -> -inf)
//   alpha = min(1, exp(denergy)),  x1 = chol^T z1
//
// It writes x1, q0, z1, r1 [T, D, C] and qxy, alpha [T, C]. The per-rung
// adaptation, which needs means over the chains, stays in PyTorch.
//
// Layout. One thread per chain, 256 threads a block, the chain-minor
// [T, D, C] arrays read and written in place: element (t, d, c) at
// t*D*C + d*C + c. D is a template parameter; q, p, the gradient and chol
// live in registers. The model is a device functor from models.cuh.
//
// What bounds it on an H100. At the main path's shape (N = 8 * 16384 =
// 131072 chains, D = 2) the trajectory entry moves 44 bytes a chain (5.8 MB,
// 1.7 us at 3.35 TB/s), the step entry 68 (8.9 MB, 2.7 us). A leapfrog step
// of the curved model is about 74 operations, three of them accurate
// expf/log1pf, in one dependent chain; the path's adapted lengths give a
// mean of about 6 steps. Neither bytes nor the f32 rate bind: the issue
// slots of the SMs' warps do, and under them the latency of the longest
// chain's steps. Lengths are jittered per chain (u ~ U[1e-3, 1)), so within
// a rung nsteps is near uniform on 1..M. With chain n on thread n, a warp
// runs as long as the longest of its 32 lanes (about M) while its lanes
// need (M + 1)/2 on average: half the issued lane-slots idle.
//
// So the block groups its lanes by length before it computes. Each thread
// first reads the length of chain first + threadIdx.x (coalesced; the step
// entry computes it from u, tlen and eps), then the block orders the 256
// lengths by a counting sort in shared memory (a histogram with shared
// atomics, an exclusive scan over the bins, a scatter of chain indices),
// and thread k runs chain perm[k]. Warps then hold chains of near-equal
// length; a short warp retires early and leaves its issue slots to the long
// ones. Lanes past T*C in the last block take length 0 and do nothing.
// Lengths of kBins - 1 or more share the top bin. Which thread runs a chain
// changes nothing in what the chain computes. The step entry also keeps the
// per-chain prologue and epilogue out of device memory: one launch where the
// proposal issued about 70 small PyTorch operations around the trajectory.
// __launch_bounds__(256, 4): 512 blocks of 8 x 16384 chains fit the 132 SMs
// in one wave.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared -Xcompiler -fPIC (see ptmcmcsampler_torch/ops/build.py). No fast
// math: expf and log1pf are the accurate versions. --fmad=false keeps each
// multiply and add rounded on its own, in the order the plain PyTorch
// versions (ops/chees.py) evaluate them: trajectories on the stiff flank of
// the banana are chaotic, and a one-ulp difference from a contracted FMA
// grows to order one within tens of steps.

#include <cuda_runtime.h>

#include "models.cuh"

namespace {

using ptmc::dot;
using ptmc::matvec_t;
using ptmc::whitened_value_grad;

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 4;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = kThreads;  // one bin a thread in the scan

// min(1, x) propagating NaN, as torch.clamp(max=1) does.
__device__ __forceinline__ float min1(float x) { return isnan(x) ? x : fminf(1.0f, x); }

// The block's order of its chains by key (0 <= key < kBins): on return
// perm[k] is the block-local index of the chain that thread k runs. Every
// thread of the block calls it with the key of its own chain.
__device__ __forceinline__ void group_by_length(int key, int* count, int* warp_sum,
                                                int* perm) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  count[tid] = 0;
  __syncthreads();
  const int slot = atomicAdd(&count[key], 1);  // place within the bin
  __syncthreads();
  const int h = count[tid];  // exclusive scan of the bins, bin tid on thread tid
  int inc = h;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sum[w];
  count[tid] = before + inc - h;  // first sorted position of bin tid
  __syncthreads();
  perm[count[key] + slot] = tid;
  __syncthreads();
}

struct Params {
  // Trajectory entry: q = q0 (whitened start), nsteps. Step entry: q = x,
  // u, tlen, chol_inv, eps0, max_steps. p is p0 or r0.
  const float* q;
  const float* p;
  const float* beta;
  const float* eps;
  const int* nsteps;
  const float* u;
  const float* tlen;
  const float* chol;
  const float* chol_inv;
  float eps0;
  int max_steps;
  // Both: the end point (q1/z1, p1/r1). Trajectory entry: logp1. Step
  // entry: x1, q0, qxy, alpha.
  float* q1;
  float* p1;
  float* logp1;
  float* x1;
  float* q0;
  float* qxy;
  float* alpha;
  int T;
  int C;
};

template <class Model, bool kStep>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) chees_kernel(const Params P) {
  constexpr int D = Model::D;
  __shared__ int s_count[kBins];
  __shared__ int s_warp[kWarps];
  __shared__ int s_perm[kThreads];
  __shared__ int s_nsteps[kThreads];
  __shared__ float s_eps[kThreads];

  const long long N = (long long)P.T * P.C;
  const long long first = (long long)blockIdx.x * kThreads;

  // Each thread: the step size and length of chain first + threadIdx.x.
  {
    const long long n = first + threadIdx.x;
    int ns = 0;
    float e = 0.0f;
    if (n < N) {
      e = P.eps[n];
      if constexpr (kStep) {
        e = e > 0.0f ? e : P.eps0;
        float tl = P.tlen[n];
        tl = isnan(tl) ? tl : fmaxf(tl, e);  // torch.maximum
        const float v = ceilf(P.u[n] * tl / e);
        ns = (int)fminf(fmaxf(v, 1.0f), (float)P.max_steps);
      } else {
        ns = P.nsteps[n];
      }
    }
    s_nsteps[threadIdx.x] = ns;
    s_eps[threadIdx.x] = e;
    group_by_length(min(max(ns, 0), kBins - 1), s_count, s_warp, s_perm);
  }

  const int m = s_perm[threadIdx.x];
  const long long n = first + m;
  if (n >= N) return;
  const int t = (int)(n / P.C);
  const int c = (int)(n % P.C);
  const long long base = (long long)t * D * P.C + c;

  float chol[D][D];
  ptmc::load_chol<D>(P.chol, chol);

  float q[D], p[D], g[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = P.q[base + (long long)d * P.C];
    p[d] = P.p[base + (long long)d * P.C];
  }
  float k0 = 0.0f;
  if constexpr (kStep) {
    float ci[D][D];
    ptmc::load_chol<D>(P.chol_inv, ci);
    float x[D];
#pragma unroll
    for (int d = 0; d < D; ++d) x[d] = q[d];
    matvec_t<D>(ci, x, q);  // q0 = chol_inv^T x
#pragma unroll
    for (int d = 0; d < D; ++d) P.q0[base + (long long)d * P.C] = q[d];
    k0 = 0.5f * dot<D>(p, p);
  }
  const float b = __ldg(P.beta + t);
  const float e = s_eps[m];
  const float he = 0.5f * e;
  const int ns = s_nsteps[m];

  const float logp0 = whitened_value_grad<Model>(chol, q, b, g);
  float logp = logp0;
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
  const float logp1 = isnan(logp) ? -INFINITY : logp;

#pragma unroll
  for (int d = 0; d < D; ++d) {
    P.q1[base + (long long)d * P.C] = q[d];
    P.p1[base + (long long)d * P.C] = p[d];
  }
  if constexpr (kStep) {
    const float k1 = 0.5f * dot<D>(p, p);
    float de = (logp1 - k1) - (logp0 - k0);
    de = isnan(de) ? -INFINITY : de;
    const float r = k0 - k1;
    P.qxy[n] = isnan(r) ? -INFINITY : r;
    P.alpha[n] = min1(expf(de));
    float x1[D];
    matvec_t<D>(chol, q, x1);  // x1 = chol^T z1
#pragma unroll
    for (int d = 0; d < D; ++d) P.x1[base + (long long)d * P.C] = x1[d];
  } else {
    P.logp1[n] = logp1;
  }
}

template <class Model, bool kStep>
int launch(const Params& params, void* stream) {
  const long long n = (long long)params.T * params.C;
  if (n <= 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  chees_kernel<Model, kStep><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(params);
  return (int)cudaGetLastError();
}

}  // namespace

// All arrays are device pointers: q0, p0, q1, p1 [T, D, C]; beta [T];
// eps, nsteps (int32), logp1 [T, C]; chol [D, D] row-major. Launches on
// `stream`, does not synchronise and allocates nothing. Returns
// cudaGetLastError().
extern "C" int chees_trajectory_curved(const float* q0, const float* p0, const float* beta,
                                       const float* eps, const int* nsteps,
                                       const float* chol, float* q1, float* p1,
                                       float* logp1, int T, int C, void* stream) {
  Params params{};
  params.q = q0;
  params.p = p0;
  params.beta = beta;
  params.eps = eps;
  params.nsteps = nsteps;
  params.chol = chol;
  params.q1 = q1;
  params.p1 = p1;
  params.logp1 = logp1;
  params.T = T;
  params.C = C;
  return launch<ptmc::CurvedLikelihood, false>(params, stream);
}

// All arrays are device pointers: x, r0, x1, q0, z1, r1 [T, D, C]; beta [T];
// u, eps, tlen (the step-size state's chees_eps and chees_tlen), qxy,
// alpha [T, C]; chol, chol_inv [D, D] row-major. eps0 replaces a step size
// <= 0; max_steps caps nsteps. Launches on `stream`, does not synchronise
// and allocates nothing. Returns cudaGetLastError().
extern "C" int chees_step_curved(const float* x, const float* r0, const float* u,
                                 const float* beta, const float* eps, const float* tlen,
                                 const float* chol, const float* chol_inv, float eps0,
                                 int max_steps, float* x1, float* q0, float* z1, float* r1,
                                 float* qxy, float* alpha, int T, int C, void* stream) {
  Params params{};
  params.q = x;
  params.p = r0;
  params.beta = beta;
  params.eps = eps;
  params.u = u;
  params.tlen = tlen;
  params.chol = chol;
  params.chol_inv = chol_inv;
  params.eps0 = eps0;
  params.max_steps = max_steps;
  params.q1 = z1;
  params.p1 = r1;
  params.x1 = x1;
  params.q0 = q0;
  params.qxy = qxy;
  params.alpha = alpha;
  params.T = T;
  params.C = C;
  return launch<ptmc::CurvedLikelihood, true>(params, stream);
}
