// The templates of the ChEES trajectory kernel and the fused ChEES step (the
// register layout at D = 2 and the wide layout), and the macro
// PTMC_CHEES_WIDE_ENTRIES, which instantiates the wide entries for one device
// functor. Included by csrc/chees_trajectory.cu, which describes the design
// and holds the built-in functors' entries, and by the translation units that
// ops/user.py generates for a registered functor (models.cuh WidePerChain).

#pragma once

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


// The wide entries' arguments: as Params, and the model's constants and D.
struct WideParams {
  const float* q;
  const float* p;
  const float* beta;
  const float* eps;
  const int* nsteps;
  const float* u;
  const float* tlen;
  const float* chol;
  const float* chol_inv;
  const float* prm;
  float eps0;
  int max_steps;
  float* q1;
  float* p1;
  float* logp1;
  float* x1;
  float* q0;
  float* qxy;
  float* alpha;
  int structure;  // ptmc::WideStructure of chol and chol_inv
  int D;
  int T;
  int C;
};

constexpr int kWideMaxNB = 64;
using ptmc::wide_group;

template <class Model, bool kStep>
__global__ void __launch_bounds__(kThreads, 2) chees_wide_kernel(const WideParams P) {
  extern __shared__ __align__(16) float s_vec[];
  __shared__ int s_count[kBins];
  __shared__ int s_warp[kWarps];
  __shared__ int s_perm[kThreads];
  __shared__ int s_nsteps[kThreads];
  __shared__ float s_eps[kThreads];
  __shared__ long long s_n[kWideMaxNB];     // the group's chains, -1 past T*C
  __shared__ long long s_base[kWideMaxNB];  // chain n's element (t, 0, c), -1 past T*C
  __shared__ int s_ns[kWideMaxNB];
  __shared__ float s_e[kWideMaxNB];
  __shared__ float s_beta[kWideMaxNB];
  __shared__ float s_logp[kWideMaxNB];
  __shared__ int s_need[kWideMaxNB];
  __shared__ int s_imax;

  const int D = P.D;
  const int NB = wide_group(D);
  const int nv = D * NB;
  float* q = s_vec;
  float* p = q + nv;
  float* gw = p + nv;  // the whitened gradient; the model's scratch in eval
  float* xb = gw + nv;
  float* g = xb + nv;
  float* tile = g + nv;  // [wide_stages(D, NB)][wide_stage_floats(D)]
  const long long N = (long long)P.T * P.C;
  const long long first = (long long)blockIdx.x * kThreads;
  const int tid = threadIdx.x;

  {  // the step size and length of chain first + tid, then the block's order
    const long long n = first + tid;
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
    s_nsteps[tid] = ns;
    s_eps[tid] = e;
    group_by_length(min(max(ns, 0), kBins - 1), s_count, s_warp, s_perm);
  }

  const ptmc::Wide w{D, NB, 0, P.prm, xb, g, gw, tile, s_beta, s_need, s_logp};
  const int st = P.structure;
  const bool diag = st == ptmc::kDiagonal;
  // chol(d, d), for a diagonal factor's products folded into the half steps.
  auto cdiag = [&](int idx) {
    return __ldg(P.chol + (long long)ptmc::wide_row(idx, NB) * (D + 1));
  };
  // Element idx = d*NB + c of the group's vectors lies at offset(idx) of the
  // [T, D, C] arrays, or nowhere (-1) for a lane past T*C.
  auto offset = [&](int idx) -> long long {
    const int d = ptmc::wide_row(idx, NB);
    const long long base = s_base[idx - d * NB];
    return base < 0 ? -1 : base + (long long)d * P.C;
  };

  for (int sub = 0; sub < kThreads; sub += NB) {
    if (tid == 0) s_imax = 0;
    if (tid < NB) {
      const int m = s_perm[sub + tid];
      const long long n = first + m;
      const bool valid = n < N;
      s_n[tid] = valid ? n : -1;
      s_base[tid] = valid ? (n / P.C) * D * (long long)P.C + n % P.C : -1;
      s_ns[tid] = valid ? s_nsteps[m] : 0;
      s_e[tid] = s_eps[m];
      s_beta[tid] = valid ? __ldg(P.beta + n / P.C) : 0.0f;
      s_need[tid] = kStep || !valid || s_nsteps[m] <= 0;
    }
    __syncthreads();
    if (tid < NB) atomicMax(&s_imax, s_ns[tid]);
    for (int idx = tid; idx < nv; idx += kThreads) {
      const long long o = offset(idx);
      (kStep ? xb : q)[idx] = o < 0 ? 0.0f : P.q[o];
      p[idx] = o < 0 ? 0.0f : P.p[o];
    }
    __syncthreads();
    float k0 = 0.0f;
    if constexpr (kStep) {
      ptmc::wide_matvec<false>(P.chol_inv, xb, q, D, NB, tile, 0, st);  // q0 = chol_inv^T x
      for (int idx = tid; idx < nv; idx += kThreads) {
        const long long o = offset(idx);
        if (o >= 0) P.q0[o] = q[idx];
      }
      if (tid < NB) k0 = 0.5f * ptmc::wide_rdot(p, p, tid, D, NB);  // r0.r0 / 2, in order
    }
    // Step i: the first half step and the drift (none at i = -1, the first
    // evaluation), with a diagonal factor also x = chol^T q, each thread on
    // its own elements; one barrier; the evaluation (with a diagonal factor
    // the model alone, with its own barriers); then gw = chol g (diagonal)
    // and the second half step on the same elements, which the next step's
    // first pass reads on the same thread, so no barrier ends the step.
    float logp0 = 0.0f;
    const int imax = s_imax;
    for (int i = -1; i < imax; ++i) {
      for (int idx = tid; idx < nv; idx += kThreads) {
        const int c = (idx & (NB - 1));
        float qv = q[idx];
        if (i >= 0 && i < s_ns[c]) {
          const float e = s_e[c];
          const float ph = p[idx] + (0.5f * e) * gw[idx];
          p[idx] = ph;
          qv = qv + e * ph;
          q[idx] = qv;
        }
        if (diag) xb[idx] = cdiag(idx) * qv;
      }
      if (i >= 0 && tid < NB) s_need[tid] = i == s_ns[tid] - 1;
      __syncthreads();
      if (!diag) ptmc::wide_matvec<false>(P.chol, q, xb, D, NB, tile, 0, st);  // x = chol^T q
      Model::eval(w);
      if (!diag) ptmc::wide_matvec<true>(P.chol, g, gw, D, NB, tile, 0, st);  // gw = chol g
      if (i < 0 && tid < NB) logp0 = s_logp[tid];
      for (int idx = tid; idx < nv; idx += kThreads) {
        const int c = (idx & (NB - 1));
        float gv = gw[idx];
        if (diag) {
          gv = cdiag(idx) * g[idx];
          gw[idx] = gv;
        }
        if (i >= 0 && i < s_ns[c]) p[idx] = p[idx] + (0.5f * s_e[c]) * gv;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < nv; idx += kThreads) {
      const long long o = offset(idx);
      if (o < 0) continue;
      P.q1[o] = q[idx];
      P.p1[o] = p[idx];
      if constexpr (kStep) P.x1[o] = xb[idx];  // chol^T z1, from the last evaluation
    }
    if (tid < NB && s_n[tid] >= 0) {
      const long long n = s_n[tid];
      const float logp1 = isnan(s_logp[tid]) ? -INFINITY : s_logp[tid];
      if constexpr (kStep) {
        const float k1 = 0.5f * ptmc::wide_rdot(p, p, tid, D, NB);
        float de = (logp1 - k1) - (logp0 - k0);
        de = isnan(de) ? -INFINITY : de;
        const float r = k0 - k1;
        P.qxy[n] = isnan(r) ? -INFINITY : r;
        P.alpha[n] = min1(expf(de));
      } else {
        P.logp1[n] = logp1;
      }
    }
    __syncthreads();
  }
}

template <class Model, bool kStep>
int launch_wide(const WideParams& params, void* stream) {
  if (params.D < 1 || params.D > ptmc::kWideMaxD) return (int)cudaErrorInvalidValue;
  const long long n = (long long)params.T * params.C;
  if (n <= 0) return (int)cudaSuccess;
  if (params.structure < ptmc::kDense || params.structure > ptmc::kDiagonal)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ptmc::wide_smem_bytes(params.D, wide_group(params.D));
  auto kernel = chees_wide_kernel<Model, kStep>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(params);
  return (int)cudaGetLastError();
}
}  // namespace

// The wide entries: the arguments of the curved ones, plus prm (the model's
// constants, model.cuda_params), structure (ptmc::WideStructure of chol and
// chol_inv: 0 dense, 1 diagonal) and D (1 <= D <= 1024). They launch
// 256 threads a block and ptmc::wide_smem_bytes(D, NB) of dynamic shared
// memory (NB = wide_group(D)), at most ptmc::kWideSmemLimit.
#define PTMC_CHEES_WIDE_ENTRIES(NAME, MODEL)                                                  \
  extern "C" int chees_trajectory_##NAME(                                                     \
      const float* q0, const float* p0, const float* beta, const float* eps,                  \
      const int* nsteps, const float* chol, const float* prm, float* q1, float* p1,           \
      float* logp1, int structure, int D, int T, int C, void* stream) {                       \
    WideParams params{};                                                                      \
    params.q = q0;                                                                            \
    params.p = p0;                                                                            \
    params.beta = beta;                                                                       \
    params.eps = eps;                                                                         \
    params.nsteps = nsteps;                                                                   \
    params.chol = chol;                                                                       \
    params.prm = prm;                                                                         \
    params.q1 = q1;                                                                           \
    params.p1 = p1;                                                                           \
    params.logp1 = logp1;                                                                     \
    params.structure = structure;                                                             \
    params.D = D;                                                                             \
    params.T = T;                                                                             \
    params.C = C;                                                                             \
    return launch_wide<MODEL, false>(params, stream);                                         \
  }                                                                                           \
  extern "C" int chees_step_##NAME(                                                           \
      const float* x, const float* r0, const float* u, const float* beta, const float* eps,   \
      const float* tlen, const float* chol, const float* chol_inv, const float* prm,          \
      float eps0, int max_steps, float* x1, float* q0, float* z1, float* r1, float* qxy,      \
      float* alpha, int structure, int D, int T, int C, void* stream) {                       \
    WideParams params{};                                                                      \
    params.q = x;                                                                             \
    params.p = r0;                                                                            \
    params.beta = beta;                                                                       \
    params.eps = eps;                                                                         \
    params.u = u;                                                                             \
    params.tlen = tlen;                                                                       \
    params.chol = chol;                                                                       \
    params.chol_inv = chol_inv;                                                               \
    params.prm = prm;                                                                         \
    params.eps0 = eps0;                                                                       \
    params.max_steps = max_steps;                                                             \
    params.q1 = z1;                                                                           \
    params.p1 = r1;                                                                           \
    params.x1 = x1;                                                                           \
    params.q0 = q0;                                                                           \
    params.qxy = qxy;                                                                         \
    params.alpha = alpha;                                                                     \
    params.structure = structure;                                                             \
    params.D = D;                                                                             \
    params.T = T;                                                                             \
    params.C = C;                                                                             \
    return launch_wide<MODEL, true>(params, stream);                                          \
  }
