// The templates of the HMC trajectory kernel and the fused HMC step (the
// register layout at D = 2 and the wide layout), and the macro
// PTMC_HMC_WIDE_ENTRIES, which instantiates the wide entries for one device
// functor. Included by csrc/hmc_trajectory.cu, which describes the design and
// holds the built-in functors' entries, and by the translation units that
// ops/user.py generates for a registered functor (models.cuh WidePerChain).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "models.cuh"
#include "philox.cuh"

namespace {

using ptmc::log_hamiltonian;
using ptmc::matvec_t;
using ptmc::whitened_value_grad;

constexpr int kThreads = 256;  // threads a block, one chain a thread
constexpr uint32_t kStreamHmc = 1u;
constexpr float kTwoPi = 6.28318530717958647692f;  // 2 pi rounded to f32

// The momenta and length of chain n (the layout above).
template <int D>
__device__ __forceinline__ void draw_chain(uint2 key, uint32_t n, int nmin, uint32_t span,
                                           float (&p)[D], int& nsteps) {
  constexpr int kPairs = (D + 1) / 2;
  constexpr int kCalls = (2 * kPairs + 4) / 4;  // ceil((2 * kPairs + 1) / 4)
  uint32_t w[4 * kCalls];
#pragma unroll
  for (int j = 0; j < kCalls; ++j) {
    const uint4 r = ptmc::philox4x32_10(make_uint4((uint32_t)j, n, kStreamHmc, 0u), key);
    w[4 * j] = r.x;
    w[4 * j + 1] = r.y;
    w[4 * j + 2] = r.z;
    w[4 * j + 3] = r.w;
  }
#pragma unroll
  for (int m = 0; m < kPairs; ++m) {
    const float u1 = (float)((w[2 * m] >> 8) + 1u) * 5.9604644775390625e-08f;  // 2**-24
    const float u2 = ptmc::uniform24(w[2 * m + 1]);
    const float r = sqrtf(-2.0f * logf(u1));
    const float th = kTwoPi * u2;
    p[2 * m] = r * cosf(th);
    if (2 * m + 1 < D) p[2 * m + 1] = r * sinf(th);
  }
  nsteps = nmin + (int)__umulhi(w[2 * kPairs], span);
}

struct Params {
  // Trajectory entry: q = q0 (whitened start), p0, nsteps. Step entry: q = x,
  // key, chol_inv, nmin, nmax.
  const float* q;
  const float* p0;
  const int* nsteps;
  const long long* key;
  const float* beta;
  const float* chol;
  const float* chol_inv;
  float eps;
  int nmin;
  int nmax;
  // Trajectory entry: q1. Step entry: x1 = chol^T q1. Both: qxy.
  float* out;
  float* qxy;
  int T;
  int C;
  // Step entry: the counter word of local chain t*C + c is n_base +
  // t*c_total + c, its index in the unsharded batch (0 and C unsharded).
  long long n_base;
  int c_total;
};

template <class Model, bool kStep>
__global__ void __launch_bounds__(kThreads) hmc_kernel(const Params P) {
  constexpr int D = Model::D;
  const int t = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= P.C) return;
  const long long row = (long long)t * D * P.C + c;  // element (t, 0, c)
  const long long n = (long long)t * P.C + c;        // the chain

  float chol[D][D];
  ptmc::load_chol<D>(P.chol, chol);
  const float b = __ldg(P.beta + t);
  const float e = P.eps;
  const float he = 0.5f * e;

  float q[D], p[D], g[D];
  int ns;
#pragma unroll
  for (int d = 0; d < D; ++d) q[d] = P.q[row + (long long)d * P.C];
  if constexpr (kStep) {
    float ci[D][D];
    ptmc::load_chol<D>(P.chol_inv, ci);
    const uint2 key = make_uint2((uint32_t)__ldg(P.key), (uint32_t)__ldg(P.key + 1));
    float x[D];
#pragma unroll
    for (int d = 0; d < D; ++d) x[d] = q[d];
    matvec_t<D>(ci, x, q);  // q0 = chol_inv^T x
    draw_chain<D>(key, (uint32_t)(P.n_base + (long long)t * P.c_total + c), P.nmin,
                  (uint32_t)(P.nmax - P.nmin), p, ns);
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) p[d] = P.p0[row + (long long)d * P.C];
    ns = P.nsteps[n];
  }

  const float logp0 = whitened_value_grad<Model>(chol, q, b, g);
  const float joint0 = log_hamiltonian<D>(logp0, p);
  float logp = logp0, joint = joint0;
  // Step i runs while i <= nsteps and no earlier step broke.
  for (int i = 1; i <= ns; ++i) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      p[d] = p[d] + he * g[d];
      q[d] = q[d] + e * p[d];
    }
    logp = whitened_value_grad<Model>(chol, q, b, g);
#pragma unroll
    for (int d = 0; d < D; ++d) p[d] = p[d] + he * g[d];
    joint = log_hamiltonian<D>(logp, p);
    if ((joint - 1000.0f) < joint0) break;  // the break test: keep this point
  }

  const float r = (joint - joint0) - (logp - logp0);
  P.qxy[n] = isnan(r) ? -INFINITY : r;
  if constexpr (kStep) {
    float z[D];
#pragma unroll
    for (int d = 0; d < D; ++d) z[d] = q[d];
    matvec_t<D>(chol, z, q);  // x1 = chol^T q1
  }
#pragma unroll
  for (int d = 0; d < D; ++d) P.out[row + (long long)d * P.C] = q[d];
}

template <int D>
__global__ void __launch_bounds__(kThreads)
hmc_draws_kernel(const long long* __restrict__ key_in, int nmin, int nmax,
                 float* __restrict__ p0, int* __restrict__ nsteps, int C, long long n_base,
                 int c_total) {
  const int t = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const uint2 key = make_uint2((uint32_t)__ldg(key_in), (uint32_t)__ldg(key_in + 1));
  const long long n = (long long)t * C + c;
  float p[D];
  int ns;
  draw_chain<D>(key, (uint32_t)(n_base + (long long)t * c_total + c), nmin,
                (uint32_t)(nmax - nmin), p, ns);
#pragma unroll
  for (int d = 0; d < D; ++d) p0[(long long)t * D * C + (long long)d * C + c] = p[d];
  nsteps[n] = ns;
}

// The grid of a launch: blockIdx.y = t, blockIdx.x over the rung's C chains.
bool grid_of(int T, int C, dim3* grid) {
  if (T > 65535) return false;
  *grid = dim3((unsigned)((C + kThreads - 1) / kThreads), (unsigned)T);
  return true;
}

template <class Model, bool kStep>
int launch(const Params& P, void* stream) {
  if (P.T <= 0 || P.C <= 0) return (int)cudaSuccess;
  dim3 grid;
  if (!grid_of(P.T, P.C, &grid)) return (int)cudaErrorInvalidValue;
  hmc_kernel<Model, kStep><<<grid, kThreads, 0, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wide layout (functors correlated_gaussian, interval_gaussian,
// hierarchical_gaussian at a runtime D <= kWideMaxD): bench.py's 40-, 50- and
// 200-D workloads. See the note at the top of the file.

constexpr int kWideMaxNB = 64;

// Philox call j of chain n (the draws' layout above, at a runtime D): the
// momenta 4j .. 4j + 3 that are < D, written to p[d * stride], and the length
// if the call holds word 2 ceil(D/2). Call j of draw_chain<D>, operation for
// operation.
__device__ __forceinline__ void draw_call(uint2 key, uint32_t n, int j, int D, int nmin,
                                          uint32_t span, float* p, long long stride,
                                          int* nsteps) {
  const uint4 r = ptmc::philox4x32_10(make_uint4((uint32_t)j, n, kStreamHmc, 0u), key);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int d = 4 * j + 2 * h;
    if (d < D) {
      const float u1 = (float)((w[2 * h] >> 8) + 1u) * 5.9604644775390625e-08f;  // 2**-24
      const float u2 = ptmc::uniform24(w[2 * h + 1]);
      const float rr = sqrtf(-2.0f * logf(u1));
      const float th = kTwoPi * u2;
      p[d * stride] = rr * cosf(th);
      if (d + 1 < D) p[(d + 1) * stride] = rr * sinf(th);
    }
  }
  const int lw = 2 * ((D + 1) / 2);
  if ((lw >> 2) == j) *nsteps = nmin + (int)__umulhi(w[lw & 3], span);
}

// Philox calls a chain's draws take at dimension D.
__host__ __device__ __forceinline__ int draw_calls(int D) { return (2 * ((D + 1) / 2) + 4) / 4; }

struct WideParams {
  const float* q;         // trajectory entry: q0; step entry: x
  const float* p0;        // trajectory entry
  const int* nsteps;      // trajectory entry
  const long long* key;   // step entry
  const float* beta;
  const float* chol;
  const float* chol_inv;  // step entry
  const float* prm;       // the model's constants (model.cuda_params)
  float eps;
  int nmin;
  int nmax;
  float* out;  // trajectory entry: q1; step entry: x1 = chol^T q1
  float* qxy;
  int structure;  // ptmc::WideStructure of chol and chol_inv
  int D;
  int T;
  int C;
  long long n_base;  // step entry: the counter words, as Params'
  int c_total;
};

template <class Model, bool kStep>
__global__ void __launch_bounds__(kThreads, 2) hmc_wide_kernel(const WideParams P) {
  extern __shared__ __align__(16) float s_vec[];
  __shared__ long long s_base[kWideMaxNB];  // chain n's element (t, 0, c), -1 past T*C
  __shared__ float s_beta[kWideMaxNB];
  __shared__ float s_logp[kWideMaxNB];
  __shared__ int s_ns[kWideMaxNB];
  __shared__ int s_take[kWideMaxNB];  // lanes the step moves; the model's need

  const int D = P.D;
  const int NB = ptmc::wide_group(D);
  const int nv = D * NB;
  float* z = s_vec;    // whitened position
  float* p = z + nv;   // momentum
  float* gw = p + nv;  // whitened gradient; the model's scratch
  float* xb = gw + nv;
  float* g = xb + nv;
  float* tile = g + nv;  // [wide_stages(D, NB)][wide_stage_floats(D)]
  const long long N = (long long)P.T * P.C;
  const long long n0 = (long long)blockIdx.x * NB;
  const int tid = threadIdx.x;
  const long long n = n0 + tid;
  const bool valid = tid < NB && n < N;

  if (tid < NB) {
    s_base[tid] = valid ? (n / P.C) * D * (long long)P.C + n % P.C : -1;
    s_beta[tid] = valid ? __ldg(P.beta + n / P.C) : 0.0f;
    s_take[tid] = valid;
    s_ns[tid] = 0;
    if constexpr (!kStep) {
      if (valid) s_ns[tid] = P.nsteps[n];
    }
  }
  __syncthreads();
  auto offset = [&](int idx) -> long long {  // element idx = d*NB + c in [T, D, C]
    const int d = ptmc::wide_row(idx, NB);
    const long long base = s_base[idx - d * NB];
    return base < 0 ? -1 : base + (long long)d * P.C;
  };
  for (int idx = tid; idx < nv; idx += kThreads) {
    const long long o = offset(idx);
    (kStep ? xb : z)[idx] = o < 0 ? 0.0f : P.q[o];
    p[idx] = (kStep || o < 0) ? 0.0f : P.p0[o];
  }
  __syncthreads();
  if constexpr (kStep) {
    // q0 = chol_inv^T x
    ptmc::wide_matvec<false>(P.chol_inv, xb, z, D, NB, tile, 0, P.structure);
    const uint2 key = make_uint2((uint32_t)__ldg(P.key), (uint32_t)__ldg(P.key + 1));
    const uint32_t span = (uint32_t)(P.nmax - P.nmin);
    for (int item = tid; item < draw_calls(D) * NB; item += kThreads) {
      const int c = item & (NB - 1);
      const long long m = n0 + c;
      if (m < N)
        draw_call(key, (uint32_t)(P.n_base + (m / P.C) * P.c_total + m % P.C), item / NB, D,
                  P.nmin, span, p + c, NB, s_ns + c);
    }
    __syncthreads();
  }

  const ptmc::Wide w{D, NB, 0, P.prm, xb, g, gw, tile, s_beta, s_take, s_logp};
  ptmc::wide_evaluate<Model>(P.chol, z, gw, w, P.structure);
  const float e = P.eps;
  const float he = 0.5f * e;
  float logp0 = 0.0f, joint0 = 0.0f, logp = 0.0f, joint = 0.0f;
  bool alive = valid;
  if (valid) {
    logp0 = logp = s_logp[tid];
    joint0 = joint = ptmc::wide_log_hamiltonian(logp0, p, tid, D, NB);
  }
  // Step i runs for the lanes still alive with i < nsteps; the group while
  // any lane does.
  for (int i = 0;; ++i) {
    const bool take = alive && i < s_ns[tid];  // alive only for tid < NB
    if (tid < NB) s_take[tid] = take;
    if (!__syncthreads_or(take)) break;
    for (int idx = tid; idx < nv; idx += kThreads) {
      const int c = idx & (NB - 1);
      if (s_take[c]) {
        const float ph = p[idx] + he * gw[idx];
        p[idx] = ph;
        z[idx] = z[idx] + e * ph;
      }
    }
    __syncthreads();
    ptmc::wide_evaluate<Model>(P.chol, z, gw, w, P.structure);
    for (int idx = tid; idx < nv; idx += kThreads) {
      if (s_take[idx & (NB - 1)]) p[idx] = p[idx] + he * gw[idx];
    }
    __syncthreads();
    if (take) {
      logp = s_logp[tid];
      joint = ptmc::wide_log_hamiltonian(logp, p, tid, D, NB);
      if ((joint - 1000.0f) < joint0) alive = false;  // the break test: keep this point
    }
  }

  if (valid) {
    const float r = (joint - joint0) - (logp - logp0);
    P.qxy[n] = isnan(r) ? -INFINITY : r;
  }
  // z is unchanged since the last evaluation, so xb = chol^T q1 already.
  for (int idx = tid; idx < nv; idx += kThreads) {
    const long long o = offset(idx);
    if (o >= 0) P.out[o] = kStep ? xb[idx] : z[idx];
  }
}

// One chain a thread: the draws of hmc_wide_kernel<Model, true>, written to
// p0 [T, D, C] and nsteps [T, C].
__global__ void __launch_bounds__(kThreads)
hmc_draws_wide_kernel(const long long* __restrict__ key_in, int nmin, int nmax,
                      float* __restrict__ p0, int* __restrict__ nsteps, int D, int T, int C,
                      long long n_base, int c_total) {
  const long long n = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (n >= (long long)T * C) return;
  const uint2 key = make_uint2((uint32_t)__ldg(key_in), (uint32_t)__ldg(key_in + 1));
  float* p = p0 + (n / C) * D * (long long)C + n % C;
  for (int j = 0; j < draw_calls(D); ++j)
    draw_call(key, (uint32_t)(n_base + (n / C) * c_total + n % C), j, D, nmin,
              (uint32_t)(nmax - nmin), p, C, nsteps + n);
}

template <class Model, bool kStep>
int launch_wide(const WideParams& P, void* stream) {
  if (P.D < 1 || P.D > ptmc::kWideMaxD || P.structure < ptmc::kDense ||
      P.structure > ptmc::kDiagonal)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)P.T * P.C;
  if (n <= 0) return (int)cudaSuccess;
  const int nb = ptmc::wide_group(P.D);
  const size_t smem = ptmc::wide_smem_bytes(P.D, nb);
  auto kernel = hmc_wide_kernel<Model, kStep>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)((n + nb - 1) / nb), kThreads, smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

// The wide entries, for the functors correlated_gaussian, interval_gaussian
// and hierarchical_gaussian: the arguments of the curved ones, plus prm (the
// model's constants, model.cuda_params), structure (ptmc::WideStructure of
// chol and chol_inv: 0 dense, 1 diagonal; the step and trajectory
// entries) and D (1 <= D <= 1024). The step and trajectory entries launch
// blocks of 256 threads, one group of NB = wide_group(D) chains a block,
// with ptmc::wide_smem_bytes(D, NB) of dynamic shared memory; the draws
// entry one chain a thread.
#define PTMC_HMC_WIDE_ENTRIES(NAME, MODEL)                                                    \
  extern "C" int hmc_trajectory_##NAME(const float* q0, const float* p0, const float* beta,   \
                                       const int* nsteps, const float* chol, const float* prm, \
                                       float eps, float* q1, float* qxy, int structure, int D, \
                                       int T, int C, void* stream) {                           \
    WideParams params{};                                                                       \
    params.q = q0;                                                                             \
    params.p0 = p0;                                                                            \
    params.nsteps = nsteps;                                                                    \
    params.beta = beta;                                                                        \
    params.chol = chol;                                                                        \
    params.prm = prm;                                                                          \
    params.eps = eps;                                                                          \
    params.out = q1;                                                                           \
    params.qxy = qxy;                                                                          \
    params.structure = structure;                                                              \
    params.D = D;                                                                              \
    params.T = T;                                                                              \
    params.C = C;                                                                              \
    return launch_wide<MODEL, false>(params, stream);                                          \
  }                                                                                            \
  extern "C" int hmc_step_##NAME(const float* x, const float* beta, const long long* key,      \
                                 const float* chol, const float* chol_inv, const float* prm,   \
                                 float eps, int nmin, int nmax, float* x1, float* qxy,         \
                                 int structure, int D, int T, int C, long long n_base,         \
                                 int c_total, void* stream) {                                  \
    WideParams params{};                                                                       \
    params.q = x;                                                                              \
    params.key = key;                                                                          \
    params.beta = beta;                                                                        \
    params.chol = chol;                                                                        \
    params.chol_inv = chol_inv;                                                                \
    params.prm = prm;                                                                          \
    params.eps = eps;                                                                          \
    params.nmin = nmin;                                                                        \
    params.nmax = nmax;                                                                        \
    params.out = x1;                                                                           \
    params.qxy = qxy;                                                                          \
    params.structure = structure;                                                              \
    params.D = D;                                                                              \
    params.T = T;                                                                              \
    params.C = C;                                                                              \
    params.n_base = n_base;                                                                    \
    params.c_total = c_total;                                                                  \
    return launch_wide<MODEL, true>(params, stream);                                           \
  }                                                                                            \
  extern "C" int hmc_draws_##NAME(const long long* key, int nmin, int nmax, float* p0,         \
                                  int* nsteps, int D, int T, int C, long long n_base,          \
                                  int c_total, void* stream) {                                 \
    if (D < 1 || D > ptmc::kWideMaxD) return (int)cudaErrorInvalidValue;                       \
    const long long n = (long long)T * C;                                                      \
    if (n <= 0) return (int)cudaSuccess;                                                       \
    hmc_draws_wide_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,            \
                            (cudaStream_t)stream>>>(key, nmin, nmax, p0, nsteps, D, T, C,      \
                                                    n_base, c_total);                          \
    return (int)cudaGetLastError();                                                            \
  }
