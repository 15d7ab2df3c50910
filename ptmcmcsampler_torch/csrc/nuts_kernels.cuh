// The templates of the NUTS tree kernel (the register layout at D = 2 and the
// wide layout), and the macro PTMC_NUTS_WIDE_ENTRY, which instantiates the
// wide entries for one device functor. Included by csrc/nuts_tree.cu, which
// describes the design and holds the built-in functors' entries, and by the
// translation units that ops/user.py generates for a registered functor
// (models.cuh WidePerChain).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "models.cuh"
#include "philox.cuh"

namespace {

using ptmc::dot;
using ptmc::log_hamiltonian;
using ptmc::whitened_value_grad;

constexpr int kMaxDepth = 10;
constexpr int kThreads = 128;
constexpr int kBlocksPerSM = 8;
constexpr int kStackRows = kMaxDepth;
constexpr int kSearchIters = 64;

// min(1, x) propagating NaN, as jnp.minimum and torch.clamp do.
__device__ __forceinline__ float min1(float x) { return isnan(x) ? x : fminf(1.0f, x); }

// One leapfrog step of size e from (q0, r, g0) (proposals/gradient.py
// leapfrog): the momentum in r1, the gradient in g1; returns logp.
template <class Model>
__device__ __forceinline__ float leapfrog_from(const float (&chol)[Model::D][Model::D],
                                               const float (&q0)[Model::D],
                                               const float (&r)[Model::D],
                                               const float (&g0)[Model::D], float b, float e,
                                               float (&r1)[Model::D], float (&g1)[Model::D]) {
  constexpr int D = Model::D;
  const float h = 0.5f * e;
  float z[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    r1[d] = r[d] + h * g0[d];
    z[d] = q0[d] + e * r1[d];
  }
  const float logp = whitened_value_grad<Model>(chol, z, b, g1);
#pragma unroll
  for (int d = 0; d < D; ++d) r1[d] = r1[d] + h * g1[d];
  return logp;
}

template <int D>
__device__ __forceinline__ bool non_finite(float logp, const float (&g)[D]) {
  bool bad = !isfinite(logp);
#pragma unroll
  for (int d = 0; d < D; ++d) bad = bad || !isfinite(g[d]);
  return bad;
}

// find_reasonable_epsilon (proposals/gradient.py) for one chain: halve k from
// 2 while the leapfrog at k is not finite (lanes finite at 1 keep k = 1),
// then double or halve eps = k/2 while the acceptance probability stays on
// its first side of 1/2, each loop at most 64 times. The powers are those of
// the plain version: pow(ap, a) as torch.pow, 2**(+-1) exact.
template <class Model>
__device__ __forceinline__ float find_step_size(const float (&chol)[Model::D][Model::D],
                                                const float (&q0)[Model::D],
                                                const float (&g0)[Model::D], float logp0,
                                                const float (&rs)[Model::D], float b) {
  constexpr int D = Model::D;
  float r1[D], g1[D];
  const bool bad0 = non_finite<D>(leapfrog_from<Model>(chol, q0, rs, g0, b, 1.0f, r1, g1), g1);
  float k = 2.0f;
  bool bad = bad0;
  for (int i = 0; i < kSearchIters && bad; ++i) {
    k = k * 0.5f;
    bad = non_finite<D>(leapfrog_from<Model>(chol, q0, rs, g0, b, k, r1, g1), g1);
  }
  if (!bad0) k = 1.0f;

  float eps = 0.5f * k;
  const float joint0 = log_hamiltonian<D>(logp0, rs);
  auto accept_prob = [&](float e) {
    const float logp1 = leapfrog_from<Model>(chol, q0, rs, g0, b, e, r1, g1);
    const float ap = expf(log_hamiltonian<D>(logp1, r1) - joint0);
    return isnan(ap) ? 0.0f : ap;
  };
  float ap = accept_prob(eps);
  const float a = ap > 0.5f ? 1.0f : -1.0f;
  const float two_a = a > 0.0f ? 2.0f : 0.5f;   // 2**a
  const float two_na = a > 0.0f ? 0.5f : 2.0f;  // 2**-a
  bool going = powf(ap, a) > two_na;
  for (int i = 0; i < kSearchIters && going; ++i) {
    eps = eps * two_a;
    ap = accept_prob(eps);
    going = powf(ap, a) > two_na;
  }
  return fmaxf(eps, 1e-8f);
}

template <class Model>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
nuts_tree_kernel(const float* __restrict__ q0, const float* __restrict__ r0,
                 const float* __restrict__ beta, const float* __restrict__ eps_in,
                 const float* __restrict__ r_eps, const float* __restrict__ expo,
                 const float* __restrict__ dirs, const float* __restrict__ accu,
                 const long long* __restrict__ key, const float* __restrict__ chol_in,
                 float* __restrict__ q_prop, float* __restrict__ logp0_out,
                 float* __restrict__ logp_prop_out, float* __restrict__ alpha_out,
                 float* __restrict__ nalpha_out, float* __restrict__ alive_out,
                 float* __restrict__ eps_out, int T, int C, int max_depth, long long n_base,
                 int c_total) {
  constexpr int D = Model::D;
  __shared__ float stack[kStackRows][2][D][kThreads];  // checkpoints (z, r)
  __shared__ float front[2][3][D][kThreads];  // frontiers -v, +v: (z, r, g)

  const int tid = threadIdx.x;
  const int N = T * C;
  const int n = blockIdx.x * kThreads + tid;
  if (n >= N) return;
  const int t = n / C;
  const long long base = (long long)t * D * C + (n - t * C);
  // The chain's counter word: its index in the unsharded [T, C] batch.
  const uint32_t ctr = (uint32_t)(n_base + (long long)t * c_total + (n - t * C));

  float chol[D][D];
  ptmc::load_chol<D>(chol_in, chol);

  // The start (position, momentum, gradient) and the current proposal.
  float z0[D], r0v[D], g0[D], zprop[D];
#pragma unroll
  for (int d = 0; d < D; ++d) z0[d] = q0[base + (long long)d * C];
  const float b = __ldg(beta + t);
  const float logp0 = whitened_value_grad<Model>(chol, z0, b, g0);
  float eps = eps_in[n];
  if (r_eps != nullptr && eps <= 0.0f) {
    float rs[D];
#pragma unroll
    for (int d = 0; d < D; ++d) rs[d] = r_eps[base + (long long)d * C];
    eps = find_step_size<Model>(chol, z0, g0, logp0, rs, b);
  }
  eps_out[n] = eps;
#pragma unroll
  for (int d = 0; d < D; ++d) r0v[d] = r0[base + (long long)d * C];
  const float joint0 = log_hamiltonian<D>(logp0, r0v);
  const float logu = joint0 - expo[n];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    for (int s = 0; s < 2; ++s) {
      front[s][0][d][tid] = z0[d];
      front[s][1][d][tid] = r0v[d];
      front[s][2][d][tid] = g0[d];
    }
    zprop[d] = z0[d];
  }
  const uint2 kk = make_uint2((uint32_t)key[0], (uint32_t)key[1]);
  float logp_prop = logp0;
  float ntot = 1.0f;
  float alpha = 0.0f;
  float nalpha = 0.0f;
  bool alive = eps > 0.0f;

  for (int j = 0; j < max_depth && alive; ++j) {
    const float v = dirs[(long long)j * N + n];
    const bool vneg = v < 0.0f;
    const float ve = v * eps;
    const float hve = 0.5f * ve;

    // Working point = the frontier in direction v.
    const int side = vneg ? 0 : 1;
    float z[D], r[D], g[D], zps[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      z[d] = front[side][0][d][tid];
      r[d] = front[side][1][d][tid];
      g[d] = front[side][2][d][tid];
      zps[d] = z[d];
    }
    float lps = -INFINITY;
    float n_sub = 0.0f;
    bool active = true;
    int top = 0;
    const uint32_t row0 = (1u << j) - 1u;
    const int nleaves = 1 << j;

    for (int k = 0; k < nleaves && active; ++k) {
      // Neither the leaf's reservoir uniform nor the top checkpoint (which
      // an odd leaf checks first) depends on the leapfrog.
      const float u =
          ptmc::uniform24(ptmc::philox4x32_10(make_uint4(row0 + k, ctr, 0u, 0u), kk).x);
      float zc[D], rc[D];
      const int itop = top > 0 ? top - 1 : 0;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        zc[d] = stack[itop][0][d][tid];
        rc[d] = stack[itop][1][d][tid];
      }

      // Leapfrog with the signed step (nutsjump.py:149-169).
#pragma unroll
      for (int d = 0; d < D; ++d) {
        r[d] = r[d] + hve * g[d];
        z[d] = z[d] + ve * r[d];
      }
      const float logp1 = whitened_value_grad<Model>(chol, z, b, g);
#pragma unroll
      for (int d = 0; d < D; ++d) r[d] = r[d] + hve * g[d];
      const float joint = log_hamiltonian<D>(logp1, r);
      const bool valid = logu < joint;
      const bool diverged = (logu - 1000.0f) >= joint;

      // Checkpointed U-turn checks first: they decide whether the next leaf
      // runs. An odd leaf checks the trailing_ones(k) topmost checkpoints,
      // the top one prefetched.
      bool turning = false;
      if ((k & 1) == 0) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
          stack[top][0][d][tid] = z[d];
          stack[top][1][d][tid] = r[d];
        }
        top += 1;
      } else {
        const int kp = k + 1;
        const int t_ones = __popc((kp & -kp) - 1);
        float dzv[D];
#pragma unroll
        for (int d = 0; d < D; ++d) dzv[d] = v * (z[d] - zc[d]);
        turning = !(dot<D>(dzv, rc) >= 0.0f && dot<D>(dzv, r) >= 0.0f);
        for (int i = top - t_ones; i < top - 1; ++i) {
          float rck[D];
#pragma unroll
          for (int d = 0; d < D; ++d) {
            dzv[d] = v * (z[d] - stack[i][0][d][tid]);
            rck[d] = stack[i][1][d][tid];
          }
          const bool cont = dot<D>(dzv, rck) >= 0.0f && dot<D>(dzv, r) >= 0.0f;
          turning = turning || !cont;
        }
        top -= t_ones - 1;
      }
      active = !diverged && !turning;

      // Then the reservoir (uniform among the subtree's valid leaves) and
      // the acceptance statistic, branch-free, off the leaf-to-leaf chain.
      n_sub = valid ? n_sub + 1.0f : n_sub;
      const bool take = valid & (u < 1.0f / fmaxf(n_sub, 1.0f));
#pragma unroll
      for (int d = 0; d < D; ++d) zps[d] = take ? z[d] : zps[d];
      lps = take ? logp1 : lps;
      alpha = alpha + min1(expf(joint - joint0));
      nalpha = nalpha + 1.0f;
    }

    // Move the frontier in direction v.
#pragma unroll
    for (int d = 0; d < D; ++d) {
      front[side][0][d][tid] = z[d];
      front[side][1][d][tid] = r[d];
      front[side][2][d][tid] = g[d];
    }
    // Progressive sample across doublings (nutsjump.py:786-791).
    if (active && accu[(long long)j * N + n] < n_sub / fmaxf(ntot, 1.0f)) {
#pragma unroll
      for (int d = 0; d < D; ++d) zprop[d] = zps[d];
      logp_prop = lps;
    }
    ntot = ntot + n_sub;
    // Whole-trajectory U-turn (nutsjump.py:465-493).
    float dz[D], rm[D], rp[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dz[d] = front[1][0][d][tid] - front[0][0][d][tid];
      rm[d] = front[0][1][d][tid];
      rp[d] = front[1][1][d][tid];
    }
    alive = active && dot<D>(dz, rm) >= 0.0f && dot<D>(dz, rp) >= 0.0f;
  }

#pragma unroll
  for (int d = 0; d < D; ++d) q_prop[base + (long long)d * C] = zprop[d];
  logp0_out[n] = logp0;
  logp_prop_out[n] = logp_prop;
  alpha_out[n] = alpha;
  nalpha_out[n] = nalpha;
  alive_out[n] = alive ? 1.0f : 0.0f;
}

template <class Model>
int launch(const float* q0, const float* r0, const float* beta, const float* eps,
           const float* r_eps, const float* expo, const float* dirs, const float* accu,
           const long long* key, const float* chol, float* q_prop, float* logp0,
           float* logp_prop, float* alpha, float* nalpha, float* alive, float* eps_out, int T,
           int C, int max_depth, long long n_base, int c_total, void* stream) {
  const long long n = (long long)T * C;
  if (n <= 0) return (int)cudaSuccess;
  if (max_depth < 1 || max_depth > kMaxDepth || n >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  nuts_tree_kernel<Model><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      q0, r0, beta, eps, r_eps, expo, dirs, accu, key, chol, q_prop, logp0, logp_prop, alpha,
      nalpha, alive, eps_out, T, C, max_depth, n_base, c_total);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wide layout (functors correlated_gaussian, interval_gaussian,
// hierarchical_gaussian at a runtime D <= kWideMaxD). See the note at the top.

constexpr int kWideThreads = ptmc::kWideThreads;
constexpr int kWideMaxNB = 64;

struct WideParams {
  const float* q0;
  const float* r0;
  const float* beta;
  const float* eps;
  const float* r_eps;  // may be null: no lane searches
  const float* expo;
  const float* dirs;
  const float* accu;
  const long long* key;
  const float* chol;
  const float* prm;  // the model's constants (model.cuda_params)
  float* scratch;    // (7 + 2 * max_depth) * D * T * C floats (ops/nuts.py wide_scratch_floats)
  float* q_prop;
  float* logp0;
  float* logp_prop;
  float* alpha;
  float* nalpha;
  float* alive;
  float* eps_out;
  int structure;  // ptmc::WideStructure of chol
  int D;
  int T;
  int C;
  int max_depth;
  // The counter word of local chain n = t*C + c is n_base + t*c_total + c:
  // its index in the unsharded batch (n_base = t0*c_total + c0 for a shard
  // of rungs from t0 and chains from c0; 0 and C unsharded).
  long long n_base;
  int c_total;
};

// kPast256: an instantiation for D > 256 (groups of 8 or 4, wide_stages
// tile stages) and one for D <= 256 (groups of 64, 32 or 16 and three
// stages, both from constants, as before groups of 8 and 4 existed); the
// launcher picks. The kernel sits at its register cap, and the wider
// ranges of NB and of the stage count moved its spills (PERF.md).
template <class Model, bool kPast256>
__global__ void __launch_bounds__(kWideThreads, 2) nuts_wide_kernel(const WideParams P) {
  extern __shared__ __align__(16) float s_vec[];
  __shared__ long long s_base[kWideMaxNB];  // chain n's element (t, 0, c), -1 past T*C
  __shared__ float s_beta[kWideMaxNB];
  __shared__ float s_logp[kWideMaxNB];
  __shared__ float s_ve[kWideMaxNB];   // a lane's signed step, v * eps
  __shared__ float s_hve[kWideMaxNB];  // and half of it
  __shared__ int s_act[kWideMaxNB];    // lanes a step moves; the model's need
  __shared__ int s_side[kWideMaxNB];   // the frontier a doubling extends: 0 (-v) or 1 (+v)
  __shared__ int s_flag[kWideMaxNB];   // the leaf taken by the reservoir; the subtree accepted

  const int D = P.D;
  const int NB = kPast256 ? ptmc::wide_group(D) : ptmc::wide_group_to256(D);
  const int nst = kPast256 ? 0 : ptmc::kWideStages;  // wide_matvec's
  const int nv = D * NB;
  float* z = s_vec;    // whitened position
  float* r = z + nv;   // momentum
  float* gw = r + nv;  // whitened gradient; the model's scratch
  float* xb = gw + nv;  // x = chol^T z; a checkpoint's or a frontier's z
  float* g = xb + nv;   // the model's gradient; a checkpoint's or a frontier's r
  float* tile = g + nv;
  const long long N = (long long)P.T * P.C;
  const long long DN = (long long)D * N;
  const long long n0 = (long long)blockIdx.x * NB;
  const int tid = threadIdx.x;
  const bool lane = tid < NB;
  const long long n = n0 + tid;
  const bool valid = lane && n < N;
  const uint32_t ctr = (uint32_t)(P.n_base + (n / P.C) * P.c_total + n % P.C);
  // Global scratch, chain-minor: element (d, n) of a plane at plane + d*N + n.
  float* front = P.scratch;      // [2 sides][z, r, gw][D][N]
  float* stack = front + 6 * DN;  // [max_depth rows][z, r][D][N]
  float* zps = stack + 2 * (long long)P.max_depth * DN;  // [D][N]

  if (lane) {
    s_base[tid] = valid ? (n / P.C) * D * (long long)P.C + n % P.C : -1;
    s_beta[tid] = valid ? __ldg(P.beta + n / P.C) : 0.0f;
    s_act[tid] = valid;
  }
  __syncthreads();
  // Element idx = d*NB + c: its offset in the [T, D, C] arrays (-1 past T*C)
  // and in a scratch plane (-1 past T*C).
  auto offset = [&](int idx) -> long long {
    const int d = ptmc::wide_row(idx, NB);
    const long long base = s_base[idx - d * NB];
    return base < 0 ? -1 : base + (long long)d * P.C;
  };
  auto plane = [&](int idx) -> long long {
    const int d = ptmc::wide_row(idx, NB);
    const long long m = n0 + (idx - d * NB);
    return m < N ? d * N + m : -1;
  };
  const ptmc::Wide w{D, NB, nst, P.prm, xb, g, gw, tile, s_beta, s_act, s_logp};

  // The start: q_prop = z0; both frontiers = (z0, r0, gw0).
  for (int idx = tid; idx < nv; idx += kWideThreads) {
    const long long o = offset(idx);
    z[idx] = o < 0 ? 0.0f : P.q0[o];
    r[idx] = o < 0 ? 0.0f : P.r0[o];
    if (o >= 0) P.q_prop[o] = z[idx];
  }
  __syncthreads();
  ptmc::wide_evaluate<Model>(P.chol, z, gw, w, P.structure);
  float eps = 0.0f, logp0 = 0.0f, joint0 = 0.0f, logu = 0.0f, lprop = 0.0f;
  if (valid) {
    eps = P.eps[n];
    logp0 = lprop = s_logp[tid];
    joint0 = ptmc::wide_log_hamiltonian(logp0, r, tid, D, NB);
    logu = joint0 - P.expo[n];
  }
  for (int idx = tid; idx < nv; idx += kWideThreads) {
    const long long s = plane(idx);
    if (s < 0) continue;
    for (int side = 0; side < 2; ++side) {
      front[3 * side * DN + s] = z[idx];
      front[(3 * side + 1) * DN + s] = r[idx];
      front[(3 * side + 2) * DN + s] = gw[idx];
    }
  }

  // The step-size search (find_reasonable_epsilon) of the lanes with eps <= 0,
  // in masked whole-group steps. lf() takes one leapfrog step of size s_ve[c]
  // from (z0, r_eps, gw0) for the lanes with s_act[c].
  const bool srch = P.r_eps != nullptr && valid && eps <= 0.0f;
  if (P.r_eps != nullptr && __syncthreads_or(srch)) {
    auto lf = [&]() {
      for (int idx = tid; idx < nv; idx += kWideThreads) {
        const int c = idx & (NB - 1);
        if (!s_act[c]) continue;
        const long long s = plane(idx);
        const float rh = P.r_eps[offset(idx)] + s_hve[c] * front[2 * DN + s];
        r[idx] = rh;
        z[idx] = front[s] + s_ve[c] * rh;
      }
      __syncthreads();
      ptmc::wide_evaluate<Model>(P.chol, z, gw, w, P.structure);
      for (int idx = tid; idx < nv; idx += kWideThreads) {
        const int c = idx & (NB - 1);
        if (s_act[c]) r[idx] = r[idx] + s_hve[c] * gw[idx];
      }
      __syncthreads();
    };
    auto non_finite = [&]() {  // this lane's logp or whitened gradient
      bool bad = !isfinite(s_logp[tid]);
      for (int d = 0; d < D; ++d) bad = bad || !isfinite(gw[d * NB + tid]);
      return bad;
    };
    auto set_step = [&](bool act, float e) {
      if (lane) {
        s_act[tid] = act;
        s_ve[tid] = e;
        s_hve[tid] = 0.5f * e;
      }
    };
    // Halve k from 2 while the leapfrog at k is not finite; lanes finite at
    // 1 keep k = 1.
    float k = 2.0f;
    set_step(srch, 1.0f);
    __syncthreads();
    lf();
    const bool bad0 = srch && non_finite();
    bool bad = bad0;
    for (int i = 0; i < kSearchIters; ++i) {
      if (bad) k = k * 0.5f;
      set_step(bad, k);
      if (!__syncthreads_or(bad)) break;
      lf();
      if (bad) bad = non_finite();
    }
    if (!bad0) k = 1.0f;
    // Then double or halve e = k/2 while the acceptance probability stays on
    // its first side of 1/2.
    float e = 0.5f * k;
    for (int idx = tid; idx < nv; idx += kWideThreads) {
      const long long o = offset(idx);
      xb[idx] = o < 0 ? 0.0f : P.r_eps[o];
    }
    __syncthreads();
    const float js0 = srch ? ptmc::wide_log_hamiltonian(logp0, xb, tid, D, NB) : 0.0f;
    auto accept_prob = [&]() {
      const float ap = expf(ptmc::wide_log_hamiltonian(s_logp[tid], r, tid, D, NB) - js0);
      return isnan(ap) ? 0.0f : ap;
    };
    set_step(srch, e);
    __syncthreads();
    lf();
    float ap = srch ? accept_prob() : 0.0f;
    const float a = ap > 0.5f ? 1.0f : -1.0f;
    const float two_a = a > 0.0f ? 2.0f : 0.5f;   // 2**a
    const float two_na = a > 0.0f ? 0.5f : 2.0f;  // 2**-a
    bool going = srch && powf(ap, a) > two_na;
    for (int i = 0; i < kSearchIters; ++i) {
      if (going) e = e * two_a;
      set_step(going, e);
      if (!__syncthreads_or(going)) break;
      lf();
      if (going) {
        ap = accept_prob();
        going = powf(ap, a) > two_na;
      }
    }
    if (srch) eps = fmaxf(e, 1e-8f);
  }
  if (valid) P.eps_out[n] = eps;

  const uint2 kk = make_uint2((uint32_t)P.key[0], (uint32_t)P.key[1]);
  float ntot = 1.0f, alpha = 0.0f, nalpha = 0.0f;
  bool alive = valid && eps > 0.0f;
  for (int j = 0; j < P.max_depth; ++j) {
    float v = 0.0f;
    if (lane) {
      if (alive) v = P.dirs[(long long)j * N + n];
      s_act[tid] = alive;
      s_side[tid] = v < 0.0f ? 0 : 1;
      s_ve[tid] = v * eps;
      s_hve[tid] = 0.5f * (v * eps);
    }
    if (!__syncthreads_or(alive)) break;
    // The working point: the frontier in direction v.
    for (int idx = tid; idx < nv; idx += kWideThreads) {
      const long long s = plane(idx);
      if (s < 0) continue;
      const float* f = front + 3 * s_side[idx & (NB - 1)] * DN + s;
      z[idx] = f[0];
      r[idx] = f[DN];
      gw[idx] = f[2 * DN];
    }
    __syncthreads();
    float n_sub = 0.0f, lps = -INFINITY;
    bool active = alive;
    int top = 0;  // the stack top: follows k alone, as in nuts_pallas.py:218-241
    const uint32_t row0 = (1u << j) - 1u;
    for (int k = 0; k < (1 << j); ++k) {
      // Leapfrog with the signed step (nutsjump.py:149-169), the active lanes.
      for (int idx = tid; idx < nv; idx += kWideThreads) {
        const int c = idx & (NB - 1);
        if (s_act[c]) {
          const float rh = r[idx] + s_hve[c] * gw[idx];
          r[idx] = rh;
          z[idx] = z[idx] + s_ve[c] * rh;
        }
      }
      __syncthreads();
      ptmc::wide_evaluate<Model>(P.chol, z, gw, w, P.structure);
      for (int idx = tid; idx < nv; idx += kWideThreads) {
        const int c = idx & (NB - 1);
        if (s_act[c]) r[idx] = r[idx] + s_hve[c] * gw[idx];
      }
      __syncthreads();
      // The slice, divergence and reservoir tests and the acceptance
      // statistic, one thread a lane.
      bool diverged = false, take = false;
      if (active) {
        const float logp1 = s_logp[tid];
        const float joint = ptmc::wide_log_hamiltonian(logp1, r, tid, D, NB);
        const bool valid_leaf = logu < joint;
        diverged = (logu - 1000.0f) >= joint;
        const float u = ptmc::uniform24(
            ptmc::philox4x32_10(make_uint4(row0 + k, ctr, 0u, 0u), kk).x);
        n_sub = valid_leaf ? n_sub + 1.0f : n_sub;
        take = valid_leaf & (u < 1.0f / fmaxf(n_sub, 1.0f));
        lps = take ? logp1 : lps;
        alpha = alpha + min1(expf(joint - joint0));
        nalpha = nalpha + 1.0f;
      }
      if (lane) s_flag[tid] = take;
      __syncthreads();
      // Even leaves push (z, r) at the stack top (every lane: a row is read
      // only by lanes active when it was pushed); the leaves taken become the
      // subtree's proposal. Odd leaves check the trailing_ones(k) topmost
      // checkpoints, each loaded into (xb, g) for the group.
      for (int idx = tid; idx < nv; idx += kWideThreads) {
        const long long s = plane(idx);
        if (s < 0) continue;
        if ((k & 1) == 0) {
          stack[2 * top * DN + s] = z[idx];
          stack[(2 * top + 1) * DN + s] = r[idx];
        }
        if (s_flag[idx & (NB - 1)]) zps[s] = z[idx];
      }
      bool turning = false;
      if ((k & 1) == 0) {
        top += 1;
      } else {
        const int kp = k + 1;
        const int t_ones = __popc((kp & -kp) - 1);
        for (int i = top - t_ones; i < top; ++i) {
          __syncthreads();  // the rows written, and the last row's reads done
          for (int idx = tid; idx < nv; idx += kWideThreads) {
            const long long s = plane(idx);
            xb[idx] = s < 0 ? 0.0f : stack[2 * i * DN + s];
            g[idx] = s < 0 ? 0.0f : stack[(2 * i + 1) * DN + s];
          }
          __syncthreads();
          if (active) {  // v (z - z_ck) . r_ck >= 0 and v (z - z_ck) . r >= 0, in order
            float dzv = v * (z[tid] - xb[tid]);
            float a0 = dzv * g[tid], a1 = dzv * r[tid];
            for (int d = 1; d < D; ++d) {
              dzv = v * (z[d * NB + tid] - xb[d * NB + tid]);
              a0 = a0 + dzv * g[d * NB + tid];
              a1 = a1 + dzv * r[d * NB + tid];
            }
            turning = turning || !(a0 >= 0.0f && a1 >= 0.0f);
          }
        }
        top -= t_ones - 1;
      }
      active = active && !diverged && !turning;
      if (lane) s_act[tid] = active;
      if (!__syncthreads_or(active)) break;
    }

    // Move the frontier in direction v (the lanes alive at the doubling's
    // start); take the subtree's sample if it lived and accu[j] < n_sub /
    // max(ntot, 1) (nutsjump.py:786-791); load the other frontier.
    bool accept = false;
    if (alive) {
      accept = active && P.accu[(long long)j * N + n] < n_sub / fmaxf(ntot, 1.0f);
      if (accept) lprop = lps;
    }
    ntot = ntot + n_sub;
    if (lane) {
      s_flag[tid] = accept;
      s_act[tid] = alive;
    }
    __syncthreads();
    for (int idx = tid; idx < nv; idx += kWideThreads) {
      const long long s = plane(idx);
      if (s < 0) continue;
      const int c = idx & (NB - 1);
      const int side = s_side[c];
      if (s_act[c]) {
        float* f = front + 3 * side * DN + s;
        f[0] = z[idx];
        f[DN] = r[idx];
        f[2 * DN] = gw[idx];
      }
      if (s_flag[c]) P.q_prop[offset(idx)] = zps[s];
      const float* o = front + 3 * (1 - side) * DN + s;
      xb[idx] = o[0];
      g[idx] = o[DN];
    }
    __syncthreads();
    // The whole trajectory's U-turn (nutsjump.py:465-493): dz = z+ - z-,
    // dz . r- >= 0 and dz . r+ >= 0, in order. The v side is (z, r).
    if (alive) {
      bool cont = active;
      if (cont) {
        const bool plus = s_side[tid];
        const float* rm = plus ? g : r;
        const float* rp = plus ? r : g;
        float dz = plus ? z[tid] - xb[tid] : xb[tid] - z[tid];
        float a0 = dz * rm[tid], a1 = dz * rp[tid];
        for (int d = 1; d < D; ++d) {
          const int e = d * NB + tid;
          dz = plus ? z[e] - xb[e] : xb[e] - z[e];
          a0 = a0 + dz * rm[e];
          a1 = a1 + dz * rp[e];
        }
        cont = a0 >= 0.0f && a1 >= 0.0f;
      }
      alive = cont;
    }
  }

  if (valid) {
    P.logp0[n] = logp0;
    P.logp_prop[n] = lprop;
    P.alpha[n] = alpha;
    P.nalpha[n] = nalpha;
    P.alive[n] = alive ? 1.0f : 0.0f;
  }
}

template <class Model>
int launch_wide(const WideParams& P, void* stream) {
  const long long n = (long long)P.T * P.C;
  if (n <= 0) return (int)cudaSuccess;
  if (P.D < 1 || P.D > ptmc::kWideMaxD || P.max_depth < 1 || P.max_depth > kMaxDepth ||
      n >= (1LL << 31) || P.structure < ptmc::kDense || P.structure > ptmc::kDiagonal) {
    return (int)cudaErrorInvalidValue;
  }
  const int nb = ptmc::wide_group(P.D);
  const size_t smem = ptmc::wide_smem_bytes(P.D, nb);
  auto kernel = P.D > 256 ? nuts_wide_kernel<Model, true> : nuts_wide_kernel<Model, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)((n + nb - 1) / nb), kWideThreads, smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

// The wide entries, for the functors correlated_gaussian, interval_gaussian
// and hierarchical_gaussian: the arguments of nuts_tree_curved, plus prm (the
// model's constants, model.cuda_params), scratch (device memory of
// (7 + 2 * max_depth) * D * T * C floats, which the call overwrites),
// structure (ptmc::WideStructure of chol: 0 dense, 1 diagonal) and
// D (1 <= D <= 1024). They launch blocks of 256 threads, one group of NB =
// wide_group(D) chains a block, with ptmc::wide_smem_bytes(D, NB) of dynamic
// shared memory.
#define PTMC_NUTS_WIDE_ENTRY(NAME, MODEL)                                                     \
  extern "C" int nuts_tree_##NAME(                                                            \
      const float* q0, const float* r0, const float* beta, const float* eps,                  \
      const float* r_eps, const float* expo, const float* dirs, const float* accu,            \
      const long long* key, const float* chol, const float* prm, float* scratch,              \
      float* q_prop, float* logp0, float* logp_prop, float* alpha, float* nalpha,             \
      float* alive, float* eps_out, int structure, int D, int T, int C, int max_depth,        \
      long long n_base, int c_total, void* stream) {                                          \
    const WideParams params{q0, r0, beta, eps, r_eps, expo, dirs, accu, key, chol, prm,     \
                            scratch, q_prop, logp0, logp_prop, alpha, nalpha, alive, eps_out, \
                            structure, D, T, C, max_depth, n_base, c_total};                 \
    return launch_wide<MODEL>(params, stream);                                                \
  }
