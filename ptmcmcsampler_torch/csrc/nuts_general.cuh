// The NUTS tree kernel's general entries: the trees of nuts_tree.cu to any
// depth up to kGeneralMaxDepth = 30, with a forced trajectory length and
// the capture of lane (T0, C0)'s trajectory. Included by
// csrc/nuts_general.cu (the built-in functors' entries) and by the units
// that ops/user.py generates for a registered functor.
//
// Why a second kernel. The default entries (nuts_kernels.cuh) sit at their
// register cap: the D = 2 kernel keeps its checkpoint stack in kMaxDepth =
// 10 rows of shared memory, and an extra argument in its leaf loop can move
// its spills. So they stay as they are, in a library of their own, and the
// general entries are kernels of their own in this one, built beside it.
// Their speed is not the point: one instantiation a functor covers every D
// and depth. They compute the same function as the default entries, leaf
// for leaf and in the same operation order, so one plain version
// (ops/nuts.py nuts_trees_plain) is the twin of both.
//
// What they add:
//   * depth: the reservoir's Philox counter word 0 is the leaf's row in the
//     whole tree, 2**j - 1 + k < 2**30, and a lane's leaves are counted in
//     64 bits. The D = 2 kernel keeps its frontiers and its stack
//     (max_depth rows, one pushed at row popcount(k) <= j - 1) in local
//     memory; the wide kernel keeps them in its global scratch as before,
//     (7 + 2 max_depth) D floats a chain.
//   * a forced length L >= 0 (trajlen; -1 for none), the JAX package's
//     nuts_force_trajlen: a lane alive at doubling j has run 2**j - 1 leaves
//     before it, so the subtree stops after an odd leaf k where
//     2**j + k >= L, and the tree after the doubling where 2**(j+1) - 1 >= L,
//     in place of the U-turn tests.
//   * the capture: the thread of lane n = 0 writes its own leaves as it
//     runs them (the start on the plus branch with global index 0, each leaf
//     the next index on the branch of its direction, the index of the last
//     leaf the reservoir took in an accepted subtree), and its lengths, so
//     the recorded trajectory is the tree the sampler took.

#pragma once

#include "nuts_kernels.cuh"

namespace {

constexpr int kGeneralMaxDepth = 30;

// Lane (T0, C0)'s trajectory buffers (trajectory.py TrajCapture): plus and
// minus [2**max_depth][D] f32, their global indices [2**max_depth] int32,
// meta [4] int32 (len_plus, len_minus, used_ind, active). All null: no
// capture. The wrapper zeroes them before the launch.
struct Capture {
  float* plus;
  float* minus;
  int* ind_plus;
  int* ind_minus;
  int* meta;
};

struct GeneralParams {
  WideParams w;  // prm, scratch, structure and D unused at D = 2
  Capture cap;
  long long trajlen;  // the forced length, or -1
};

// The capture, kept by the thread of lane n = 0 (on == false elsewhere).
struct Recorder {
  Capture cap;
  bool on;
  int gind = 0, lp = 0, lm = 0, used = 0, sub_used = 0;

  // Position z (element d at z[d * stride]) as the branch's next row.
  __device__ void push(bool plus, const float* z, int stride, int D) {
    float* rows = plus ? cap.plus : cap.minus;
    int* inds = plus ? cap.ind_plus : cap.ind_minus;
    int& len = plus ? lp : lm;
    for (int d = 0; d < D; ++d) rows[(long long)len * D + d] = z[(long long)d * stride];
    inds[len] = gind;
    len += 1;
  }
  __device__ void start(const float* z0, int stride, int D) {
    if (on) push(true, z0, stride, D);
  }
  __device__ void leaf(float v, const float* z, int stride, int D) {
    if (!on) return;
    gind += 1;
    push(v > 0.0f, z, stride, D);
  }
  __device__ void take(bool taken) {
    if (on && taken) sub_used = gind;
  }
  __device__ void subtree() { sub_used = used; }
  __device__ void accept(bool accepted) {
    if (accepted) used = sub_used;
  }
  __device__ void finish() {
    if (!on) return;
    cap.meta[0] = lp;
    cap.meta[1] = lm;
    cap.meta[2] = used;
    cap.meta[3] = 1;
  }
};

// The D = 2 layout: one thread a chain, as nuts_tree_kernel, with the
// frontiers and the checkpoint stack in local memory.
template <class Model>
__global__ void __launch_bounds__(kThreads) nuts_general_kernel(const GeneralParams G) {
  constexpr int D = Model::D;
  const WideParams& P = G.w;
  const int N = P.T * P.C;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const int t = n / P.C;
  const long long base = (long long)t * D * P.C + (n - t * P.C);
  const uint32_t ctr = (uint32_t)(P.n_base + (long long)t * P.c_total + (n - t * P.C));

  float chol[D][D];
  ptmc::load_chol<D>(P.chol, chol);
  float z0[D], r0v[D], g0[D], zprop[D];
#pragma unroll
  for (int d = 0; d < D; ++d) z0[d] = P.q0[base + (long long)d * P.C];
  const float b = __ldg(P.beta + t);
  const float logp0 = whitened_value_grad<Model>(chol, z0, b, g0);
  float eps = P.eps[n];
  if (P.r_eps != nullptr && eps <= 0.0f) {
    float rs[D];
#pragma unroll
    for (int d = 0; d < D; ++d) rs[d] = P.r_eps[base + (long long)d * P.C];
    eps = find_step_size<Model>(chol, z0, g0, logp0, rs, b);
  }
  P.eps_out[n] = eps;
#pragma unroll
  for (int d = 0; d < D; ++d) r0v[d] = P.r0[base + (long long)d * P.C];
  const float joint0 = log_hamiltonian<D>(logp0, r0v);
  const float logu = joint0 - P.expo[n];
  float front[2][3][D];                     // frontiers -v, +v: (z, r, g)
  float stack[kGeneralMaxDepth][2][D];      // checkpoints (z, r)
#pragma unroll
  for (int d = 0; d < D; ++d) {
    for (int s = 0; s < 2; ++s) {
      front[s][0][d] = z0[d];
      front[s][1][d] = r0v[d];
      front[s][2][d] = g0[d];
    }
    zprop[d] = z0[d];
  }
  Recorder rec{G.cap, n == 0 && G.cap.meta != nullptr};
  rec.start(z0, 1, D);
  const uint2 kk = make_uint2((uint32_t)P.key[0], (uint32_t)P.key[1]);
  float logp_prop = logp0;
  float ntot = 1.0f, alpha = 0.0f, nalpha = 0.0f;
  bool alive = eps > 0.0f;

  for (int j = 0; j < P.max_depth && alive; ++j) {
    const float v = P.dirs[(long long)j * N + n];
    const float ve = v * eps;
    const float hve = 0.5f * ve;
    const int side = v < 0.0f ? 0 : 1;
    float z[D], r[D], g[D], zps[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      z[d] = front[side][0][d];
      r[d] = front[side][1][d];
      g[d] = front[side][2][d];
      zps[d] = z[d];
    }
    float lps = -INFINITY;
    float n_sub = 0.0f;
    bool active = true;
    int top = 0;
    const uint32_t row0 = (1u << j) - 1u;
    const int nleaves = 1 << j;
    rec.subtree();

    for (int k = 0; k < nleaves && active; ++k) {
      const float u =
          ptmc::uniform24(ptmc::philox4x32_10(make_uint4(row0 + k, ctr, 0u, 0u), kk).x);
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
      rec.leaf(v, z, 1, D);

      bool turning = false;
      if ((k & 1) == 0) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
          stack[top][0][d] = z[d];
          stack[top][1][d] = r[d];
        }
        top += 1;
      } else {
        const int kp = k + 1;
        const int t_ones = __popc((kp & -kp) - 1);
        if (G.trajlen >= 0) {
          turning = (long long)nleaves + k >= G.trajlen;
        } else {
          for (int i = top - t_ones; i < top; ++i) {
            float dzv[D], rck[D];
#pragma unroll
            for (int d = 0; d < D; ++d) {
              dzv[d] = v * (z[d] - stack[i][0][d]);
              rck[d] = stack[i][1][d];
            }
            const bool cont = dot<D>(dzv, rck) >= 0.0f && dot<D>(dzv, r) >= 0.0f;
            turning = turning || !cont;
          }
        }
        top -= t_ones - 1;
      }
      active = !diverged && !turning;

      n_sub = valid ? n_sub + 1.0f : n_sub;
      const bool take = valid & (u < 1.0f / fmaxf(n_sub, 1.0f));
#pragma unroll
      for (int d = 0; d < D; ++d) zps[d] = take ? z[d] : zps[d];
      lps = take ? logp1 : lps;
      rec.take(take);
      alpha = alpha + min1(expf(joint - joint0));
      nalpha = nalpha + 1.0f;
    }

#pragma unroll
    for (int d = 0; d < D; ++d) {
      front[side][0][d] = z[d];
      front[side][1][d] = r[d];
      front[side][2][d] = g[d];
    }
    // Progressive sample across doublings (nutsjump.py:786-791).
    const bool accept = active && P.accu[(long long)j * N + n] < n_sub / fmaxf(ntot, 1.0f);
    if (accept) {
#pragma unroll
      for (int d = 0; d < D; ++d) zprop[d] = zps[d];
      logp_prop = lps;
    }
    rec.accept(accept);
    ntot = ntot + n_sub;
    if (G.trajlen >= 0) {
      alive = active && (2LL << j) - 1 < G.trajlen;
    } else {  // whole-trajectory U-turn (nutsjump.py:465-493)
      float dz[D], rm[D], rp[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dz[d] = front[1][0][d] - front[0][0][d];
        rm[d] = front[0][1][d];
        rp[d] = front[1][1][d];
      }
      alive = active && dot<D>(dz, rm) >= 0.0f && dot<D>(dz, rp) >= 0.0f;
    }
  }

#pragma unroll
  for (int d = 0; d < D; ++d) P.q_prop[base + (long long)d * P.C] = zprop[d];
  P.logp0[n] = logp0;
  P.logp_prop[n] = logp_prop;
  P.alpha[n] = alpha;
  P.nalpha[n] = nalpha;
  P.alive[n] = alive ? 1.0f : 0.0f;
  rec.finish();
}

template <class Model>
int launch_general(const GeneralParams& G, void* stream) {
  const WideParams& P = G.w;
  const long long n = (long long)P.T * P.C;
  if (n <= 0) return (int)cudaSuccess;
  if (P.D != Model::D || P.max_depth < 1 || P.max_depth > kGeneralMaxDepth ||
      n >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  nuts_general_kernel<Model><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(G);
  return (int)cudaGetLastError();
}

// The wide layout: nuts_wide_kernel's schedule (nuts_kernels.cuh, which
// describes it) at the runtime group size and tile stages of its D > 256
// instantiation, for every D up to kWideMaxD.
template <class Model>
__global__ void __launch_bounds__(kWideThreads, 2) nuts_wide_general_kernel(const GeneralParams G) {
  const WideParams& P = G.w;
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
  const int NB = ptmc::wide_group(D);
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
  float* front = P.scratch;      // [2 sides][z, r, gw][D][N]
  float* stack = front + 6 * DN;  // [max_depth rows][z, r][D][N]
  float* zps = stack + 2 * (long long)P.max_depth * DN;  // [D][N]

  if (lane) {
    s_base[tid] = valid ? (n / P.C) * D * (long long)P.C + n % P.C : -1;
    s_beta[tid] = valid ? __ldg(P.beta + n / P.C) : 0.0f;
    s_act[tid] = valid;
  }
  __syncthreads();
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
  const ptmc::Wide w{D, NB, 0, P.prm, xb, g, gw, tile, s_beta, s_act, s_logp};

  for (int idx = tid; idx < nv; idx += kWideThreads) {
    const long long o = offset(idx);
    z[idx] = o < 0 ? 0.0f : P.q0[o];
    r[idx] = o < 0 ? 0.0f : P.r0[o];
    if (o >= 0) P.q_prop[o] = z[idx];
  }
  __syncthreads();
  ptmc::wide_evaluate<Model>(P.chol, z, gw, w, P.structure);
  Recorder rec{G.cap, n == 0 && G.cap.meta != nullptr};
  rec.start(z + tid, NB, D);
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

  // The step-size search of the lanes with eps <= 0 (nuts_wide_kernel's).
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
    auto non_finite = [&]() {
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
    const float two_a = a > 0.0f ? 2.0f : 0.5f;
    const float two_na = a > 0.0f ? 0.5f : 2.0f;
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
    int top = 0;
    const uint32_t row0 = (1u << j) - 1u;
    rec.subtree();
    for (int k = 0; k < (1 << j); ++k) {
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
        rec.leaf(v, z + tid, NB, D);
        rec.take(take);
      }
      if (lane) s_flag[tid] = take;
      __syncthreads();
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
        if (G.trajlen >= 0) {
          turning = (long long)(1 << j) + k >= G.trajlen;
        } else {
          for (int i = top - t_ones; i < top; ++i) {
            __syncthreads();  // the rows written, and the last row's reads done
            for (int idx = tid; idx < nv; idx += kWideThreads) {
              const long long s = plane(idx);
              xb[idx] = s < 0 ? 0.0f : stack[2 * i * DN + s];
              g[idx] = s < 0 ? 0.0f : stack[(2 * i + 1) * DN + s];
            }
            __syncthreads();
            if (active) {
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
        }
        top -= t_ones - 1;
      }
      active = active && !diverged && !turning;
      if (lane) s_act[tid] = active;
      if (!__syncthreads_or(active)) break;
    }

    bool accept = false;
    if (alive) {
      accept = active && P.accu[(long long)j * N + n] < n_sub / fmaxf(ntot, 1.0f);
      if (accept) lprop = lps;
    }
    rec.accept(accept);
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
    if (alive) {
      bool cont = active;
      if (G.trajlen >= 0) {
        cont = cont && (2LL << j) - 1 < G.trajlen;
      } else if (cont) {  // dz = z+ - z-: dz . r- >= 0 and dz . r+ >= 0, in order
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
  rec.finish();
}

template <class Model>
int launch_wide_general(const GeneralParams& G, void* stream) {
  const WideParams& P = G.w;
  const long long n = (long long)P.T * P.C;
  if (n <= 0) return (int)cudaSuccess;
  if (P.D < 1 || P.D > ptmc::kWideMaxD || P.max_depth < 1 || P.max_depth > kGeneralMaxDepth ||
      n >= (1LL << 31) || P.structure < ptmc::kDense || P.structure > ptmc::kDiagonal) {
    return (int)cudaErrorInvalidValue;
  }
  const int nb = ptmc::wide_group(P.D);
  const size_t smem = ptmc::wide_smem_bytes(P.D, nb);
  const cudaError_t err = cudaFuncSetAttribute(
      nuts_wide_general_kernel<Model>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  nuts_wide_general_kernel<Model>
      <<<(unsigned)((n + nb - 1) / nb), kWideThreads, smem, (cudaStream_t)stream>>>(G);
  return (int)cudaGetLastError();
}

}  // namespace

// A general entry: the arguments of the wide entries (nuts_tree_<functor>;
// prm and scratch unused, and may be null, at D = 2), the capture buffers
// (all null: no capture), and trajlen (the forced length, or -1).
#define PTMC_NUTS_GENERAL_ENTRY(NAME, MODEL, LAUNCH)                                           \
  extern "C" int nuts_general_##NAME(                                                         \
      const float* q0, const float* r0, const float* beta, const float* eps,                  \
      const float* r_eps, const float* expo, const float* dirs, const float* accu,            \
      const long long* key, const float* chol, const float* prm, float* scratch,              \
      float* q_prop, float* logp0, float* logp_prop, float* alpha, float* nalpha,             \
      float* alive, float* eps_out, float* cap_plus, float* cap_minus, int* cap_ind_plus,     \
      int* cap_ind_minus, int* cap_meta, int structure, int D, int T, int C, int max_depth,   \
      long long trajlen, long long n_base, int c_total, void* stream) {                       \
    const GeneralParams params{                                                               \
        {q0, r0, beta, eps, r_eps, expo, dirs, accu, key, chol, prm, scratch, q_prop, logp0,  \
         logp_prop, alpha, nalpha, alive, eps_out, structure, D, T, C, max_depth, n_base,     \
         c_total},                                                                            \
        {cap_plus, cap_minus, cap_ind_plus, cap_ind_minus, cap_meta},                         \
        trajlen};                                                                             \
    return LAUNCH<MODEL>(params, stream);                                                     \
  }

// The wide entry of one device functor (the units ops/user.py generates).
#define PTMC_NUTS_GENERAL_WIDE_ENTRY(NAME, MODEL) \
  PTMC_NUTS_GENERAL_ENTRY(NAME, MODEL, launch_wide_general)
