// Device functors of the port's models, and the whitened value and gradient
// that every trajectory kernel (chees_trajectory.cu, hmc_trajectory.cu,
// nuts_tree.cu) evaluates at each leapfrog step.
//
// A functor gives the tempered log density and its gradient,
// (beta*ll + lp, beta*grad ll), in the operation order of the model's
// batched PyTorch version (ptmcmcsampler_torch/models/examples.py), so that a
// kernel built with --fmad=false rounds as its plain PyTorch version does.
// A model names its functor in ``cuda_functor``; the wrappers in
// ptmcmcsampler_torch/ops/ map that name to the kernel's extern "C" entry.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ptmc {

// The 2-D curved (banana) likelihood with the open box prior (-10, 10)^2.
struct CurvedLikelihood {
  static constexpr int D = 2;

  __device__ __forceinline__ static float value_grad(const float* x, float beta,
                                                     float* g) {
    const float x0 = x[0];
    const float y = x[1];
    const float xx = x0 * x0;
    const float s = 9.0f + 4.0f * xx + 9.0f * y;
    const float e0 = -xx - s * s;
    const float ym2 = y - 2.0f;
    const float e1 = -8.0f * xx - 8.0f * (ym2 * ym2);
    const float a = e0;
    const float b = -0.693147182f + e1;  // log(0.5) + e1
    const float delta = a - b;
    // Both sides computed and selected, not branched: the same result, and
    // one branch less on a leapfrog step's dependent chain (PERF.md).
    const float soft = fmaxf(a, b) + log1pf(expf(-fabsf(delta)));
    const float ll = isnan(delta) ? a + b : soft;
    const float w0 = expf(a - ll);
    const float w1 = expf(b - ll);
    const float gx = w0 * (-2.0f * x0 - 16.0f * (x0 * s)) + w1 * (-16.0f * x0);
    const float gy = w0 * (-18.0f * s) + w1 * (-16.0f * ym2);
    const bool inside = x0 > -10.0f && x0 < 10.0f && y > -10.0f && y < 10.0f;
    const float lp = inside ? 0.0f : -INFINITY;
    g[0] = beta * gx;
    g[1] = beta * gy;
    return beta * ll + lp;
  }
};

// a . b summed over k in order, one rounding per product and per sum: the
// order of the plain versions' ``rdot`` (ops/common.py).
template <int D>
__device__ __forceinline__ float dot(const float (&a)[D], const float (&b)[D]) {
  float acc = a[0] * b[0];
#pragma unroll
  for (int k = 1; k < D; ++k) acc = acc + a[k] * b[k];
  return acc;
}

// out = m^T v for m [D, D] row-major, summed over k in order with one
// rounding per product and per sum (ops/common.py matvec of m.T): the
// whitening q = chol_inv^T x and the back-mapping x = chol^T q of the fused
// steps.
template <int D>
__device__ __forceinline__ void matvec_t(const float (&m)[D][D], const float (&v)[D],
                                         float (&out)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float acc = m[0][i] * v[0];
#pragma unroll
    for (int k = 1; k < D; ++k) acc = acc + m[k][i] * v[k];
    out[i] = acc;
  }
}

// logp - p.p/2, with NaN mapped to -inf (gradient.loghamiltonian).
template <int D>
__device__ __forceinline__ float log_hamiltonian(float logp, const float (&p)[D]) {
  const float h = logp - 0.5f * dot<D>(p, p);
  return isnan(h) ? -INFINITY : h;
}

// Tempered logp and whitened gradient at whitened position q:
// x = chol^T q, (logp, g) = model(x, beta), grad_white = chol g.
template <class Model>
__device__ __forceinline__ float whitened_value_grad(const float (&chol)[Model::D][Model::D],
                                                     const float (&q)[Model::D], float beta,
                                                     float (&gw)[Model::D]) {
  constexpr int D = Model::D;
  float x[D];
  float g[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {  // x = chol^T q
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) acc += chol[k][i] * q[k];
    x[i] = acc;
  }
  const float logp = Model::value_grad(x, beta, g);
#pragma unroll
  for (int i = 0; i < D; ++i) {  // gw = chol g
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) acc += chol[i][k] * g[k];
    gw[i] = acc;
  }
  return logp;
}

// chol [D, D] row-major from device memory into registers.
template <int D>
__device__ __forceinline__ void load_chol(const float* __restrict__ chol_in,
                                          float (&chol)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int k = 0; k < D; ++k) chol[i][k] = __ldg(chol_in + i * D + k);
}

// ---------------------------------------------------------------------------
// The wide layout (D up to kWideMaxD, a runtime value), for the models whose
// vectors do not fit in registers. A block of kWideThreads threads evaluates
// NB chains at once (NB = 64, 32, 16, 8 or 4, wide_group); each per-chain
// vector lies in shared memory as [d][NB], element (d, c) at d*NB + c.

constexpr int kWideThreads = 256;
constexpr int kWideMaxD = 1024;
constexpr int kWideJ = 4;                     // rows a thread keeps per chain in wide_matvec
constexpr int kWideKT = 16;                   // rows of A a tile of wide_matvec
constexpr int kWideStages = 3;                // tiles in flight (cp.async ring), where they fit
constexpr int kWideTileStride = kWideKT + 1;  // a kRowDot tile's row stride, padded
// The dynamic shared memory a wide kernel may ask for: the H100's 227 KiB a
// block (232,448 B, static arrays included) less 8 KiB kept for the kernels'
// static arrays (at most 6,448 B, the ChEES kernel's, by ptxas).
constexpr int kWideSmemLimit = 232448 - 8192;

// The structure of a whitening factor (ops/common.py STRUCTURES), a launch
// argument of every wide entry. kDense: every term of its products;
// kDiagonal: only A(i, i), out[i] = A(i, i) * in[i]. The plain versions keep
// exactly the same terms (common.matvec).
enum WideStructure : int { kDense = 0, kDiagonal = 1 };

// Chains a group of the wide layout takes at dimension D (a power of two):
// as many as keep each thread at kWideJ rows, so that the block's
// kWideThreads / (NB / 4) row blocks of kWideJ cover D (wide_matvec): 4096 /
// NB rows, two blocks an SM up to D = 256. wide_group_to256 is its value
// at D <= 256 alone (64, 32 or 16), for a kernel instantiated for that range.
__host__ __device__ __forceinline__ int wide_group_to256(int D) {
  return D <= 64 ? 64 : (D <= 128 ? 32 : 16);
}
__host__ __device__ __forceinline__ int wide_group(int D) {
  return D <= 256 ? wide_group_to256(D) : (D <= 512 ? 8 : 4);
}

// Floats of one tile stage: kWideKT rows of D, or D rows of kWideTileStride
// (kRowDot), with D rounded up to kWideJ (the row block that ends at D reads
// its rows past D, and never writes them), rounded up to 16 bytes.
__host__ __device__ __forceinline__ int wide_stage_floats(int D) {
  return (((D + kWideJ - 1) & ~(kWideJ - 1)) * kWideTileStride + 3) & ~3;
}

// Dynamic shared memory of five [D][NB] vectors and `stages` tile stages.
__host__ __device__ __forceinline__ size_t wide_smem_bytes_at(int D, int NB, int stages) {
  return sizeof(float) * (5 * (size_t)D * NB + stages * (size_t)wide_stage_floats(D));
}

// Tile stages of wide_matvec's ring at (D, NB): kWideStages where they fit
// in kWideSmemLimit (to D = 788 at NB = 4), else two (to kWideMaxD).
__host__ __device__ __forceinline__ int wide_stages(int D, int NB) {
  return wide_smem_bytes_at(D, NB, kWideStages) <= (size_t)kWideSmemLimit ? kWideStages : 2;
}

// Dynamic shared memory of a wide kernel: five [D][NB] vectors and the tiles.
__host__ __device__ __forceinline__ size_t wide_smem_bytes(int D, int NB) {
  return wide_smem_bytes_at(D, NB, wide_stages(D, NB));
}

// The ring stage of tile t with ns = kWideStages or 2 stages: t mod ns.
__device__ __forceinline__ int wide_ring(int t, int ns) {
  return ns == kWideStages ? t % kWideStages : t & 1;
}

// Row d of element idx = d*NB + c of a group's vector (NB a power of two).
__device__ __forceinline__ int wide_row(int idx, int NB) { return idx >> (31 - __clz(NB)); }

// Hopper's asynchronous copies from global to shared memory (LDGSTS): no
// register holds the data. 16 bytes (both addresses 16-byte aligned) or 4.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Every thread of the block: start copying tile k0 (A(k, .) for k0 <= k <
// k0 + kWideKT, k < D) into buf. A(k, i) is A[k*D + i], a contiguous run of
// rows, stored as buf[kk*D + i]; with kRowDot it is A[i*D + k], stored as
// buf[i*kWideTileStride + kk] so that the rows' reads hit distinct banks.
template <bool kRowDot>
__device__ __forceinline__ void wide_issue_tile(const float* __restrict__ A, int D, int k0,
                                                float* buf) {
  const int kn = min(kWideKT, D - k0);
  const int tid = threadIdx.x;
  if (kRowDot) {
    for (int e = tid; e < D * kn; e += kWideThreads) {
      const int i = kn == kWideKT ? e >> 4 : e / kn;
      const int kk = e - i * kn;
      cp_async4(buf + i * kWideTileStride + kk, A + (long long)i * D + k0 + kk);
    }
  } else {
    const float* src = A + (long long)k0 * D;
    const int n = kn * D;
    int done = 0;
    if ((reinterpret_cast<unsigned long long>(src) & 15) == 0) {
      for (int e = tid; e < n >> 2; e += kWideThreads) cp_async16(buf + 4 * e, src + 4 * e);
      done = n & ~3;
    }
    for (int e = done + tid; e < n; e += kWideThreads) cp_async4(buf + e, src + e);
  }
}

// The products of a tile's rows for the thread's kWideJ rows and 4 chains:
// acc[j] += A(k, r0 + j) * in[k][4cq .. 4cq + 3], k = k0 + kk, where a is
// the tile at the thread's first row (A(k, r0 + j) at a[kk*D + j], or
// a[j*kWideTileStride + kk] with kRowDot) and v is in at row k0 and chain
// 4cq. A first tile's row kk = 0 starts every sum (a sum never starts as
// 0 + term: -0.0 + 0.0 is +0.0).

// All kWideKT rows, unrolled.
template <bool kRowDot, bool kFirst>
__device__ __forceinline__ void wide_tile_full(const float* a, const float* v, int D, int NB,
                                               float (&acc)[kWideJ][4]) {
#pragma unroll
  for (int kk = 0; kk < kWideKT; ++kk) {
    const float4 x = *reinterpret_cast<const float4*>(v + kk * NB);
#pragma unroll
    for (int j = 0; j < kWideJ; ++j) {
      const float e = kRowDot ? a[j * kWideTileStride + kk] : a[kk * D + j];
      if (kFirst && kk == 0) {
        acc[j][0] = e * x.x;
        acc[j][1] = e * x.y;
        acc[j][2] = e * x.z;
        acc[j][3] = e * x.w;
      } else {
        acc[j][0] = acc[j][0] + e * x.x;
        acc[j][1] = acc[j][1] + e * x.y;
        acc[j][2] = acc[j][2] + e * x.z;
        acc[j][3] = acc[j][3] + e * x.w;
      }
    }
  }
}

// The first kn < kWideKT rows: the last tile.
template <bool kRowDot>
__device__ __forceinline__ void wide_tile_run(const float* a, const float* v, int kn, bool first,
                                              int D, int NB, float (&acc)[kWideJ][4]) {
  int kb = 0;
  if (first) {
    const float4 x = *reinterpret_cast<const float4*>(v);
#pragma unroll
    for (int j = 0; j < kWideJ; ++j) {
      const float e = kRowDot ? a[j * kWideTileStride] : a[j];
      acc[j][0] = e * x.x;
      acc[j][1] = e * x.y;
      acc[j][2] = e * x.z;
      acc[j][3] = e * x.w;
    }
    kb = 1;
  }
  for (int kk = kb; kk < kn; ++kk) {
    const float4 x = *reinterpret_cast<const float4*>(v + kk * NB);
#pragma unroll
    for (int j = 0; j < kWideJ; ++j) {
      const float e = kRowDot ? a[j * kWideTileStride + kk] : a[kk * D + j];
      acc[j][0] = acc[j][0] + e * x.x;
      acc[j][1] = acc[j][1] + e * x.y;
      acc[j][2] = acc[j][2] + e * x.z;
      acc[j][3] = acc[j][3] + e * x.w;
    }
  }
}

// out[i][c] = sum_k A(k, i) * in[k][c] for i < D, c < NB, summed over k in
// order with one rounding per product and per sum (common.matvec of the
// matrix A(., i) stands for, with the factor's structure). A(k, i) is
// A[k*D + i], or A[i*D + k] with kRowDot (then out = A in, as matvec(A,
// in)). A diagonal factor is one elementwise pass, out[i] = A(i, i) in[i].
// Dense: thread tid computes rows r0 = (tid / (NB/4)) * kWideJ .. r0 +
// kWideJ - 1 (those below D; threads with r0 >= D only copy) for chains 4cq
// .. 4cq + 3, cq = tid % (NB/4). The tiles of A stream through a ring of
// ns = wide_stages(D, NB) stages by cp.async, ns - 1 ahead, one barrier a
// tile. nst is ns where the caller fixes it at compile time (so that the
// three-stage ring compiles to constants), else 0: then ns is worked out
// here, at each product, which costs the kernels at their register cap
// less than a count kept in a register (PERF.md). Every thread of the
// block calls it with in complete; it returns after a barrier, with stages
// free again.
template <bool kRowDot>
__device__ __forceinline__ void wide_matvec(const float* __restrict__ A, const float* in,
                                            float* out, int D, int NB, float* stages, int nst,
                                            int structure) {
  const int tid = threadIdx.x;
  if (structure == kDiagonal) {
    for (int idx = tid; idx < D * NB; idx += kWideThreads)
      out[idx] = __ldg(A + (long long)wide_row(idx, NB) * (D + 1)) * in[idx];
    __syncthreads();
    return;
  }
  const int nq = NB >> 2;
  const int cq = tid & (nq - 1);
  const int r0 = (tid >> (31 - __clz(nq))) * kWideJ;
  const bool rows = r0 < D;
  const float* inq = in + 4 * cq;
  const int at = kRowDot ? r0 * kWideTileStride : r0;
  const int ntiles = (D + kWideKT - 1) / kWideKT;
  const int sf = wide_stage_floats(D);
  const int ns = nst ? nst : wide_stages(D, NB);
  float acc[kWideJ][4];
#pragma unroll
  for (int j = 0; j < kWideJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

#pragma unroll
  for (int s = 0; s < kWideStages - 1; ++s) {
    if (s < ns - 1) {
      if (s < ntiles) wide_issue_tile<kRowDot>(A, D, s * kWideKT, stages + s * sf);
      cp_async_commit();
    }
  }
  for (int t = 0; t < ntiles; ++t) {
    // This thread's copies of tile t have landed: ns - 2 groups may pend.
    if (ns == kWideStages)
      cp_async_wait<kWideStages - 2>();
    else
      cp_async_wait<0>();
    __syncthreads();  // everyone's, and tile t - 1 is no longer read
    const int tn = t + ns - 1;
    if (tn < ntiles) wide_issue_tile<kRowDot>(A, D, tn * kWideKT, stages + wide_ring(tn, ns) * sf);
    cp_async_commit();
    const float* a = stages + wide_ring(t, ns) * sf + at;
    const float* v = inq + t * kWideKT * NB;
    const int kn = min(kWideKT, D - t * kWideKT);
    // No continue: every thread reaches the next barrier.
    if (!rows) {
    } else if (kn < kWideKT) {
      wide_tile_run<kRowDot>(a, v, kn, t == 0, D, NB, acc);
    } else if (t == 0) {
      wide_tile_full<kRowDot, true>(a, v, D, NB, acc);
    } else {
      wide_tile_full<kRowDot, false>(a, v, D, NB, acc);
    }
  }
#pragma unroll
  for (int j = 0; j < kWideJ; ++j) {
    if (r0 + j < D)
      *reinterpret_cast<float4*>(out + (r0 + j) * NB + 4 * cq) =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  }
  __syncthreads();
}

// sum_d a[d][c] * b[d][c] for chain c of a group's [d][NB] vectors, in order,
// one rounding per product and per sum (ops/common.py rdot). One thread a
// chain: the wide HMC and NUTS kernels' kinetic energies and U-turn checks.
__device__ __forceinline__ float wide_rdot(const float* a, const float* b, int c, int D,
                                           int NB) {
  float acc = a[c] * b[c];
  for (int d = 1; d < D; ++d) acc = acc + a[d * NB + c] * b[d * NB + c];
  return acc;
}

// logp - p.p/2 for chain c, NaN mapped to -inf (common.log_hamiltonian).
__device__ __forceinline__ float wide_log_hamiltonian(float logp, const float* p, int c, int D,
                                                      int NB) {
  const float h = logp - 0.5f * wide_rdot(p, p, c, D, NB);
  return isnan(h) ? -INFINITY : h;
}

// What a wide functor's eval reads and writes. x, g and tmp are [D][NB] in
// shared memory; beta, need and logp are [NB].
struct Wide {
  int D;
  int NB;
  int stages;                     // wide_matvec's nst: its tile stages, or 0
  const float* __restrict__ prm;  // the model's constants (model.cuda_params)
  const float* x;                 // the points, left unchanged
  float* g;                       // out: the tempered gradient
  float* tmp;                     // scratch
  float* tile;                    // the tile stages, [wide_stages(D, NB)][wide_stage_floats(D)]
  const float* beta;
  const int* need;  // chains whose tempered value eval writes to logp
  float* logp;
};

// A wide functor's eval(w): every thread of the block calls it with w.x
// complete; it writes (beta*ll + lp) to logp[c] for the chains with need[c]
// and the tempered gradient to g, in the operation order of the model's
// value_grad (models/examples.py), and returns after a barrier.

// Correlated Gaussian, prior the closed box [a, b]. prm: mu [D], a [D],
// b [D], S = icov + icov^T [D*D] (exactly symmetric, so S[k][i] = S[i][k]).
struct WideCorrelatedGaussian {
  __device__ static void eval(const Wide& w) {
    const int D = w.D, NB = w.NB;
    const float* mu = w.prm;
    const float* lo = w.prm + D;
    const float* hi = w.prm + 2 * D;
    for (int idx = threadIdx.x; idx < D * NB; idx += kWideThreads)
      w.tmp[idx] = w.x[idx] - __ldg(mu + wide_row(idx, NB));  // diff
    __syncthreads();
    wide_matvec<false>(w.prm + 3 * D, w.tmp, w.g, D, NB, w.tile, w.stages, kDense);  // sd = S diff
    const int c = threadIdx.x;
    if (c < NB && w.need[c]) {
      float acc = w.tmp[c] * w.g[c];
      bool inside = __ldg(lo) <= w.x[c] && __ldg(hi) >= w.x[c];
      for (int d = 1; d < D; ++d) {
        const float xd = w.x[d * NB + c];
        acc = acc + w.tmp[d * NB + c] * w.g[d * NB + c];
        inside = inside && __ldg(lo + d) <= xd && __ldg(hi + d) >= xd;
      }
      const float ll = -0.25f * acc;
      w.logp[c] = w.beta[c] * ll + (inside ? 0.0f : -INFINITY);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < D * NB; idx += kWideThreads)
      w.g[idx] = w.beta[(idx & (NB - 1))] * (-0.5f * w.g[idx]);
    __syncthreads();
  }
};

// Standard normal on the box (a, b) in logit coordinates p, flat prior.
// prm: a, b - a, log(b - a), D/2 log(2 pi).
struct WideIntervalGaussian {
  __device__ __forceinline__ static void terms(float p, float wd, float lo, float& s, float& x,
                                               float& e) {
    s = 1.0f / (1.0f + expf(-p));
    x = wd * s + lo;
    e = expf(p);
  }

  __device__ static void eval(const Wide& w) {
    const int D = w.D, NB = w.NB;
    const float lo = __ldg(w.prm), wd = __ldg(w.prm + 1), lw = __ldg(w.prm + 2);
    const float c0 = __ldg(w.prm + 3);
    for (int idx = threadIdx.x; idx < D * NB; idx += kWideThreads) {
      float s, x, e;
      terms(w.x[idx], wd, lo, s, x, e);
      const float gll = (-x) * wd * (s * (1.0f - s)) + (1.0f + (-2.0f * (1.0f / (e + 1.0f))) * e);
      w.g[idx] = w.beta[(idx & (NB - 1))] * gll;
    }
    const int c = threadIdx.x;
    if (c < NB && w.need[c]) {
      float sx = 0.0f, sj = 0.0f;
      for (int d = 0; d < D; ++d) {
        const float p = w.x[d * NB + c];
        float s, x, e;
        terms(p, wd, lo, s, x, e);
        const float jac = (lw + p) - 2.0f * log1pf(e);
        sx = d ? sx + x * x : x * x;
        sj = d ? sj + jac : jac;
      }
      const float ll = (-0.5f * sx - c0) + sj;
      w.logp[c] = w.beta[c] * ll;
    }
    __syncthreads();
  }
};

// The linear-Gaussian hierarchy, x = (mu, theta_1..theta_G), D = G + 1 >= 2.
// prm: 1/s_mu, 1/s_t, 1/s_y, y [G].
struct WideHierarchicalGaussian {
  __device__ static void eval(const Wide& w) {
    const int D = w.D, NB = w.NB;
    const float r_mu = __ldg(w.prm), r_t = __ldg(w.prm + 1), r_y = __ldg(w.prm + 2);
    const float* y = w.prm + 3;
    for (int idx = NB + threadIdx.x; idx < D * NB; idx += kWideThreads) {
      const int c = (idx & (NB - 1));
      const float th = w.x[idx];
      const float u = (th - w.x[c]) * r_t;
      const float wv = u * r_t;
      const float r = (__ldg(y + wide_row(idx, NB) - 1) - th) * r_y;
      w.g[idx] = w.beta[c] * (r * r_y) - wv;
      w.tmp[idx] = wv;
    }
    __syncthreads();
    const int c = threadIdx.x;
    if (c < NB) {
      const float mu = w.x[c];
      const float m = mu * r_mu;
      float acc = w.tmp[NB + c];
      for (int d = 2; d < D; ++d) acc = acc + w.tmp[d * NB + c];
      w.g[c] = -(m * r_mu) + acc;
      if (w.need[c]) {
        float sr = 0.0f, su = 0.0f;
        for (int d = 1; d < D; ++d) {
          const float th = w.x[d * NB + c];
          const float u = (th - mu) * r_t;
          const float r = (__ldg(y + d - 1) - th) * r_y;
          sr = d > 1 ? sr + r * r : r * r;
          su = d > 1 ? su + u * u : u * u;
        }
        const float ll = -0.5f * sr;
        const float lp = -0.5f * (m * m) - 0.5f * su;
        w.logp[c] = w.beta[c] * ll + lp;
      }
    }
    __syncthreads();
  }
};

// A user's device functor F (ops/user.py register_functor) as a wide
// functor. F gives one chain's tempered value and gradient:
//
//   static __device__ float value_grad(const float* x, int stride, int D,
//                                      float beta, const float* prm, float* g);
//
// reading x[d * stride] and writing g[d * stride] for d < D, and returning
// beta*ll + lp. Thread c < NB evaluates chain c of the group (x = w.x + c,
// g = w.g + c, stride NB, prm the model's constants, null where it has
// none); the block's other threads only wait at the barrier. It writes
// logp[c] where need[c], leaves w.tmp alone, and returns after the barrier
// the eval contract asks for.
template <class F>
struct WidePerChain {
  __device__ static void eval(const Wide& w) {
    const int c = threadIdx.x;
    if (c < w.NB) {
      const float v = F::value_grad(w.x + c, w.NB, w.D, w.beta[c], w.prm, w.g + c);
      if (w.need[c]) w.logp[c] = v;
    }
    __syncthreads();
  }
};

// The tempered value and whitened gradient of a group at whitened positions
// z: w.x = chol^T z, the model at w.x (gradient in w.g, w.tmp as scratch),
// gw = chol w.g, the products keeping the terms of the factor's structure
// (a diagonal factor: two elementwise passes). gw must be w.tmp: the model's
// scratch is free again once its gradient is whitened. Every thread of the
// block calls it with z complete; it returns after a barrier. The wide HMC
// and NUTS kernels' step (the ChEES kernel folds the diagonal passes into
// its half steps).
template <class Model>
__device__ __forceinline__ void wide_evaluate(const float* __restrict__ chol, const float* z,
                                              float* gw, const Wide& w, int structure) {
  wide_matvec<false>(chol, z, const_cast<float*>(w.x), w.D, w.NB, w.tile, w.stages, structure);
  Model::eval(w);
  wide_matvec<true>(chol, w.g, gw, w.D, w.NB, w.tile, w.stages, structure);
}

}  // namespace ptmc
