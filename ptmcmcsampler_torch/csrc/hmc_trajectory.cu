// HMC trajectory kernel and fused HMC step for Hopper (sm_90a).
//
// Replaces ptmcmcsampler_tpu/ops/hmc_pallas.py::_trajectory_kernel. One kernel
// template, two entries, and a third, test-only entry for the draws.
//
// hmc_trajectory_curved, the direct counterpart of _trajectory_kernel: for
// every chain of the [T, C] batch a whitened leapfrog trajectory with the
// fixed step size eps to the chain's own length nsteps, stopped early at the
// break test (joint1 - 1000) < joint0, keeping the point it stopped at
// (nutsjump.py:285-287). It writes the end position q1 and the kinetic-energy
// correction
//
//   qxy = (joint1 - joint0) - (logp1 - logp0),  NaN -> -inf,
//
// with joint = logp - p.p/2 (NaN -> -inf), so the outer MH ratio equals the
// Hamiltonian error (see ptmcmcsampler_tpu/proposals/gradient.py make_hmc).
//
// hmc_step_curved, the per-chain HMC step (proposals/gradient.py make_hmc;
// ptmcmcsampler_tpu/proposals/gradient.py:101-145 make_hmc and
// ops/hmc_pallas.py:221-255 make_hmc_pallas) folded around the same
// trajectory:
//
//   q0 = chol_inv^T x,  (p0, nsteps) = the chain's draws from the key,
//   (q1, qxy) = the trajectory,  x1 = chol^T q1
//
// It reads x and writes x1 [T, D, C] and qxy [T, C]: no momentum, length or
// whitened array exists in device memory.
//
// hmc_draws_curved writes the draws (p0 [T, D, C], nsteps [T, C]) of every
// chain from the same device function, so that a test can hold them against
// ops/hmc.py hmc_draws and count the steps a batch takes.
//
// Draws. Chain n = t*C + c takes Philox4x32-10 (philox.cuh) under the two-word
// key at counters (j, n, kStreamHmc, 0), j = 0, 1, ...; call j gives words
// w[4j] .. w[4j + 3]. Momentum pair m (dimensions 2m and 2m + 1) comes from
// words 2m and 2m + 1 by Box-Muller:
//
//   u1 = ((w[2m] >> 8) + 1) * 2^-24 in (0, 1],  u2 = (w[2m+1] >> 8) * 2^-24,
//   r = sqrtf(-2 logf(u1)),  p[2m] = r cosf(2 pi u2),  p[2m+1] = r sinf(2 pi u2)
//
// (a sine past D is dropped), with the accurate logf, sinf and cosf. The
// length takes the next word, w = w[2 ceil(D/2)], by integer arithmetic only:
// nsteps = nmin + umulhi(w, nmax - nmin), exactly on [nmin, nmax), the
// support of jax.random.randint. For D = 2 that is one Philox call a chain:
// words 0 and 1 for p, word 2 for nsteps. kStreamHmc != 0 keeps the stream
// apart from the NUTS reservoir's counters (r, n, 0, 0), even under equal
// keys.
//
// What bounds it on an H100. At the main path's shape (N = 8 * 16384 =
// 131072 chains, D = 2) the step entry moves x in and x1, qxy out: 20 bytes a
// chain, 2.6 MB, 0.78 us at 3.35 TB/s. The break test stops every trajectory
// with a finite joint0 after one step, so a chain does two model evaluations
// (about 150 operations), the whitening and back-mapping (12), the kinetic
// energies (4), one Philox call (about 80 integer operations) and Box-Muller
// and the length (about 25): 35 M operations, 0.53 us at the 67 TFLOP/s f32
// rate. So bytes bound it on paper. In practice the launch and the issue of
// a few hundred instructions a chain do: the integer and transcendental
// work runs below the f32 FMA rate the bound assumes. The design
// keeps every part of the step in the one launch and nothing but x, x1 and
// qxy in device memory:
//   * a 2-D grid, blockIdx.y = t: beta[t] is one load a block and c a plain
//     index, with no 64-bit division;
//   * one chain a thread, 256 threads a block, both entries: a warp reads
//     and writes each row of the chain-minor [T, D, C] layout (element
//     (t, d, c) at t*D*C + d*C + c) as 128 contiguous bytes. Two or four
//     neighbouring chains a thread with float2/float4 accesses were measured
//     against it on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md): two tie
//     with one in the path's case and are slower at full length, four are
//     slower in both, so the kernel keeps the simplest layout;
//   * chol and chol_inv are read by __ldg from uniform addresses: one
//     broadcast a warp;
//   * the trajectory loop stays per chain, to its own nsteps or break; a
//     chain with joint0 = -inf (a start outside the prior box) runs its
//     whole nsteps, and its warp waits on it.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared -Xcompiler -fPIC (see ptmcmcsampler_torch/ops/build.py). No fast
// math, IEEE division: the kernel rounds every operation as its plain
// versions in ops/hmc.py (the trajectory as hmc_trajectories_plain, the
// whitening and back-mapping as ordered sums), so both entries can be held
// to them lane by lane.

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
    draw_chain<D>(key, (uint32_t)n, P.nmin, (uint32_t)(P.nmax - P.nmin), p, ns);
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
                 float* __restrict__ p0, int* __restrict__ nsteps, int C) {
  const int t = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const uint2 key = make_uint2((uint32_t)__ldg(key_in), (uint32_t)__ldg(key_in + 1));
  const long long n = (long long)t * C + c;
  float p[D];
  int ns;
  draw_chain<D>(key, (uint32_t)n, nmin, (uint32_t)(nmax - nmin), p, ns);
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

}  // namespace

// All arrays are device pointers: q0, p0, q1 [T, D, C]; beta [T]; nsteps
// (int32), qxy [T, C]; chol [D, D] row-major. Launches on `stream`, does not
// synchronise and allocates nothing. Returns cudaGetLastError().
extern "C" int hmc_trajectory_curved(const float* q0, const float* p0, const float* beta,
                                     const int* nsteps, const float* chol, float eps,
                                     float* q1, float* qxy, int T, int C, void* stream) {
  Params params{};
  params.q = q0;
  params.p0 = p0;
  params.nsteps = nsteps;
  params.beta = beta;
  params.chol = chol;
  params.eps = eps;
  params.out = q1;
  params.qxy = qxy;
  params.T = T;
  params.C = C;
  return launch<ptmc::CurvedLikelihood, false>(params, stream);
}

// All arrays are device pointers: x, x1 [T, D, C]; beta [T]; qxy [T, C];
// key two int64 words (the low 32 bits of each are the Philox key); chol,
// chol_inv [D, D] row-major. Each chain draws its momenta and its length
// from [nmin, nmax) (0 <= nmin < nmax) under the key. Launches on `stream`,
// does not synchronise and allocates nothing. Returns cudaGetLastError().
extern "C" int hmc_step_curved(const float* x, const float* beta, const long long* key,
                               const float* chol, const float* chol_inv, float eps, int nmin,
                               int nmax, float* x1, float* qxy, int T, int C, void* stream) {
  Params params{};
  params.q = x;
  params.key = key;
  params.beta = beta;
  params.chol = chol;
  params.chol_inv = chol_inv;
  params.eps = eps;
  params.nmin = nmin;
  params.nmax = nmax;
  params.out = x1;
  params.qxy = qxy;
  params.T = T;
  params.C = C;
  return launch<ptmc::CurvedLikelihood, true>(params, stream);
}

// The draws hmc_step_curved makes under `key`: p0 [T, D, C] f32 and nsteps
// [T, C] int32, device pointers. A test entry. Launches on `stream`, does
// not synchronise and allocates nothing. Returns cudaGetLastError().
extern "C" int hmc_draws_curved(const long long* key, int nmin, int nmax, float* p0,
                                int* nsteps, int T, int C, void* stream) {
  if (T <= 0 || C <= 0) return (int)cudaSuccess;
  dim3 grid;
  if (!grid_of(T, C, &grid)) return (int)cudaErrorInvalidValue;
  hmc_draws_kernel<ptmc::CurvedLikelihood::D><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      key, nmin, nmax, p0, nsteps, C);
  return (int)cudaGetLastError();
}
