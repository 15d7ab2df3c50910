// HMC trajectory kernel and fused HMC step for Hopper (sm_90a).
//
// Replaces ptmcmcsampler_tpu/ops/hmc_pallas.py::_trajectory_kernel. One kernel
// template, two entries, and a third, test-only entry for the draws; for the
// wide models a second template with the same three entries (below).
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
// key at counters (j, n, kStreamHmc, 0), j = 0, 1, ..., with n its index in
// the unsharded batch: n_base + t*c_total + c for the step and draws entries'
// arguments n_base and c_total (0 and C unsharded; a shard of the rungs from
// t0 and the chains from c0 passes t0*c_total + c0 and the unsharded C); call j gives words
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
// The wide entries, hmc_trajectory_<functor>, hmc_step_<functor> and
// hmc_draws_<functor> for the functors correlated_gaussian, interval_gaussian
// and hierarchical_gaussian (models.cuh), run the same computations at any D
// up to kWideMaxD = 1024 (a runtime argument): bench.py's gaussian (40-D),
// hierarchical (50-D) and gaussian200 workloads. A chain's vectors do not fit
// in registers there and a step is matrix work (the two whitening products,
// and the correlated model's S (x - mu)), so the f32 issue rate binds, as in
// the wide ChEES kernel (chees_trajectory.cu), whose layout this is: a
// group of NB = wide_group(D) chains (64 down to 4) keeps q, p, the whitened
// gradient, x = chol^T q and the model's gradient in shared memory as
// [d][NB], each product over D a small matrix product over the group
// (models.cuh wide_matvec, chol and chol_inv streamed in 16-row tiles by
// cp.async, every output summed over k in order over the terms the factor's
// structure keeps; a diagonal factor's products are elementwise passes).
// One group a block: the break test ends
// nearly every trajectory after one step and lengths are drawn inside the
// kernel, so there is nothing to sort, and the block scheduler balances the
// groups a start outside the box makes long. The step entry draws the
// momenta straight into shared memory, one thread a (Philox call, chain),
// the call for call the curved kernel's layout at any D (draw_call: a sine
// past D is dropped). The group steps while any of its chains is alive; a
// chain past its length or its break keeps its state, and the model's value
// is computed only for the chains a step moves. The kinetic energies are
// ordered sums over D, one thread a chain (models.cuh wide_rdot). The step
// entry's x1 = chol^T q1 is the last evaluation's x: q is unchanged since.
// __launch_bounds__(256, 2): two blocks an SM (104.8 KB of shared memory a
// block at 200-D).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared -Xcompiler -fPIC (see ptmcmcsampler_torch/ops/build.py). No fast
// math, IEEE division: the kernel rounds every operation as its plain
// versions in ops/hmc.py (the trajectory as hmc_trajectories_plain, the
// whitening and back-mapping as ordered sums), so both entries can be held
// to them lane by lane.

// The kernel templates and the wide entries' macro live in hmc_kernels.cuh,
// which the units that ops/user.py generates for a registered user functor
// include too: their wide entries run the same kernel with WidePerChain<the
// user's functor> (models.cuh).
#include "hmc_kernels.cuh"

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
                               int nmax, float* x1, float* qxy, int T, int C,
                               long long n_base, int c_total, void* stream) {
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
  params.n_base = n_base;
  params.c_total = c_total;
  return launch<ptmc::CurvedLikelihood, true>(params, stream);
}

// The draws hmc_step_curved makes under `key`: p0 [T, D, C] f32 and nsteps
// [T, C] int32, device pointers. A test entry. Launches on `stream`, does
// not synchronise and allocates nothing. Returns cudaGetLastError().
extern "C" int hmc_draws_curved(const long long* key, int nmin, int nmax, float* p0,
                                int* nsteps, int T, int C, long long n_base, int c_total,
                                void* stream) {
  if (T <= 0 || C <= 0) return (int)cudaSuccess;
  dim3 grid;
  if (!grid_of(T, C, &grid)) return (int)cudaErrorInvalidValue;
  hmc_draws_kernel<ptmc::CurvedLikelihood::D><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      key, nmin, nmax, p0, nsteps, C, n_base, c_total);
  return (int)cudaGetLastError();
}

PTMC_HMC_WIDE_ENTRIES(correlated_gaussian, ptmc::WideCorrelatedGaussian)
PTMC_HMC_WIDE_ENTRIES(interval_gaussian, ptmc::WideIntervalGaussian)
PTMC_HMC_WIDE_ENTRIES(hierarchical_gaussian, ptmc::WideHierarchicalGaussian)
