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
// The wide entries, chees_trajectory_<functor> and chees_step_<functor> for
// the functors correlated_gaussian, interval_gaussian and
// hierarchical_gaussian (models.cuh), run the same two computations at any
// D up to kWideMaxD = 1024 (a runtime argument): bench.py's gaussian (40-D),
// hierarchical (50-D) and gaussian200 workloads, and hierarchies of 270 and
// 1024 dimensions. There a chain's vectors do
// not fit in registers (5 D floats: q, p, the whitened gradient, x = chol^T q
// and the model gradient; chol alone is D^2), and a step is matrix work: the
// two whitening products are 4 D^2 operations a chain, the correlated
// Gaussian's S (x - mu) 2 D^2 more, against 6 D + O(1) floats of the chain
// read and written once. So the f32 issue rate binds (--fmad=false: a
// multiply and an add are two instructions), not bytes. Layout: a block
// still takes 256 chains and orders them by length as above, then runs them
// as 256 / NB groups of NB consecutive ones in that order (NB = 64, 32,
// 16, 8 or 4 as D <= 64, 128, 256, 512 or 1024, so that the block's 256
// threads of 4 rows and 4 chains cover D; two blocks fit an SM to about
// 280-D), a group's vectors in shared memory as [d][NB]. Each
// product over D is a small matrix product over the group: thread (rb, cq)
// keeps rows 4 rb .. 4 rb + 3 (those below D) of chains 4 cq .. 4 cq + 3 in
// registers and sums over k in order, one rounding per product and per sum,
// so it rounds as the plain version's ordered sum (models.cuh wide_matvec).
// chol, its inverse and the correlated model's S stream through shared
// memory in tiles of 16 rows copied by cp.async, three stages in flight
// (two past D = 788, where three do not fit beside the vectors),
// each value shared by the group's chains; the model's other constants are
// read through L1. The factor's structure, worked out on the host where
// the factor is made (ops/common.py factor_structure), is a launch
// argument: a dense factor streams its tiles; a diagonal one (bench.py's
// paths keep the identity, mass_adapt off as in the reference) has none:
// x = chol^T q is folded into the first half step's pass and chol g into
// the second's, so a step is two elementwise passes, one barrier and the
// model's own barriers.
// A step of the group runs as long as its
// longest chain; chains past their length keep their state. The model's
// value (an ordered sum per chain, one thread a chain) is computed only
// where it is used: at the first evaluation of the step entry and at each
// chain's last step. No tensor cores: they would not round as the plain
// version. __launch_bounds__(256, 2).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared -Xcompiler -fPIC (see ptmcmcsampler_torch/ops/build.py). No fast
// math: expf and log1pf are the accurate versions. --fmad=false keeps each
// multiply and add rounded on its own, in the order the plain PyTorch
// versions (ops/chees.py) evaluate them: trajectories on the stiff flank of
// the banana are chaotic, and a one-ulp difference from a contracted FMA
// grows to order one within tens of steps.

// The kernel templates and the wide entries' macro live in chees_kernels.cuh,
// which the units that ops/user.py generates for a registered user functor
// include too: their wide entries run the same kernel with WidePerChain<the
// user's functor> (models.cuh).
#include "chees_kernels.cuh"

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

PTMC_CHEES_WIDE_ENTRIES(correlated_gaussian, ptmc::WideCorrelatedGaussian)
PTMC_CHEES_WIDE_ENTRIES(interval_gaussian, ptmc::WideIntervalGaussian)
PTMC_CHEES_WIDE_ENTRIES(hierarchical_gaussian, ptmc::WideHierarchicalGaussian)

// The wide layout at dimension D as every wide entry computes it (models.cuh),
// for holding ops/common.py's mirror to it on the card: out[0] = NB
// (wide_group), out[1] = tile stages (wide_stages), out[2] = dynamic shared
// bytes (wide_smem_bytes). A host function: it launches nothing.
extern "C" int wide_layout(int D, long long* out) {
  if (D < 1 || D > ptmc::kWideMaxD) return (int)cudaErrorInvalidValue;
  const int nb = ptmc::wide_group(D);
  out[0] = nb;
  out[1] = ptmc::wide_stages(D, nb);
  out[2] = (long long)ptmc::wide_smem_bytes(D, nb);
  return (int)cudaSuccess;
}
