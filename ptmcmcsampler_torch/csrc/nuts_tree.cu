// NUTS tree kernel for Hopper (sm_90a).
//
// Replaces ptmcmcsampler_tpu/ops/nuts_pallas.py::_nuts_kernel: slice-sampling
// NUTS (Hoffman & Gelman 2011, Algorithm 6; the reference's NUTSJump,
// nutsjump.py:379-840) to a depth cap of at most 10 doublings, for every
// chain of the [T, C] batch, in whitened coordinates. Per chain n = t*C + c:
//
//   if eps <= 0 and r_eps is given: eps = find_reasonable_epsilon(q0, r_eps)
//   joint0 = logp0 - r0.r0/2 (NaN -> -inf),  logu = joint0 - expo
//   for each doubling j while the tree is alive:
//     direction v = dirs[j]; from the frontier in direction v run up to 2**j
//     leapfrog leaves with step v*eps. At leaf k (row r = 2**j - 1 + k):
//       valid = logu < joint, diverged = (logu - 1000) >= joint,
//       reservoir: n_sub += valid; take the leaf if valid and
//         u < 1/max(n_sub, 1), u = uniform24(word 0 of
//         philox4x32_10(counter (r, n, 0, 0), key)), n the chain's index in
//         the unsharded batch (n_base + t*c_total + c: the arguments n_base
//         and c_total place a shard's rungs and chains; 0 and C unsharded),
//       alpha += min(1, exp(joint - joint0)), nalpha += 1,
//       checkpointed U-turn check: even leaves push (z, r) at the stack top,
//         odd leaves check v*(z - z_ck).r_ck >= 0 and v*(z - z_ck).r >= 0
//         against the trailing_ones(k) topmost checkpoints,
//       the subtree stops at divergence or a U-turn.
//     Move the frontier; accept the subtree's sample if the subtree lived and
//     accu[j] < n_sub/max(n, 1); n += n_sub; the tree lives on while the
//     subtree lived and the whole trajectory makes no U-turn.
//
// Outputs: the proposal q_prop [T, D, C], and logp0, logp_prop, alpha,
// nalpha, alive (1 where the depth cap cut the tree) and the step size each
// tree used (eps_out) [T, C]. The randomness
// comes in as arrays drawn by the caller (proposals/nuts.py) and as a
// two-word Philox key for the reservoir, so the kernel is a deterministic
// function of its inputs; ops/nuts.py (nuts_uniforms) materialises the
// uniforms it draws, bit for bit, for the plain version.
//
// Step-size search. A lane whose step size is <= 0 (a chain's first NUTS
// call, or a dual-averaged step size that underflowed to 0) first runs the
// two loops of find_reasonable_epsilon (nutsjump.py:435-463, each capped at
// 64 iterations; proposals/gradient.py) from q0 with momenta r_eps, builds
// its tree with the step size found and writes that to eps_out, as
// make_nuts_pallas searches such lanes at every call (nuts_pallas.py:497-515).
// Lanes with eps > 0 skip it. No host read decides whether to search.
//
// Design. One thread per chain, 128 threads a block, each thread building
// its own tree to its own stop (the Pallas kernel's block-wide level skip,
// lane padding and two-pass depth dispatch are TPU block devices and have no
// counterpart here). The chain-minor [T, D, C] arrays and [depth, T, C]
// draws are read in place: element (row, t, c) at row*T*C + t*C + c. D is a
// template parameter. The working point and chol live in registers; the two
// frontiers, touched once a doubling, in shared memory.
//
// What bounds it on an H100. A leaf is a leapfrog step of the curved model
// (about 74 float operations, five of them accurate expf/log1pf with range
// branches), a Philox draw (about 80 integer operations) and a U-turn check
// of a few dot products; the bytes a tree must move are its inputs and
// outputs (about 64 bytes a chain and 8 a doubling). Trees differ in size
// from chain to chain (1 to 1023 leaves); the whole 8 x 16384 batch is
// resident at once (one wave), so the kernel ends when its deepest tree ends
// and its time is that tree's chain of leaves: the latency of one thread's
// leaf, which a warp issues in order. So the design shortens each leaf's
// critical path:
//   * no device-memory load in the leaf loop: the reservoir uniform comes
//     from Philox (one call a leaf, word 0), independent of the leapfrog;
//   * the leaf decides whether the next one runs (divergence, U-turn)
//     before it does the reservoir and the acceptance statistic, which are
//     branch-free selects; with the reservoir test first, the compiler sank
//     the whole Philox chain into the `valid` branch, after the leapfrog;
//   * the top checkpoint, which every odd leaf checks, is read from shared
//     memory before the leapfrog;
//   * the checkpoint stack in shared memory, laid out
//     [kStackRows][2][D][128] with the thread index innermost so a warp's
//     accesses fall in 32 distinct banks (20 KB a block at D = 2); its top
//     follows the leaf index exactly as nuts_pallas.py:218-241: +1 after an
//     even leaf, -(trailing_ones(k) - 1) after an odd one, from __popc. At
//     level j an even leaf k pushes at row popcount(k) <= j - 1 <= 8, so
//     kStackRows = kMaxDepth leaves one row spare;
//   * __launch_bounds__(128, 8): at most 64 registers a thread, so 8 blocks
//     (1024 threads) fit an SM and the 1024 blocks of 8 x 16384 chains fit
//     the 132 SMs in one wave. To fit without spilling, the frontiers
//     (position, momentum and gradient on each side, 12 floats at D = 2)
//     live in shared memory too, [2][3][D][128] (6 KB a block): 26 KB a
//     block, 208 KB for 8 blocks of the SM's 228 KB.
//
// The wide entries, nuts_tree_<functor> for the functors correlated_gaussian,
// interval_gaussian and hierarchical_gaussian (models.cuh), build the same
// trees at any D up to kWideMaxD = 1024 (a runtime argument): bench.py's
// gaussian (40-D), hierarchical (50-D) and gaussian200 workloads. There a leaf
// is matrix work: the two whitening products (D^2 operations each for a
// triangular factor) and the model's (the correlated Gaussian's S (x - mu),
// 2 D^2), against a tree's inputs and outputs of about 8 D bytes a chain. So
// the f32 issue rate binds, and the design is the wide ChEES kernel's
// (chees_trajectory.cu): a group of NB = wide_group(D) chains (64 down to 4)
// keeps its working vectors in shared memory as [d][NB] (z, r, the whitened
// gradient, x = chol^T z and the model's gradient, 5 D NB floats, plus
// wide_matvec's three tile stages of chol: 104.8 KB a block at 200-D, two
// blocks an SM), and each product over D is a small matrix product over the
// group, summed over k in order over the terms the factor's structure keeps
// (a diagonal factor: elementwise passes, no tiles). The rest of a tree
// does not fit beside them: the two
// frontiers (z, r and gradient, 6 D a chain), the checkpoint stack (max_depth
// rows of z and r) and the subtree's proposal (D) are 27 D floats a chain at
// depth 10, 21.6 KB at 200-D, 346 KB for a group of 16, more than an SM's 228
// KB. They go to global scratch the wrapper allocates, chain-minor ([plane]
// [D][T*C]), so that a group's NB consecutive chains read and write each row
// as one contiguous segment; the group touches it once a doubling
// (frontiers), once a leaf (a push, or the trailing_ones(k) checkpoints an odd
// leaf checks) and where the reservoir takes a leaf. The tree's proposal is
// kept in the output q_prop itself.
//
// Schedule. Every lane of a group is at the same doubling j and leaf k: the
// plain version's masked loops (ops/nuts.py), so the stack top, which
// follows k alone, is the group's, and each leaf is a barrier-separated
// whole-group step in which only the lanes' masks differ: the leapfrog moves
// the active lanes, the model computes the value only for them (its need
// mask), and one thread a lane then does the slice, divergence, reservoir
// and U-turn tests, each product over D an ordered sum (models.cuh
// wide_rdot's order). A checkpoint row is read back after a barrier, so the
// group's pushes are visible to it. The group runs a doubling while any lane
// lives and a leaf while any lane of the subtree is active, so its time is
// its largest tree's: lanes of smaller trees idle (the lane efficiency the
// smoke run logs). The step-size search runs in the same masked form, in the
// groups that have a lane with eps <= 0 and r_eps given, from z0 and the
// start's gradient kept in the frontier scratch. One group a block: trees
// cannot be sorted by size before they are built, and the block scheduler
// then balances unequal groups over the SMs.
//
// Built with --fmad=false and without fast math (ops/build.py): the slice,
// U-turn, reservoir and accept decisions are discrete, and a one-ulp
// difference flips a whole tree, so the kernel keeps the plain version's
// (ops/nuts.py) operation order and rounds as it does.

// The kernel templates and the wide entries' macro live in nuts_kernels.cuh,
// which the units that ops/user.py generates for a registered user functor
// include too: their wide entries run the same kernel with WidePerChain<the
// user's functor> (models.cuh).
#include "nuts_kernels.cuh"

// All arrays are device pointers. f32: q0, r0, r_eps, q_prop [T, D, C]; beta
// [T]; eps, expo, logp0, logp_prop, alpha, nalpha, alive, eps_out [T, C];
// dirs, accu [max_depth, T, C]; chol [D, D] row-major. key: two int64 words
// in [0, 2**32). r_eps may be null: then no lane is searched and a lane with
// eps <= 0 stays put (eps_out = eps). Launches on `stream`, does not
// synchronise and allocates nothing. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a depth outside [1, 10] or 2**31 chains or more.
extern "C" int nuts_tree_curved(const float* q0, const float* r0, const float* beta,
                                const float* eps, const float* r_eps, const float* expo,
                                const float* dirs, const float* accu, const long long* key,
                                const float* chol, float* q_prop, float* logp0,
                                float* logp_prop, float* alpha, float* nalpha, float* alive,
                                float* eps_out, int T, int C, int max_depth, long long n_base,
                                int c_total, void* stream) {
  return launch<ptmc::CurvedLikelihood>(q0, r0, beta, eps, r_eps, expo, dirs, accu, key, chol,
                                        q_prop, logp0, logp_prop, alpha, nalpha, alive, eps_out,
                                        T, C, max_depth, n_base, c_total, stream);
}

PTMC_NUTS_WIDE_ENTRY(correlated_gaussian, ptmc::WideCorrelatedGaussian)
PTMC_NUTS_WIDE_ENTRY(interval_gaussian, ptmc::WideIntervalGaussian)
PTMC_NUTS_WIDE_ENTRY(hierarchical_gaussian, ptmc::WideHierarchicalGaussian)
