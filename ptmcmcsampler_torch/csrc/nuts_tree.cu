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
//         philox4x32_10(counter (r, n, 0, 0), key)),
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
// Built with --fmad=false and without fast math (ops/build.py): the slice,
// U-turn, reservoir and accept decisions are discrete, and a one-ulp
// difference flips a whole tree, so the kernel keeps the plain version's
// (ops/nuts.py) operation order and rounds as it does.

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
                 float* __restrict__ eps_out, int T, int C, int max_depth) {
  constexpr int D = Model::D;
  __shared__ float stack[kStackRows][2][D][kThreads];  // checkpoints (z, r)
  __shared__ float front[2][3][D][kThreads];  // frontiers -v, +v: (z, r, g)

  const int tid = threadIdx.x;
  const int N = T * C;
  const int n = blockIdx.x * kThreads + tid;
  if (n >= N) return;
  const int t = n / C;
  const long long base = (long long)t * D * C + (n - t * C);

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
          ptmc::uniform24(ptmc::philox4x32_10(make_uint4(row0 + k, (uint32_t)n, 0u, 0u), kk).x);
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
           int C, int max_depth, void* stream) {
  const long long n = (long long)T * C;
  if (n <= 0) return (int)cudaSuccess;
  if (max_depth < 1 || max_depth > kMaxDepth || n >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  nuts_tree_kernel<Model><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      q0, r0, beta, eps, r_eps, expo, dirs, accu, key, chol, q_prop, logp0, logp_prop, alpha,
      nalpha, alive, eps_out, T, C, max_depth);
  return (int)cudaGetLastError();
}

}  // namespace

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
                                float* eps_out, int T, int C, int max_depth, void* stream) {
  return launch<ptmc::CurvedLikelihood>(q0, r0, beta, eps, r_eps, expo, dirs, accu, key, chol,
                                        q_prop, logp0, logp_prop, alpha, nalpha, alive, eps_out,
                                        T, C, max_depth, stream);
}
