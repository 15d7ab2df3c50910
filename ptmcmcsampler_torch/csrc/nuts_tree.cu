// NUTS tree kernel for Hopper (sm_90a).
//
// Replaces ptmcmcsampler_tpu/ops/nuts_pallas.py::_nuts_kernel: slice-sampling
// NUTS (Hoffman & Gelman 2011, Algorithm 6; the reference's NUTSJump,
// nutsjump.py:379-840) to a depth cap of at most 10 doublings, for every
// chain of the [T, C] batch, in whitened coordinates. Per chain:
//
//   joint0 = logp0 - r0.r0/2 (NaN -> -inf),  logu = joint0 - expo
//   for each doubling j while the tree is alive:
//     direction v = dirs[j]; from the frontier in direction v run up to 2**j
//     leapfrog leaves with step v*eps. At each leaf:
//       valid = logu < joint, diverged = (logu - 1000) >= joint,
//       reservoir: n_sub += valid; take the leaf if valid and
//         resu[2**j - 1 + k] < 1/max(n_sub, 1),
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
// nalpha and alive (1 where the depth cap cut the tree) [T, C]. All
// randomness comes in as arrays, drawn by the caller (proposals/nuts.py), so
// the kernel is a deterministic function of its inputs.
//
// Design. One thread per chain, 128 threads a block; each thread builds its
// own tree and stops at its own U-turn, divergence or the depth cap, so no
// lane waits for others (the Pallas kernel masks lanes and skips a level
// only when its whole 128-lane block has stopped; that early exit, its lane
// padding and its two-pass depth dispatch are speed devices for TPU blocks
// and have no counterpart here). The chain-minor [T, D, C] arrays and the
// [depth, T, C] / [2**depth - 1, T, C] draws are read in place: element
// (row, t, c) at row*T*C + t*C + c. D is a template parameter. The frontier,
// the working point and chol live in registers; the checkpoint stack is a
// [max_depth + 1][2][D] array indexed by the dynamic stack top, so it lives
// in local memory (176 bytes a thread at D = 2). The top follows the leaf
// index exactly as nuts_pallas.py:218-241: +1 after an even leaf,
// -(trailing_ones(k) - 1) after an odd one, trailing_ones from __popc.
//
// What bounds it on an H100. A leaf is a leapfrog step of the curved model
// (about 74 operations), a U-turn check of a few dot products and one
// 4-byte read of its reservoir uniform; the bytes a tree must move are its
// inputs and outputs (about 60 bytes a chain plus 8 bytes a doubling) and one
// uniform for each leaf it visits. Trees differ in size from chain to chain
// (1 to 1023 leaves), and a warp runs as long as its deepest lane, so the
// kernel is bound by the latency of the deepest trees and warp divergence,
// not by bytes or operations. Making it fast is later work.
//
// Built with --fmad=false and without fast math (ops/build.py): the slice,
// U-turn, reservoir and accept decisions are discrete, and a one-ulp
// difference flips a whole tree, so the kernel keeps the plain version's
// (ops/nuts.py) operation order and rounds as it does.

#include <cuda_runtime.h>

#include "models.cuh"

namespace {

using ptmc::dot;
using ptmc::log_hamiltonian;
using ptmc::whitened_value_grad;

constexpr int kMaxDepth = 10;

// min(1, x) propagating NaN, as jnp.minimum and torch.clamp do.
__device__ __forceinline__ float min1(float x) { return isnan(x) ? x : fminf(1.0f, x); }

template <class Model>
__global__ void __launch_bounds__(128)
nuts_tree_kernel(const float* __restrict__ q0, const float* __restrict__ r0,
                 const float* __restrict__ beta, const float* __restrict__ eps_in,
                 const float* __restrict__ expo, const float* __restrict__ dirs,
                 const float* __restrict__ accu, const float* __restrict__ resu,
                 const float* __restrict__ chol_in, float* __restrict__ q_prop,
                 float* __restrict__ logp0_out, float* __restrict__ logp_prop_out,
                 float* __restrict__ alpha_out, float* __restrict__ nalpha_out,
                 float* __restrict__ alive_out, int T, int C, int max_depth) {
  constexpr int D = Model::D;
  const long long N = (long long)T * C;
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int t = (int)(n / C);
  const int c = (int)(n % C);
  const long long base = (long long)t * D * C + c;

  float chol[D][D];
  ptmc::load_chol<D>(chol_in, chol);

  // Trajectory state: the two frontiers (position, momentum, gradient) and
  // the current proposal.
  float zm[D], rm[D], gm[D], zp[D], rp[D], gp[D], zprop[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    zm[d] = q0[base + (long long)d * C];
    rm[d] = r0[base + (long long)d * C];
  }
  const float b = __ldg(beta + t);
  const float eps = eps_in[n];
  const float logp0 = whitened_value_grad<Model>(chol, zm, b, gm);
  const float joint0 = log_hamiltonian<D>(logp0, rm);
  const float logu = joint0 - expo[n];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    zp[d] = zm[d];
    rp[d] = rm[d];
    gp[d] = gm[d];
    zprop[d] = zm[d];
  }
  float logp_prop = logp0;
  float ntot = 1.0f;
  float alpha = 0.0f;
  float nalpha = 0.0f;
  bool alive = eps > 0.0f;

  float stz[kMaxDepth + 1][D];  // checkpoint stack: positions
  float str[kMaxDepth + 1][D];  // and momenta

  for (int j = 0; j < max_depth && alive; ++j) {
    const float v = dirs[j * N + n];
    const bool vneg = v < 0.0f;
    const float ve = v * eps;
    const float hve = 0.5f * ve;

    // Working point = the frontier in direction v.
    float z[D], r[D], g[D], zps[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      z[d] = vneg ? zm[d] : zp[d];
      r[d] = vneg ? rm[d] : rp[d];
      g[d] = vneg ? gm[d] : gp[d];
      zps[d] = z[d];
    }
    float lps = -INFINITY;
    float n_sub = 0.0f;
    bool active = true;
    int top = 0;
    const int nleaves = 1 << j;
    const float* resu_j = resu + (long long)(nleaves - 1) * N + n;

    for (int k = 0; k < nleaves && active; ++k) {
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

      // Reservoir: uniform among the subtree's valid leaves.
      if (valid) n_sub = n_sub + 1.0f;
      if (valid && resu_j[(long long)k * N] < 1.0f / fmaxf(n_sub, 1.0f)) {
#pragma unroll
        for (int d = 0; d < D; ++d) zps[d] = z[d];
        lps = logp1;
      }
      alpha = alpha + min1(expf(joint - joint0));
      nalpha = nalpha + 1.0f;

      // Checkpointed U-turn checks.
      bool turning = false;
      if ((k & 1) == 0) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
          stz[top][d] = z[d];
          str[top][d] = r[d];
        }
        top += 1;
      } else {
        const int kp = k + 1;
        const int t_ones = __popc((kp & -kp) - 1);
        for (int i = top - t_ones; i < top; ++i) {
          float dzv[D];
#pragma unroll
          for (int d = 0; d < D; ++d) dzv[d] = v * (z[d] - stz[i][d]);
          const bool cont = dot<D>(dzv, str[i]) >= 0.0f && dot<D>(dzv, r) >= 0.0f;
          turning = turning || !cont;
        }
        top -= t_ones - 1;
      }
      active = !diverged && !turning;
    }

    // Move the frontier in direction v.
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (vneg) {
        zm[d] = z[d];
        rm[d] = r[d];
        gm[d] = g[d];
      } else {
        zp[d] = z[d];
        rp[d] = r[d];
        gp[d] = g[d];
      }
    }
    // Progressive sample across doublings (nutsjump.py:786-791).
    if (active && accu[j * N + n] < n_sub / fmaxf(ntot, 1.0f)) {
#pragma unroll
      for (int d = 0; d < D; ++d) zprop[d] = zps[d];
      logp_prop = lps;
    }
    ntot = ntot + n_sub;
    // Whole-trajectory U-turn (nutsjump.py:465-493).
    float dz[D];
#pragma unroll
    for (int d = 0; d < D; ++d) dz[d] = zp[d] - zm[d];
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
           const float* expo, const float* dirs, const float* accu, const float* resu,
           const float* chol, float* q_prop, float* logp0, float* logp_prop, float* alpha,
           float* nalpha, float* alive, int T, int C, int max_depth, void* stream) {
  const long long n = (long long)T * C;
  if (n <= 0) return (int)cudaSuccess;
  if (max_depth < 1 || max_depth > kMaxDepth) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  nuts_tree_kernel<Model><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      q0, r0, beta, eps, expo, dirs, accu, resu, chol, q_prop, logp0, logp_prop, alpha,
      nalpha, alive, T, C, max_depth);
  return (int)cudaGetLastError();
}

}  // namespace

// All arrays are device pointers, f32: q0, r0, q_prop [T, D, C]; beta [T];
// eps, expo, logp0, logp_prop, alpha, nalpha, alive [T, C]; dirs, accu
// [max_depth, T, C]; resu [2**max_depth - 1, T, C]; chol [D, D] row-major.
// Launches on `stream`, does not synchronise and allocates nothing. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a depth outside [1, 10].
extern "C" int nuts_tree_curved(const float* q0, const float* r0, const float* beta,
                                const float* eps, const float* expo, const float* dirs,
                                const float* accu, const float* resu, const float* chol,
                                float* q_prop, float* logp0, float* logp_prop, float* alpha,
                                float* nalpha, float* alive, int T, int C, int max_depth,
                                void* stream) {
  return launch<ptmc::CurvedLikelihood>(q0, r0, beta, eps, expo, dirs, accu, resu, chol,
                                        q_prop, logp0, logp_prop, alpha, nalpha, alive, T, C,
                                        max_depth, stream);
}
