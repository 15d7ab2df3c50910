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

}  // namespace ptmc
