"""PyTorch port vs the JAX package: the curved likelihood's value, closed-form
gradient, prior and quadrature moments."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptmcmcsampler_torch.models import CurvedLikelihood as TCurved
from ptmcmcsampler_tpu.models import CurvedLikelihood as JCurved

torch.set_num_threads(2)

# f32 exp/log1p differ between XLA and PyTorch by ulps.
RTOL, ATOL = 1e-5, 1e-6


def _points(kind, n=400, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "modes":  # around the banana ridge and the blob
        mode = np.where(rng.random(n) < 0.5, -1.0, 2.0)
        pts = rng.normal(scale=0.4, size=(n, 2)) + np.stack([np.zeros(n), mode], 1)
    elif kind == "far":
        pts = rng.uniform(-9.9, 9.9, size=(n, 2))
    else:  # outside the prior box, and on its boundary
        pts = rng.uniform(-30, 30, size=(n, 2))
        pts[:4] = [[10.0, 0.0], [-10.0, 1.0], [0.5, 10.0], [9.999, -9.999]]
    return pts.astype(np.float32)


def _jax_value_grad(pts, beta):
    m = JCurved()

    def fg(x):
        ll, gll = m.lnlikefn_grad(x)
        lp, glp = m.lnpriorfn_grad(x)
        return beta * ll + lp, beta * gll + glp

    v, g = jax.vmap(fg)(jnp.asarray(pts))
    return np.asarray(v), np.asarray(g)


@pytest.mark.parametrize("kind", ["modes", "far", "outside"])
@pytest.mark.parametrize("beta", [1.0, 0.125])
def test_value_grad_matches_jax(kind, beta):
    pts = _points(kind)
    jv, jg = _jax_value_grad(pts, beta)
    x = torch.tensor(pts.T.copy())[None]  # [1, D, C]
    tv, tg = TCurved().value_grad(x, torch.tensor([[beta]]))
    tv, tg = tv[0].numpy(), tg[0].numpy().T
    np.testing.assert_array_equal(np.isneginf(tv), np.isneginf(jv))
    fin = np.isfinite(jv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["modes", "outside"])
def test_lnlike_lnprior_match_jax(kind):
    pts = _points(kind, seed=1)
    m = JCurved()
    jl = np.asarray(jax.vmap(m.lnlikefn)(jnp.asarray(pts)))
    jp = np.asarray(jax.vmap(m.lnpriorfn)(jnp.asarray(pts)))
    x = torch.tensor(pts.T.copy())[None]
    np.testing.assert_allclose(TCurved().lnlike(x)[0].numpy(), jl, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(TCurved().lnprior(x)[0].numpy(), jp)


def test_posterior_moments_identical():
    for a, b in zip(TCurved().posterior_moments(n=801), JCurved().posterior_moments(n=801)):
        np.testing.assert_array_equal(a, b)
