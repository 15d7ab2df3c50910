"""PyTorch port vs the JAX package: the correlated, interval-transformed and
hierarchical Gaussians' values, closed-form gradients, priors, per-point
API and posterior moments, at their default dimensions (and the bench's
200-D correlated model).

Tolerance rtol 1e-5, atol 1e-6 (test_torch_model.py's), except for the
correlated model's likelihood and gradient: there each value is a sum of D
terms of either sign that cancel (|icov| reaches 264 at 20-D), so its f32
rounding error scales with the sum of the terms' magnitudes, not with the
result. Its error is held to 1e-5 of ``sum_k |icov_ik| |diff_k|`` (and of
``diff.|icov|.diff`` for the value) instead; likewise the hierarchical
model's hyper-parameter gradient, ``-mu/s_mu^2 + sum_i (theta_i - mu)/s_t^2``
(49 terms), to 1e-5 of the sum of its terms' magnitudes; and the interval
model's gradient, ``beta (-x (b-a) s(1-s) + 1 - 2e/(1+e))``, whose three
terms (of magnitude up to 25) cancel to results near 0, to 1e-5 of
``beta (|x (b-a) s(1-s)| + 1 + |2e/(1+e)|)``. ``test_interval_gradient_
against_f64`` holds both packages to an f64 evaluation of that gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptmcmcsampler_torch import models as tm
from ptmcmcsampler_torch.ops import common
from ptmcmcsampler_tpu import models as jm

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6

MODELS = {
    "correlated20": (lambda: tm.CorrelatedGaussian(), lambda: jm.CorrelatedGaussian()),
    "correlated200": (lambda: tm.CorrelatedGaussian(ndim=200, seed=1),
                      lambda: jm.CorrelatedGaussian(ndim=200, seed=1)),
    "interval": (lambda: tm.IntervalTransformedGaussian(), lambda: jm.IntervalTransformedGaussian()),
    "hierarchical": (lambda: tm.HierarchicalGaussian(), lambda: jm.HierarchicalGaussian()),
}


def _points(name, model, kind, n=300, seed=0):
    rng = np.random.default_rng(seed)
    d = model.ndim
    if name.startswith("correlated"):
        centre, scale = model.mu, 0.5
    elif name == "interval":
        centre, scale = np.full(d, -2.5), 1.0
    else:
        centre, scale = model.posterior_moments()[0], 0.3
    if kind == "near":
        pts = centre + scale * rng.normal(size=(n, d))
    elif kind == "far":
        pts = centre + 10 * scale * rng.normal(size=(n, d))
    else:  # outside the box where there is one; very large |p| for the interval model
        pts = centre + scale * rng.normal(size=(n, d))
        if name.startswith("correlated"):
            pts[::3, 0] = -0.5
            pts[1::3, -1] = 10.5
            pts[2, :] = model.a  # on the closed box's face: inside
        elif name == "interval":
            pts[::2, 0] = 95.0  # exp(p) overflows: ll -inf, gradient NaN
            pts[1::2, 1] = -120.0
        else:
            pts *= 30.0
    return pts.astype(np.float32)


def _jax_value_grad(jmodel, pts, beta):
    def fg(x):
        ll, gll = jmodel.lnlikefn_grad(x)
        lp, glp = jmodel.lnpriorfn_grad(x)
        return beta * ll + lp, beta * gll + glp

    v, g = jax.vmap(fg)(jnp.asarray(pts))
    return np.asarray(v), np.asarray(g)


def _interval_terms(model, pts):
    """``(gradient, |x (b-a) s(1-s)| + 1 + |2e/(1+e)|)`` of the interval
    model at ``pts``, in f64."""
    p = pts.astype(np.float64)
    w = model.pmax - model.pmin
    s = 1.0 / (1.0 + np.exp(-p))
    x = w * s + model.pmin
    with np.errstate(over="ignore", invalid="ignore"):
        e = np.exp(p)
        tail = 2.0 * e / (1.0 + e)
    head = x * w * s * (1.0 - s)
    return -head + 1.0 - tail, np.abs(head) + 1.0 + np.abs(tail)


def _assert_close(name, model, pts, got, want, what, beta=1.0):
    """Elementwise within RTOL/ATOL, or for the correlated model, the
    hierarchical hyper-gradient and the interval gradient within RTOL of the
    sum of the terms' magnitudes; equal NaN and -inf masks."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want), err_msg=what)
    fin = np.isfinite(want)
    if name.startswith("correlated"):
        diff = np.abs(pts - model.mu)
        terms = diff @ np.abs(model.icov)  # [n, D]: sum_k |icov_ik| |diff_k|
        scale = terms if got.ndim == 2 else (terms * diff).sum(1) / 2
        with np.errstate(invalid="ignore"):
            assert (np.abs(got - want)[fin] <= ATOL + RTOL * scale[fin]).all(), what
    elif name == "hierarchical" and got.ndim == 2:
        scale = np.abs(want)
        scale[:, 0] = (np.abs(pts[:, 1:] - pts[:, :1]).sum(1) / model.s_t**2
                       + np.abs(pts[:, 0]) / model.s_mu**2)
        assert (np.abs(got - want)[fin] <= ATOL + RTOL * scale[fin]).all(), what
    elif name == "interval" and got.ndim == 2:
        scale = beta * _interval_terms(model, pts)[1]
        assert (np.abs(got - want)[fin] <= ATOL + RTOL * scale[fin]).all(), what
    else:
        np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("kind", ["near", "far", "outside"])
@pytest.mark.parametrize("beta", [1.0, 0.125])
def test_value_grad_matches_jax(name, kind, beta):
    t_model, j_model = (f() for f in MODELS[name])
    pts = _points(name, t_model, kind)
    jv, jg = _jax_value_grad(j_model, pts, beta)
    x = torch.tensor(pts.T.copy())[None]  # [1, D, C]
    tv, tg = t_model.value_grad(x, torch.tensor([[beta]]))
    assert tv.shape == (1, len(pts)) and tg.shape == x.shape
    _assert_close(name, t_model, pts, tv[0].numpy(), jv, "value")
    _assert_close(name, t_model, pts, tg[0].numpy().T, jg, "gradient", beta)


@pytest.mark.parametrize("kind", ["near", "far", "outside"])
def test_interval_gradient_against_f64(kind):
    """The interval model's gradient in both packages against its f64
    evaluation, as a share of the terms' magnitudes: the port is no farther
    from it than the JAX package, give or take half an f32 ulp."""
    t_model, j_model = (f() for f in MODELS["interval"])
    pts = _points("interval", t_model, kind)
    _, jg = _jax_value_grad(j_model, pts, 1.0)
    x = torch.tensor(pts.T.copy())[None]
    tg = t_model.value_grad(x, torch.tensor([[1.0]]))[1][0].numpy().T
    g64, terms = _interval_terms(t_model, pts)
    fin = np.isfinite(jg)
    assert fin.sum() > 0.9 * fin.size if kind != "outside" else fin.any()
    port = np.max(np.abs(tg - g64)[fin] / terms[fin])
    ref = np.max(np.abs(jg - g64)[fin] / terms[fin])
    assert port <= ref + 2.0**-24, (port, ref)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_lnlike_lnprior_and_point_api_match_jax(name):
    t_model, j_model = (f() for f in MODELS[name])
    pts = _points(name, t_model, "outside", n=60, seed=1)
    x = torch.tensor(pts.T.copy())[None]
    jl = np.asarray(jax.vmap(j_model.lnlikefn)(jnp.asarray(pts)))
    jp = np.asarray(jax.vmap(j_model.lnpriorfn)(jnp.asarray(pts)))
    _assert_close(name, t_model, pts, t_model.lnlike(x)[0].numpy(), jl, "lnlike")
    _assert_close(name, t_model, pts, t_model.lnprior(x)[0].numpy(), jp, "lnprior")
    for i in range(0, 60, 7):
        p = torch.tensor(pts[i])
        for t_fn, j_fn in (("lnlikefn_grad", "lnlikefn_grad"), ("lnpriorfn_grad", "lnpriorfn_grad")):
            tv, tg = getattr(t_model, t_fn)(p)
            jv, jg = getattr(j_model, j_fn)(jnp.asarray(pts[i]))
            assert tv.shape == () and tg.shape == (t_model.ndim,)
            _assert_close(name, t_model, pts[i:i + 1], np.array([float(tv)]),
                          np.array([float(jv)]), t_fn)
            _assert_close(name, t_model, pts[i:i + 1], tg.numpy()[None], np.asarray(jg)[None],
                          t_fn + " gradient")
        assert float(t_model.lnlikefn(p)) == float(t_model.lnlikefn_grad(p)[0])
        assert float(t_model.lnpriorfn(p)) == float(t_model.lnpriorfn_grad(p)[0])


@pytest.mark.parametrize("name", ["interval", "hierarchical"])
def test_posterior_moments_identical(name):
    t_model, j_model = (f() for f in MODELS[name])
    kw = {"n": 20001} if name == "interval" else {}
    for a, b in zip(t_model.posterior_moments(**kw), j_model.posterior_moments(**kw)):
        np.testing.assert_array_equal(a, b)


def test_correlated_constants_are_the_jax_models():
    """Same seed, same numpy set-up: the same mu, cov and icov; no
    posterior_moments, as in the JAX package (the box truncates it)."""
    for kw in ({}, {"ndim": 200, "seed": 1}):
        t_model, j_model = tm.CorrelatedGaussian(**kw), jm.CorrelatedGaussian(**kw)
        for attr in ("mu", "cov", "icov", "a", "b"):
            np.testing.assert_array_equal(getattr(t_model, attr), getattr(j_model, attr))
        assert not hasattr(t_model, "posterior_moments")
    np.testing.assert_array_equal(tm.HierarchicalGaussian().y, jm.HierarchicalGaussian().y)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_cuda_params_layout(name):
    """The constants array a wide functor reads (csrc/models.cuh), and its
    length as the wrappers check it."""
    model = MODELS[name][0]()
    prm = model.cuda_params("cpu")
    assert prm.dtype == torch.float32 and prm.is_contiguous()
    assert prm.shape == (model.cuda_params_len(),)
    assert model.cuda_params("cpu") is prm  # made once
    d = model.ndim
    if name.startswith("correlated"):
        sym = prm[3 * d:].view(d, d)
        assert torch.equal(sym, sym.T)
        np.testing.assert_array_equal(prm[:d].numpy(), model.mu.astype(np.float32))
    elif name == "hierarchical":
        np.testing.assert_array_equal(prm[3:].numpy(), model.y.astype(np.float32))


@pytest.mark.parametrize("functor,kernel,ndim,ok", [
    ("curved", "chees", 2, True), ("curved", "nuts", 2, True), ("curved", "chees", 3, False),
    ("hierarchical_gaussian", "chees", 50, True), ("hierarchical_gaussian", "chees", 1, False),
    ("hierarchical_gaussian", "nuts", 50, True), ("interval_gaussian", "hmc", 40, True),
    ("correlated_gaussian", "chees", 200, True), ("correlated_gaussian", "chees", 1025, False),
    (None, "chees", 2, False), ("nosuch", "chees", 2, False),
    ("correlated_gaussian", "nuts", 200, True), ("correlated_gaussian", "hmc", 256, True),
    ("correlated_gaussian", "nuts", 1025, False), ("interval_gaussian", "hmc", 1025, False),
    ("hierarchical_gaussian", "nuts", 1, False), ("hierarchical_gaussian", "hmc", 1025, False),
    ("correlated_gaussian", "chees", 257, True), ("correlated_gaussian", "nuts", 300, True),
    ("interval_gaussian", "hmc", 512, True), ("hierarchical_gaussian", "hmc", 1024, True),
    (None, "nuts", 50, False), ("nosuch", "hmc", 40, False),
])
def test_functor_table(functor, kernel, ndim, ok):
    why = common.kernel_refusal(functor, kernel, ndim)
    assert (why is None) == ok
    if not ok and functor in common.FUNCTORS and functor != "curved":
        assert f"got {ndim}" in why  # a wide functor refuses only a D outside its range
