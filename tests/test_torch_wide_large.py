"""PyTorch port vs the JAX package past D = 256, where the wide layout runs
groups of 8 chains (D <= 512) and of 4 (D <= 1024): the plain versions of
the three wide kernels' entries on a 270-D hierarchy (the whole-array
pulsar-timing class: 67 pulsars, two power laws each, and a common
process), a 300-D correlated Gaussian and a 1024-D hierarchy.

* ``chees_trajectories_plain``, ``nuts_trees_plain`` (depth 3 and 4) and
  ``hmc_trajectories_plain`` against the Pallas kernels run by the
  interpreter (``interpret=True``), with the identity and a dense
  whitening factor, fed the same numpy-seeded arrays;
* the fused steps' plain versions (``make_chees``'s core, ``hmc_step_plain``)
  against the JAX proposals fed the same draws, replayed from their keys.

A few chains and short trajectories: the Pallas interpreter and the plain
versions' ordered sums over D are slow on the CPU. Tolerances are
test_torch_chees_wide.py's and test_torch_nuts_wide.py's (Q_TOL, QXY_TOL,
LOGP_TOL, ALPHA_RTOL, SS_RTOL, SS_ATOL): f32 sums over D are ordered
differently in XLA and in the port. Leaf counts and cap cuts must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptmcmcsampler_torch import config as t_config
from ptmcmcsampler_torch import models as tm
from ptmcmcsampler_torch.ops.chees import chees_trajectories_plain
from ptmcmcsampler_torch.ops.hmc import hmc_step_plain, hmc_trajectories_plain
from ptmcmcsampler_torch.ops.nuts import nuts_trees_plain
from ptmcmcsampler_torch.proposals import chees as t_chees
from ptmcmcsampler_torch.proposals.base import ProposalContext as TCtx
from ptmcmcsampler_tpu import config as j_config
from ptmcmcsampler_tpu import models as jm
from ptmcmcsampler_tpu.ops.chees_pallas import fused_chees_trajectories
from ptmcmcsampler_tpu.ops.hmc_pallas import fused_hmc_trajectories
from ptmcmcsampler_tpu.ops.nuts_pallas import fused_nuts_trees
from ptmcmcsampler_tpu.proposals import chees as j_chees
from ptmcmcsampler_tpu.proposals import gradient as j_gradient
from ptmcmcsampler_tpu.proposals.base import ProposalContext as JCtx
from ptmcmcsampler_tpu.utils import split_grid

torch.set_num_threads(2)

Q_TOL, QXY_TOL, LOGP_TOL, ALPHA_RTOL = 2e-4, 2e-3, 2e-3, 1e-4
SS_RTOL, SS_ATOL = 2e-3, 2e-4
T = 2
HMC_NMIN, HMC_NMAX = 2, 6

MODELS = {
    "hierarchical270": (lambda: tm.HierarchicalGaussian(ngroups=269),
                        lambda: jm.HierarchicalGaussian(ngroups=269)),
    "correlated300": (lambda: tm.CorrelatedGaussian(ndim=300, seed=1),
                      lambda: jm.CorrelatedGaussian(ndim=300, seed=1)),
    "hierarchical1024": (lambda: tm.HierarchicalGaussian(ngroups=1023),
                         lambda: jm.HierarchicalGaussian(ngroups=1023)),
}
# A step size a rung that gives trees of several sizes (whitened coordinates).
NUTS_EPS = {"hierarchical270": 0.08, "correlated300": 0.01, "hierarchical1024": 0.08}


def _func_grad(jmodel):
    def fg(x, beta):
        ll, gll = jmodel.lnlikefn_grad(x)
        lp, glp = jmodel.lnpriorfn_grad(x)
        return beta * ll + lp, beta * gll + glp

    return fg


def _setup(name, factor, c, seed):
    """Positions around the posterior (one chain outside the correlated
    model's box), the identity or a well-conditioned dense factor, two rungs."""
    t_model, j_model = (f() for f in MODELS[name])
    rng = np.random.default_rng(seed)
    d = t_model.ndim
    if name.startswith("correlated"):
        centre, scale = t_model.mu, 0.1
    else:
        centre, scale = t_model.posterior_moments()[0], 0.3
    x = (centre[None, :, None] + scale * rng.normal(size=(T, d, c))).astype(np.float32)
    if name.startswith("correlated"):
        x = x.clip(0.05, 9.95)  # inside the closed box [0, 10] ...
        x[0, 0, 1] = -0.5  # ... but for this one
    if factor == "identity":
        chol = np.eye(d, dtype=np.float32)
    else:
        a = rng.normal(size=(d, d)) / d
        chol = np.linalg.cholesky(0.05 * np.eye(d) + 0.05 * a @ a.T).astype(np.float32)
    betas = np.array([1.0, 0.3], np.float32)
    return t_model, j_model, rng, x, chol, betas


def _structure(factor):
    return "diagonal" if factor == "identity" else "dense"


def _rows(a):
    """``[T, K, C]`` -> ``[T*C, K]`` (the JAX kernels' rows)."""
    return jnp.asarray(np.moveaxis(a, 1, 2).reshape(-1, a.shape[1]))


def _to_tdc(a, t, c):
    """``[T*C, K]`` -> ``[T, K, C]``."""
    return np.moveaxis(np.asarray(a).reshape(t, c, -1), 2, 1)


def _whiten(x, chol):
    return np.einsum("ki,tkc->tic", np.linalg.inv(chol), x).astype(np.float32)


CASES = [("hierarchical270", "identity"), ("hierarchical270", "dense"),
         ("correlated300", "identity"), ("correlated300", "dense"),
         ("hierarchical1024", "identity")]


@pytest.mark.parametrize("name,factor", CASES)
def test_plain_chees_trajectory_matches_pallas_interpreted(name, factor):
    c, max_steps = 4, 4
    t_model, j_model, rng, x, chol, betas = _setup(name, factor, c, 0)
    d = t_model.ndim
    q0 = _whiten(x, chol)
    p0 = rng.normal(size=(T, d, c)).astype(np.float32)
    eps = np.repeat(np.array([[0.05], [0.08]], np.float32), c, axis=1)
    nsteps = rng.integers(1, max_steps + 1, size=(T, c)).astype(np.int32)
    jq, jp, jl = fused_chees_trajectories(
        _rows(q0), _rows(p0), jnp.asarray(np.repeat(betas, c)), jnp.asarray(eps.reshape(-1)),
        jnp.asarray(nsteps.reshape(-1)), jnp.asarray(chol), func_grad=_func_grad(j_model),
        ndim=d, max_steps=max_steps, interpret=True,
    )
    tq, tp, tl = chees_trajectories_plain(
        torch.tensor(q0), torch.tensor(p0), torch.tensor(betas), torch.tensor(eps),
        torch.tensor(nsteps), torch.tensor(chol), t_model, _structure(factor),
    )
    np.testing.assert_allclose(tq.numpy(), _to_tdc(jq, T, c), rtol=Q_TOL, atol=Q_TOL)
    np.testing.assert_allclose(tp.numpy(), _to_tdc(jp, T, c), rtol=Q_TOL, atol=Q_TOL)
    jl = np.asarray(jl).reshape(T, c)
    np.testing.assert_array_equal(np.isneginf(tl.numpy()), np.isneginf(jl))
    fin = np.isfinite(jl)
    np.testing.assert_allclose(tl.numpy()[fin], jl[fin], rtol=QXY_TOL, atol=QXY_TOL)
    if name.startswith("correlated"):
        assert np.isneginf(tl.numpy()[0, 1])  # outside the box


@pytest.mark.parametrize("name,factor,depth", [
    ("hierarchical270", "identity", 3), ("hierarchical270", "dense", 4),
    ("correlated300", "dense", 3), ("hierarchical1024", "identity", 3),
])
def test_plain_nuts_tree_matches_pallas_interpreted(name, factor, depth):
    c = 4
    t_model, j_model, rng, x, chol, betas = _setup(name, factor, c, depth)
    d = t_model.ndim
    f32 = np.float32
    inp = dict(
        q0=_whiten(x, chol), r0=rng.normal(size=(T, d, c)).astype(f32), beta=betas,
        eps=(NUTS_EPS[name] * 1.5 ** np.arange(T)[:, None] * np.ones((T, c))).astype(f32),
        expo=rng.exponential(size=(T, c)).astype(f32),
        dirs=np.where(rng.random((depth, T, c)) < 0.5, -1.0, 1.0).astype(f32),
        accu=rng.random((depth, T, c)).astype(f32),
        resu=rng.random(((1 << depth) - 1, T, c)).astype(f32), chol=chol,
    )

    def rows_k(a):  # [K, T, C] -> [T*C, K]
        return jnp.asarray(np.moveaxis(a, 0, 2).reshape(T * c, -1))

    jout = fused_nuts_trees(
        _rows(inp["q0"]), _rows(inp["r0"]), jnp.asarray(np.repeat(betas, c)),
        jnp.asarray(inp["eps"].reshape(-1)), jnp.asarray(inp["expo"].reshape(-1)),
        rows_k(inp["dirs"]), rows_k(inp["accu"]), rows_k(inp["resu"]), jnp.asarray(chol),
        func_grad=_func_grad(j_model), ndim=d, max_depth=depth, interpret=True,
    )
    tout = nuts_trees_plain(*(torch.tensor(inp[k]) for k in (
        "q0", "r0", "beta", "eps", "expo", "dirs", "accu", "resu", "chol")), t_model,
        structure=_structure(factor))
    jq = _to_tdc(jout[0], T, c)
    jl0, jlp, ja, jn, jalive = (np.asarray(a).reshape(T, c) for a in jout[1:])
    tq, tl0, tlp, ta, tn, talive, teps = (a.numpy() for a in tout)
    np.testing.assert_array_equal(teps, inp["eps"])  # no lane searched
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(talive, jalive)
    np.testing.assert_allclose(tq, jq, rtol=Q_TOL, atol=Q_TOL)
    np.testing.assert_array_equal(np.isneginf(tl0), np.isneginf(jl0))
    fin = np.isfinite(jl0)
    np.testing.assert_allclose(tl0[fin], jl0[fin], rtol=LOGP_TOL, atol=LOGP_TOL)
    np.testing.assert_array_equal(np.isneginf(tlp), np.isneginf(jlp))
    fin = np.isfinite(jlp)
    np.testing.assert_allclose(tlp[fin], jlp[fin], rtol=LOGP_TOL, atol=LOGP_TOL)
    np.testing.assert_allclose(ta, ja, rtol=ALPHA_RTOL, atol=ALPHA_RTOL)
    assert tn.max() > 1  # trees of more than one leaf


@pytest.mark.parametrize("name,factor", CASES)
def test_plain_hmc_trajectories_match_pallas_interpreted(name, factor):
    c, eps = 4, 0.08
    t_model, j_model, rng, x, chol, betas = _setup(name, factor, c, 2)
    d = t_model.ndim
    q0 = _whiten(x, chol)
    p0 = rng.normal(size=(T, d, c)).astype(np.float32)
    nsteps = rng.integers(HMC_NMIN, HMC_NMAX, size=(T, c)).astype(np.int32)
    jq, jqxy = fused_hmc_trajectories(
        _rows(q0), _rows(p0), jnp.asarray(np.repeat(betas, c)), jnp.asarray(nsteps.reshape(-1)),
        jnp.asarray(chol), func_grad=_func_grad(j_model), ndim=d, eps=eps,
        nmax_steps=HMC_NMAX - 1, interpret=True,
    )
    tq, tqxy = hmc_trajectories_plain(
        torch.tensor(q0), torch.tensor(p0), torch.tensor(betas), torch.tensor(nsteps),
        torch.tensor(chol), eps, t_model, _structure(factor))
    np.testing.assert_allclose(tq.numpy(), _to_tdc(jq, T, c), rtol=Q_TOL, atol=Q_TOL)
    jqxy = np.asarray(jqxy).reshape(T, c)
    np.testing.assert_array_equal(np.isneginf(tqxy.numpy()), np.isneginf(jqxy))
    fin = np.isfinite(jqxy)
    np.testing.assert_allclose(tqxy.numpy()[fin], jqxy[fin], rtol=QXY_TOL, atol=QXY_TOL)


@pytest.mark.parametrize("name", ["hierarchical270", "correlated300"])
def test_hmc_step_plain_matches_make_hmc(name):
    """The fused HMC step's plain version (whitening, the trajectory on the
    JAX draws, back-mapping) against the JAX ``make_hmc`` under per-chain
    key splits, with a dense factor."""
    c, eps = 4, 0.08
    t_model, j_model, _, x, chol, betas = _setup(name, "dense", c, 1)
    d = t_model.ndim
    chol_inv = np.linalg.inv(chol).astype(np.float32)
    jc = j_config.SamplerConfig(
        jumps=j_config.build_default_jumps(HMCweight=1, have_grads=True), ndim=d, ntemps=T,
        nchains=c, groups=(tuple(range(d)),), hmc_stepsize=eps, hmc_nminsteps=HMC_NMIN,
        hmc_nmaxsteps=HMC_NMAX)
    jctx = JCtx(group_u=None, group_s=None, chol=jnp.asarray(chol), chol_inv=jnp.asarray(chol_inv),
                de_buf=None, de_valid=None)
    keys = split_grid(jax.random.key(3), (T, c))
    hmc = j_gradient.make_hmc(jc, _func_grad(j_model))
    per_chain = jax.vmap(lambda k, xx, b: hmc(k, xx, b, 0, jctx), in_axes=(0, -1, None),
                         out_axes=(-1, 0))
    jq, jqxy = jax.vmap(per_chain)(keys, jnp.asarray(x), jnp.asarray(betas))
    ks = jax.vmap(jax.vmap(jax.random.split))(keys)
    p0 = jax.vmap(jax.vmap(lambda k: jax.random.normal(k, (d,), dtype=jnp.float32),
                           out_axes=-1))(ks[:, :, 0])
    nsteps = jax.vmap(jax.vmap(lambda k: jax.random.randint(k, (), HMC_NMIN, HMC_NMAX)))(
        ks[:, :, 1])
    draws = (torch.tensor(np.asarray(p0)), torch.tensor(np.asarray(nsteps, np.int32)))
    tq, tqxy = hmc_step_plain(torch.tensor(x), torch.tensor(betas), draws, torch.tensor(chol),
                              torch.tensor(chol_inv), eps, HMC_NMIN, HMC_NMAX, t_model)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=Q_TOL, atol=Q_TOL)
    jqxy = np.asarray(jqxy)
    np.testing.assert_array_equal(np.isneginf(tqxy.numpy()), np.isneginf(jqxy))
    fin = np.isfinite(jqxy)
    np.testing.assert_allclose(tqxy.numpy()[fin], jqxy[fin], rtol=QXY_TOL, atol=QXY_TOL)


def _jax_chees_draws(keys, d):
    """r0 [T, D, C] and u [T, C] as make_chees draws them (chees.py:74-103)."""
    ks = jax.vmap(jax.vmap(lambda k: jax.random.split(k, 4)))(keys)
    u = jax.vmap(jax.vmap(
        lambda k: jax.random.uniform(k, (), dtype=jnp.float32, minval=1e-3, maxval=1.0)
    ))(ks[:, :, 1])
    r0 = jax.vmap(jax.vmap(lambda k: jax.random.normal(k, (d,), dtype=jnp.float32),
                           out_axes=-1))(ks[:, :, 0])
    return np.asarray(r0), np.asarray(u)


@pytest.mark.parametrize("name,it", [("hierarchical270", 5), ("correlated300", 200)])
def test_chees_step_matches_xla_leapfrog(name, it):
    """The ChEES step (its core: the fused step's plain version and the
    step-size update) against the JAX package's XLA leapfrog fed the same
    momenta and jitter, in burn-in and after it, with a dense factor."""
    c, max_steps = 4, 8
    t_model, j_model, _, x, chol, betas = _setup(name, "dense", c, 1)
    d = t_model.ndim
    chol_inv = np.linalg.inv(chol).astype(np.float32)
    kw = dict(ndim=d, ntemps=T, nchains=c, groups=(tuple(range(d)),), burn=100,
              hmc_stepsize=0.02, chees_max_steps=max_steps)
    jc = dataclasses.replace(j_config.SamplerConfig(
        jumps=j_config.build_default_jumps(CHEESweight=1, have_grads=True), **kw),
        use_pallas=False)
    tc = t_config.SamplerConfig(jumps=t_config.build_default_jumps(CHEESweight=1, have_grads=True),
                                **kw)
    vals = dict(chees_eps=0.02, chees_epsbar=0.02, chees_hbar=0.01, chees_mu=np.log(0.2),
                chees_count=3.0, chees_m=0.1, chees_v=0.02, chees_tlen=0.1)
    ss = {k: np.full((T, c), v, np.float32) for k, v in vals.items()}
    jctx = JCtx(group_u=None, group_s=None, chol=jnp.asarray(chol), chol_inv=jnp.asarray(chol_inv),
                de_buf=None, de_valid=None)
    tctx = TCtx(group_u=None, group_s=None, chol=torch.tensor(chol),
                chol_inv=torch.tensor(chol_inv), de_buf=None, de_valid=0)
    keys = split_grid(jax.random.key(5), (T, c))
    jq, jqxy, jss = j_chees.make_chees(jc, _func_grad(j_model))(
        keys, jnp.asarray(x), jnp.asarray(betas), it, jctx,
        {k: jnp.asarray(v) for k, v in ss.items()})
    r0, u = _jax_chees_draws(keys, d)
    tq, tqxy, tss = t_chees.make_chees(tc, t_model).core(
        torch.tensor(x), torch.tensor(betas), it, tctx, {k: torch.tensor(v) for k, v in ss.items()},
        torch.tensor(r0), torch.tensor(u))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=Q_TOL, atol=Q_TOL)
    jqxy = np.asarray(jqxy)
    np.testing.assert_array_equal(np.isneginf(tqxy.numpy()), np.isneginf(jqxy))
    fin = np.isfinite(jqxy)
    np.testing.assert_allclose(tqxy.numpy()[fin], jqxy[fin], rtol=QXY_TOL, atol=QXY_TOL)
    for k in ss:
        np.testing.assert_allclose(tss[k].numpy(), np.asarray(jss[k]), rtol=SS_RTOL,
                                   atol=SS_ATOL, err_msg=k)
