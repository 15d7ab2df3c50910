"""The whitening factor's structure tag: how it is worked out, what the plain
versions' structured products keep, and the wide plain entries under a
diagonal and a lower triangular factor against the JAX package.

* The tag of a factor pair (``ops/common.py`` ``factor_structure``) from
  exact zeros of its f32 values, as ``state.init_adapt_state`` and a load
  work it out: "diagonal", or "dense" for any other pair, a triangular one
  too; ``adaptation.refresh_factors`` widens it to "dense" under
  ``mass_adapt``.
* ``common.matvec`` with a matrix's tag against the dense sum: bit for bit
  on finite inputs away from zero sums, equal in value where a sum is zero
  (a dropped ``0 * v`` keeps the sign of a zero sum, and keeps an infinite
  ``v_k`` out of the other rows: the note in ROADMAP.md section C).
* The wide plain ChEES, NUTS and HMC entries with a diagonal factor (tag
  "diagonal") and a lower triangular one (tag "dense") against the JAX
  package's Pallas kernels run by the interpreter,
  at the tolerances of test_torch_chees_wide.py, test_torch_nuts_wide.py
  and test_torch_hmc_wide.py (f32 sums over D are ordered differently in
  XLA and in the port; the structured products only drop exact zeros).
* A trajectory driven non-finite gives ``alpha = 0`` and a rejected
  proposal in both packages.
* The tag never reaches the checkpoint, and a JAX checkpoint resumes in the
  port with the tag recomputed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptmcmcsampler_torch import SamplerConfig, build_default_jumps, build_step
from ptmcmcsampler_torch import adaptation as t_adapt
from ptmcmcsampler_torch import config as t_config
from ptmcmcsampler_torch import models as tm
from ptmcmcsampler_torch.io.checkpoint import load_checkpoint
from ptmcmcsampler_torch.ops import common
from ptmcmcsampler_torch.ops.chees import (
    chees_step, chees_step_plain, chees_trajectories_plain,
)
from ptmcmcsampler_torch.ops.hmc import hmc_step_plain, hmc_trajectories_plain
from ptmcmcsampler_torch.ops.nuts import nuts_trees_plain
from ptmcmcsampler_torch.proposals import chees as t_chees
from ptmcmcsampler_torch.proposals.base import ProposalContext as TCtx
from ptmcmcsampler_torch.state import init_adapt_state, state_shapes, state_to_numpy
from ptmcmcsampler_tpu import config as j_config
from ptmcmcsampler_tpu import models as jm
from ptmcmcsampler_tpu.io.checkpoint import save_checkpoint as j_save_checkpoint
from ptmcmcsampler_tpu.ops.chees_pallas import fused_chees_trajectories
from ptmcmcsampler_tpu.ops.hmc_pallas import fused_hmc_trajectories
from ptmcmcsampler_tpu.ops.nuts_pallas import fused_nuts_trees
from ptmcmcsampler_tpu.proposals import chees as j_chees
from ptmcmcsampler_tpu.proposals.base import ProposalContext as JCtx
from ptmcmcsampler_tpu.state import init_state as j_init_state
from ptmcmcsampler_tpu.utils import split_grid

torch.set_num_threads(2)

Q_TOL, LOGP_TOL, QXY_TOL = 2e-4, 2e-3, 2e-3
SS_RTOL, SS_ATOL = 2e-3, 2e-4
T = 2

MODELS = {
    "interval40": (lambda: tm.IntervalTransformedGaussian(),
                   lambda: jm.IntervalTransformedGaussian()),
    "hierarchical50": (lambda: tm.HierarchicalGaussian(), lambda: jm.HierarchicalGaussian()),
    "correlated20": (lambda: tm.CorrelatedGaussian(), lambda: jm.CorrelatedGaussian()),
}


def _func_grad(jmodel):
    def fg(x, beta):
        ll, gll = jmodel.lnlikefn_grad(x)
        lp, glp = jmodel.lnpriorfn_grad(x)
        return beta * ll + lp, beta * gll + glp

    return fg


def _factors(factor, d, rng):
    """A factor pair of the kind ``factor`` in f32: a diagonal one of scales
    near 0.3 with its exact inverse, or a Cholesky factor of a
    well-conditioned covariance with its triangular inverse ("lower")."""
    if factor == "diagonal":
        s = rng.uniform(0.2, 0.4, d)
        return np.diag(s).astype(np.float32), np.diag(1.0 / s).astype(np.float32)
    a = rng.normal(size=(d, d)) / d
    chol = np.linalg.cholesky(0.05 * np.eye(d) + 0.05 * a @ a.T)
    return chol.astype(np.float32), np.tril(np.linalg.inv(chol)).astype(np.float32)


def _setup(name, c, seed, factor):
    """Positions around the posterior (one chain outside the correlated
    model's box), a factor pair of the kind ``factor`` and its tag, two
    rungs."""
    t_model, j_model = (f() for f in MODELS[name])
    rng = np.random.default_rng(seed)
    d = t_model.ndim
    if name.startswith("correlated"):
        centre, scale = t_model.mu, 0.1
    elif name.startswith("interval"):
        centre, scale = np.full(d, -2.5), 0.5
    else:
        centre, scale = t_model.posterior_moments()[0], 0.3
    x = (centre[None, :, None] + scale * rng.normal(size=(T, d, c))).astype(np.float32)
    if name.startswith("correlated"):
        x = x.clip(0.05, 9.95)
        x[0, 0, 3] = -0.5
    chol, chol_inv = _factors(factor, d, rng)
    structure = common.factor_structure(chol, chol_inv)
    assert structure == {"diagonal": "diagonal", "lower": "dense"}[factor]
    betas = np.array([1.0, 0.3], np.float32)
    return t_model, j_model, rng, x, chol, chol_inv, betas, structure


def _rows(a):  # [T, D, C] -> [T*C, D]
    return jnp.asarray(np.moveaxis(a, 1, 2).reshape(-1, a.shape[1]))


def _tdc(a, c):  # [T*C, D] -> [T, D, C]
    return np.moveaxis(np.asarray(a).reshape(T, c, -1), 2, 1)


# ---- the structure decision ----

def _solve_inverse(d, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(d, d))
    chol = np.linalg.cholesky(a @ a.T / d + np.eye(d))
    return chol, np.linalg.solve(chol, np.eye(d))


@pytest.mark.parametrize("case", ["identity", "diagonal", "cholesky", "solve_inverse", "dense",
                                  "lower_but_one_tiny", "diagonal_but_one_tiny"])
def test_structure_decision(case):
    d = 7
    rng = np.random.default_rng(3)
    if case == "identity":
        m, want = np.eye(d), "diagonal"
    elif case == "diagonal":
        m, want = np.diag(rng.uniform(0.5, 2.0, d)), "diagonal"
    elif case == "cholesky":
        m, want = _solve_inverse(d, 1)[0], "dense"
    elif case == "solve_inverse":
        # np.linalg.solve's inverse of a Cholesky factor: its f32 values
        # decide, and they are not diagonal.
        m, want = _solve_inverse(d, 1)[1], "dense"
    elif case == "dense":
        m, want = rng.normal(size=(d, d)), "dense"
    elif case == "lower_but_one_tiny":
        m = np.tril(rng.normal(size=(d, d)))
        m[1, 4] = 1e-30
        want = "dense"
    else:
        m = np.eye(d)
        m[5, 2] = 1e-30
        want = "dense"
    m32 = np.float32(m)
    assert common.matrix_structure(m32) == want
    assert common.matrix_structure(torch.tensor(m32)) == want
    assert common.factor_structure(m32, np.eye(d, dtype=np.float32)) == want
    assert common.factor_structure(m32, np.random.default_rng(0).normal(size=(d, d))) == "dense"


@pytest.mark.parametrize("cov", ["identity", "diagonal", "correlated"])
def test_init_adapt_state_tags_its_factors(cov):
    d = 6
    rng = np.random.default_rng(4)
    cov0 = {"identity": np.eye(d), "diagonal": np.diag(rng.uniform(0.5, 2.0, d)),
            "correlated": (lambda a: a @ a.T / d + np.eye(d))(rng.normal(size=(d, d)))}[cov]
    cfg = SamplerConfig(ndim=d, ntemps=2, nchains=4, groups=(tuple(range(d)),),
                        jumps=build_default_jumps(SCAMweight=1))
    adapt = init_adapt_state(cfg, cov0, "cpu")
    assert adapt.structure == common.factor_structure(adapt.chol, adapt.chol_inv)
    if cov != "correlated":
        assert adapt.structure == "diagonal"
    else:
        assert adapt.structure == "dense"
    # A mass-adapting refresh makes both factors triangular: the tag widens
    # to "dense", and the refreshed factors satisfy it.
    xs = torch.tensor(rng.normal(size=(d, 64)).astype(np.float32))
    for mass, want in ((False, adapt.structure), (True, "dense")):
        new = t_adapt.refresh_factors(dataclasses.replace(cfg, mass_adapt=mass),
                                      t_adapt.welford_batch_update(adapt, xs))
        assert new.structure == want
        common.check_structure("refresh", new.structure, new.chol, new.chol_inv)


# ---- the structured products ----

@pytest.mark.parametrize("kind", ["lower", "upper", "diagonal"])
@pytest.mark.parametrize("d", [1, 5, 33])
def test_matvec_structure_against_dense(kind, d):
    """A matrix of each kind under its tag: "diagonal" (an elementwise
    product), or "dense" for a triangular one (every term, as before)."""
    rng = np.random.default_rng(d)
    m = rng.normal(size=(d, d)).astype(np.float32)
    m = {"lower": np.tril(m), "upper": np.triu(m), "diagonal": np.diag(np.diag(m))}[kind]
    structure = common.matrix_structure(m)
    assert structure == ("diagonal" if kind == "diagonal" or d == 1 else "dense")
    m = torch.tensor(m)
    v = torch.tensor(rng.normal(size=(2, d, 9)).astype(np.float32))
    got, want = common.matvec(m, v, structure), common.matvec(m, v)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))  # bit for bit
    # Zero sums: a row whose kept terms are all -0.0 keeps the sign (-0.0)
    # where the dense sum's 0 * v terms make it +0.0; equal in value.
    vz = v.clone()
    vz[:, :, :3] = -0.0
    got, want = common.matvec(m, vz, structure), common.matvec(m, vz)
    assert torch.equal(got, want)
    assert torch.equal(got[:, :, 3:].view(torch.int32), want[:, :, 3:].view(torch.int32))


def test_dropped_zero_terms_keep_an_infinite_input_local():
    """The known difference from the JAX package's dense products: a
    dropped 0 * v_k no longer turns an infinite v_k into NaN in other rows."""
    d = 5
    m = torch.diag(torch.arange(1.0, d + 1))
    v = torch.ones(1, d, 1)
    v[0, 2, 0] = float("inf")
    dense = common.matvec(m, v)[0, :, 0]
    diag = common.matvec(m, v, "diagonal")[0, :, 0]
    assert torch.isnan(dense[[0, 1, 3, 4]]).all() and torch.isinf(dense[2])
    assert torch.isinf(diag[2]) and torch.equal(diag[[0, 1, 3, 4]], torch.tensor([1., 2, 4, 5]))


@pytest.mark.parametrize("entry", ["chees_step", "chees_trajectories", "hmc_step",
                                   "hmc_trajectories", "nuts_trees"])
def test_plain_versions_refuse_a_wrong_tag(entry):
    """A "diagonal" tag on a dense factor, or an unknown tag, raises: a
    wrong tag never gives a silently wrong product."""
    model = tm.IntervalTransformedGaussian(ndim=4)
    t, d, c = 1, 4, 3
    z = torch.zeros((t, d, c))
    one = torch.ones(t)
    e = torch.full((t, c), 0.1)
    n = torch.ones((t, c), dtype=torch.int32)
    dense = torch.eye(d) + 0.1 * torch.ones(d, d)
    calls = {
        "chees_step": lambda s: chees_step_plain(z, z, e, one, e, e, 0.1, 4, dense, dense, model,
                                                 s),
        "chees_trajectories": lambda s: chees_trajectories_plain(z, z, one, e, n, dense, model, s),
        "hmc_step": lambda s: hmc_step_plain(z, one, (z, n), dense, dense, 0.1, 1, 2, model, s),
        "hmc_trajectories": lambda s: hmc_trajectories_plain(z, z, one, n, dense, 0.1, model, s),
        "nuts_trees": lambda s: nuts_trees_plain(z, z, one, e, e, torch.ones((1, t, c)),
                                                 torch.ones((1, t, c)), torch.ones((1, t, c)),
                                                 dense, model, structure=s),
    }
    for tag in ("diagonal", "lower", "banded"):
        with pytest.raises(ValueError, match="structure|tagged"):
            calls[entry](tag)
    calls[entry]("dense")


@pytest.mark.parametrize("name", ["interval40", "hierarchical50"])
def test_identity_factor_step_equals_the_dense_one(name):
    """With the identity factor of bench.py's paths, the fused step's plain
    version under "diagonal" equals the dense one bit for bit on finite
    inputs: only exact zeros are dropped."""
    c = 10
    t_model, _, rng, x, _, _, betas, _ = _setup(name, c, 5, "diagonal")
    d = t_model.ndim
    eye = torch.eye(d)
    r0 = torch.tensor(rng.normal(size=(T, d, c)).astype(np.float32))
    u = torch.tensor(rng.uniform(1e-3, 1.0, (T, c)).astype(np.float32))
    eps = torch.full((T, c), 0.05)
    tlen = torch.full((T, c), 0.3)
    args = (torch.tensor(x), r0, u, torch.tensor(betas), eps, tlen, 0.05, 12, eye, eye, t_model)
    got = chees_step(*args, "diagonal")
    want = chees_step(*args)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# ---- the wide plain entries under structured factors, against the JAX package ----

@pytest.mark.parametrize("factor", ["diagonal", "lower"])
@pytest.mark.parametrize("name", ["interval40", "hierarchical50", "correlated20"])
def test_plain_chees_trajectory_matches_pallas(name, factor):
    c, max_steps = 16, 8
    t_model, j_model, rng, x, chol, chol_inv, betas, structure = _setup(name, c, 0, factor)
    d = t_model.ndim
    q0 = np.einsum("ki,tkc->tic", chol_inv, x).astype(np.float32)
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
        torch.tensor(nsteps), torch.tensor(chol), t_model, structure,
    )
    np.testing.assert_allclose(tq.numpy(), _tdc(jq, c), rtol=Q_TOL, atol=Q_TOL)
    np.testing.assert_allclose(tp.numpy(), _tdc(jp, c), rtol=Q_TOL, atol=Q_TOL)
    jl = np.asarray(jl).reshape(T, c)
    np.testing.assert_array_equal(np.isneginf(tl.numpy()), np.isneginf(jl))
    fin = np.isfinite(jl)
    np.testing.assert_allclose(tl.numpy()[fin], jl[fin], rtol=QXY_TOL, atol=QXY_TOL)


@pytest.mark.parametrize("name,factor", [("interval40", "diagonal"),
                                         ("hierarchical50", "lower")])
def test_plain_nuts_tree_matches_pallas(name, factor):
    c, depth = 12, 3
    t_model, j_model, rng, x, chol, chol_inv, betas, structure = _setup(name, c, 1, factor)
    d = t_model.ndim
    f32 = np.float32
    eps0 = {"interval40": 0.25, "hierarchical50": 0.08}[name]
    inp = dict(
        q0=np.einsum("ki,tkc->tic", chol_inv, x).astype(f32),
        r0=rng.normal(size=(T, d, c)).astype(f32), beta=betas,
        eps=(eps0 * 1.5 ** np.arange(T)[:, None] * np.ones((T, c))).astype(f32),
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
        structure=structure)
    tq, tl0, tlp, ta, tn, talive, _ = (a.numpy() for a in tout)
    jl0, jlp, ja, jn, jalive = (np.asarray(a).reshape(T, c) for a in jout[1:])
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(talive, jalive)
    np.testing.assert_allclose(tq, _tdc(jout[0], c), rtol=Q_TOL, atol=Q_TOL)
    for got, want in ((tl0, jl0), (tlp, jlp)):
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=LOGP_TOL, atol=LOGP_TOL)
    np.testing.assert_allclose(ta, ja, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,factor", [("interval40", "diagonal"),
                                         ("correlated20", "lower")])
def test_plain_hmc_matches_pallas(name, factor):
    """The trajectory entry against the interpreted Pallas kernel, and the
    fused step's plain version against the same trajectory mapped back."""
    c, nmin, nmax, eps = 16, 2, 12, 0.08
    t_model, j_model, rng, x, chol, chol_inv, betas, structure = _setup(name, c, 2, factor)
    d = t_model.ndim
    q0 = common.matvec(torch.tensor(chol_inv).T, torch.tensor(x), structure).numpy()
    p0 = rng.normal(size=(T, d, c)).astype(np.float32)
    nsteps = rng.integers(nmin, nmax, size=(T, c)).astype(np.int32)
    jq, jqxy = fused_hmc_trajectories(
        _rows(q0), _rows(p0), jnp.asarray(np.repeat(betas, c)), jnp.asarray(nsteps.reshape(-1)),
        jnp.asarray(chol), func_grad=_func_grad(j_model), ndim=d, eps=eps, nmax_steps=nmax - 1,
        interpret=True,
    )
    tq, tqxy = hmc_trajectories_plain(torch.tensor(q0), torch.tensor(p0), torch.tensor(betas),
                                      torch.tensor(nsteps), torch.tensor(chol), eps, t_model,
                                      structure)
    jqxy = np.asarray(jqxy).reshape(T, c)
    np.testing.assert_array_equal(np.isneginf(tqxy.numpy()), np.isneginf(jqxy))
    fin = np.isfinite(jqxy)
    np.testing.assert_allclose(tqxy.numpy()[fin], jqxy[fin], rtol=QXY_TOL, atol=QXY_TOL)
    np.testing.assert_allclose(tq.numpy(), _tdc(jq, c), rtol=Q_TOL, atol=Q_TOL)
    x1, qxy = hmc_step_plain(torch.tensor(x), torch.tensor(betas),
                             (torch.tensor(p0), torch.tensor(nsteps)), torch.tensor(chol),
                             torch.tensor(chol_inv), eps, nmin, nmax, t_model, structure)
    assert torch.equal(qxy, tqxy)
    assert torch.equal(x1, common.matvec(torch.tensor(chol).T, tq, structure))


# ---- a non-finite trajectory ----

def test_non_finite_trajectory_gives_alpha_zero_in_both_packages():
    """Rung 1 at a step size of 1000 drives the 40-D interval model's
    trajectories past exp's overflow (NaN gradients) or far into its tails.
    Both packages give qxy = -inf on the non-finite ones (the proposal is
    rejected) and alpha = 0 on the rung (read from the JAX package's
    dual-averaging update), the port under the identity factor's
    "diagonal" tag, the JAX package with its dense products."""
    c, max_steps, it, d = 12, 4, 5, 40
    t_model, j_model = tm.IntervalTransformedGaussian(), jm.IntervalTransformedGaussian()
    rng = np.random.default_rng(6)
    x = (-2.5 + 0.5 * rng.normal(size=(T, d, c))).astype(np.float32)
    betas = np.array([1.0, 0.3], np.float32)
    eye = np.eye(d, dtype=np.float32)
    kw = dict(ndim=d, ntemps=T, nchains=c, groups=(tuple(range(d)),), burn=100,
              hmc_stepsize=0.02, chees_max_steps=max_steps)
    jc = dataclasses.replace(j_config.SamplerConfig(
        jumps=j_config.build_default_jumps(CHEESweight=1, have_grads=True), **kw),
        use_pallas=False)
    tc = t_config.SamplerConfig(jumps=t_config.build_default_jumps(CHEESweight=1, have_grads=True),
                                **kw)
    vals = dict(chees_eps=(0.02, 1000.0), chees_epsbar=(0.02, 1000.0), chees_hbar=(0.01, 0.01),
                chees_mu=(np.log(0.2), np.log(0.2)), chees_count=(3.0, 3.0),
                chees_m=(0.1, 0.1), chees_v=(0.02, 0.02), chees_tlen=(0.2, 3000.0))
    ss = {k: np.repeat(np.array(v, np.float32)[:, None], c, axis=1) for k, v in vals.items()}
    jctx = JCtx(group_u=None, group_s=None, chol=jnp.asarray(eye), chol_inv=jnp.asarray(eye),
                de_buf=None, de_valid=None)
    tctx = TCtx(group_u=None, group_s=None, chol=torch.tensor(eye), chol_inv=torch.tensor(eye),
                de_buf=None, de_valid=0, structure="diagonal")
    keys = split_grid(jax.random.key(8), (T, c))
    jq, jqxy, jss = j_chees.make_chees(jc, _func_grad(j_model))(
        keys, jnp.asarray(x), jnp.asarray(betas), it, jctx,
        {k: jnp.asarray(v) for k, v in ss.items()})
    ks = jax.vmap(jax.vmap(lambda k: jax.random.split(k, 4)))(keys)
    u = np.asarray(jax.vmap(jax.vmap(
        lambda k: jax.random.uniform(k, (), dtype=jnp.float32, minval=1e-3, maxval=1.0)
    ))(ks[:, :, 1]))
    r0 = np.asarray(jax.vmap(jax.vmap(lambda k: jax.random.normal(k, (d,), dtype=jnp.float32),
                                      out_axes=-1))(ks[:, :, 0]))
    tss_in = {k: torch.tensor(v) for k, v in ss.items()}
    _, tqxy, tss = t_chees.make_chees(tc, t_model).core(
        torch.tensor(x), torch.tensor(betas), it, tctx, tss_in, torch.tensor(r0), torch.tensor(u))
    x1, _, z1, _, qxy, alpha = chees_step_plain(
        torch.tensor(x), torch.tensor(r0), torch.tensor(u), torch.tensor(betas),
        tss_in["chees_eps"], tss_in["chees_tlen"], 0.02, max_steps, torch.tensor(eye),
        torch.tensor(eye), t_model, "diagonal")
    bad = ~torch.isfinite(z1[1]).all(dim=0)  # trajectories driven non-finite
    assert int(bad.sum()) >= 3
    assert torch.equal(alpha[1], torch.zeros(c))  # the rest underflow to 0 too
    jqxy = np.asarray(jqxy)
    assert np.isneginf(jqxy[1][bad.numpy()]).all() and torch.isneginf(tqxy[1][bad]).all()
    np.testing.assert_array_equal(np.isneginf(jqxy), torch.isneginf(tqxy).numpy())
    assert torch.equal(qxy, tqxy)
    # hbar' = (1 - eta) hbar + eta (delta - mean alpha), eta = 1 / (count + 1 + t0).
    eta = 1.0 / (vals["chees_count"][1] + 1.0 + t_chees.T0)
    for hbar in (np.asarray(jss["chees_hbar"])[1, 0], float(tss["chees_hbar"][1, 0])):
        mean_alpha = tc.chees_delta - (hbar - (1.0 - eta) * 0.01) / eta
        assert abs(mean_alpha) < 1e-4
    np.testing.assert_allclose(tss["chees_hbar"].numpy(), np.asarray(jss["chees_hbar"]),
                               rtol=SS_RTOL, atol=SS_ATOL)


# ---- the checkpoint ----

def _wide_configs(d, c):
    kw = dict(ndim=d, ntemps=T, nchains=c, groups=(tuple(range(d)),), tskip=5, cov_update=5,
              burn=20, thin=1, de_size=32, hmc_stepsize=0.05, chees_max_steps=4,
              mass_adapt=True)
    jumps = dict(SCAMweight=10, CHEESweight=20, burn=20, have_grads=True)
    return (t_config.SamplerConfig(jumps=t_config.build_default_jumps(**jumps), **kw),
            j_config.SamplerConfig(jumps=j_config.build_default_jumps(**jumps), **kw))


def test_tag_stays_out_of_the_checkpoint_and_a_jax_checkpoint_resumes(tmp_path):
    """A JAX checkpoint of an 8-D interval model at the identity factor
    loads in the port with the tag recomputed ("diagonal"); the port resumes
    from it through mass-adapting refreshes (the tag widens to "dense"),
    and its own export holds exactly the checkpoint's paths, no tag."""
    d, c = 8, 8
    tcfg, jcfg = _wide_configs(d, c)
    t_model = tm.IntervalTransformedGaussian(ndim=d)
    x0 = np.full(d, -2.5)
    xs = np.broadcast_to(x0[:, None], (d, c))[None].repeat(T, axis=0)
    ll0 = t_model.lnlike(torch.tensor(xs, dtype=torch.float32)).numpy()
    jstate = j_init_state(jcfg, jax.random.key(0), x0, np.eye(d), np.array([1.0, 0.5]),
                          ll0, np.zeros((T, c)))
    path = str(tmp_path / "checkpoint.npz")
    j_save_checkpoint(path, jstate, {"iter": 0})
    state, _, _ = load_checkpoint(path, tcfg, "cpu", seed=3)
    assert state.adapt.structure == "diagonal"
    assert state.adapt.structure == common.factor_structure(state.adapt.chol,
                                                            state.adapt.chol_inv)
    step, _ = build_step(tcfg, t_model, device="cpu")
    chees = [j.kind for j in tcfg.jumps].index(t_config.KIND_CHEES)
    for _ in range(6):
        state = step(state, chees)
    assert state.adapt.structure == "dense"
    common.check_structure("resumed", state.adapt.structure, state.adapt.chol,
                           state.adapt.chol_inv)
    assert torch.isfinite(state.x).all()
    arrays = state_to_numpy(state)
    assert set(arrays) == set(state_shapes(tcfg))
    assert not any("structure" in k for k in arrays)
