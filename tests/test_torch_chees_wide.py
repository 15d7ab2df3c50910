"""PyTorch port vs the JAX package: the ChEES trajectory's plain version (the
wide kernel's counterpart on the CPU) on the wide models.

At 40-D (interval-transformed Gaussian), 50-D (hierarchical) and a 20-D
correlated Gaussian, ``chees_trajectories_plain`` is held to the Pallas
kernel run by the interpreter (``fused_chees_trajectories(interpret=True)``)
with a few dozen chains and at most 8 steps. At 200-D (the bench's
``gaussian200``) the port's ``make_chees`` core is held to the JAX
package's XLA leapfrog (``make_chees(use_pallas=False)``) fed the same
momenta and jitter. Tolerances are test_torch_chees.py's: f32 sums over D
are ordered differently in XLA and in the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptmcmcsampler_torch import config as t_config
from ptmcmcsampler_torch import models as tm
from ptmcmcsampler_torch.ops.chees import chees_step, chees_trajectories_plain
from ptmcmcsampler_torch.proposals import chees as t_chees
from ptmcmcsampler_torch.proposals.base import ProposalContext as TCtx
from ptmcmcsampler_tpu import config as j_config
from ptmcmcsampler_tpu import models as jm
from ptmcmcsampler_tpu.ops.chees_pallas import fused_chees_trajectories
from ptmcmcsampler_tpu.proposals import chees as j_chees
from ptmcmcsampler_tpu.proposals.base import ProposalContext as JCtx
from ptmcmcsampler_tpu.utils import split_grid

torch.set_num_threads(2)

Q_TOL, QXY_TOL = 2e-4, 2e-3
SS_RTOL, SS_ATOL = 2e-3, 2e-4

MODELS = {
    "interval40": (lambda: tm.IntervalTransformedGaussian(), lambda: jm.IntervalTransformedGaussian()),
    "hierarchical50": (lambda: tm.HierarchicalGaussian(), lambda: jm.HierarchicalGaussian()),
    "correlated20": (lambda: tm.CorrelatedGaussian(), lambda: jm.CorrelatedGaussian()),
    "correlated200": (lambda: tm.CorrelatedGaussian(ndim=200, seed=1),
                      lambda: jm.CorrelatedGaussian(ndim=200, seed=1)),
}


def _func_grad(jmodel):
    def fg(x, beta):
        ll, gll = jmodel.lnlikefn_grad(x)
        lp, glp = jmodel.lnpriorfn_grad(x)
        return beta * ll + lp, beta * gll + glp

    return fg


def _setup(name, t, c, seed):
    """Positions around the posterior (one chain outside the correlated
    model's box), a well-conditioned mass-matrix factor, two rungs."""
    t_model, j_model = (f() for f in MODELS[name])
    rng = np.random.default_rng(seed)
    d = t_model.ndim
    if name.startswith("correlated"):
        centre, scale = t_model.mu, 0.1
    elif name.startswith("interval"):
        centre, scale = np.full(d, -2.5), 0.5
    else:
        centre, scale = t_model.posterior_moments()[0], 0.3
    x = (centre[None, :, None] + scale * rng.normal(size=(t, d, c))).astype(np.float32)
    if name.startswith("correlated"):
        x[0, 0, 3] = -0.5
    a = rng.normal(size=(d, d)) / d
    chol = np.linalg.cholesky(0.05 * np.eye(d) + 0.05 * a @ a.T).astype(np.float32)
    betas = np.array([1.0, 0.3], np.float32)
    return t_model, j_model, rng, x, chol, betas


@pytest.mark.parametrize("name", ["interval40", "hierarchical50", "correlated20"])
def test_plain_trajectory_matches_pallas_interpreted(name):
    t, c, max_steps = 2, 24, 8
    t_model, j_model, rng, x, chol, betas = _setup(name, t, c, 0)
    d = t_model.ndim
    q0 = np.einsum("ki,tkc->tic", np.linalg.inv(chol).astype(np.float32), x).astype(np.float32)
    p0 = rng.normal(size=(t, d, c)).astype(np.float32)
    eps = np.repeat(np.array([[0.05], [0.08]], np.float32), c, axis=1)
    nsteps = rng.integers(1, max_steps + 1, size=(t, c)).astype(np.int32)

    def flat(a):  # [T, D, C] -> [T*C, D]
        return jnp.asarray(np.moveaxis(a, 1, 2).reshape(t * c, d))

    jq, jp, jl = fused_chees_trajectories(
        flat(q0), flat(p0), jnp.asarray(np.repeat(betas, c)), jnp.asarray(eps.reshape(-1)),
        jnp.asarray(nsteps.reshape(-1)), jnp.asarray(chol), func_grad=_func_grad(j_model),
        ndim=d, max_steps=max_steps, interpret=True,
    )
    tq, tp, tl = chees_trajectories_plain(
        torch.tensor(q0), torch.tensor(p0), torch.tensor(betas), torch.tensor(eps),
        torch.tensor(nsteps), torch.tensor(chol), t_model,
    )
    jq = np.moveaxis(np.asarray(jq).reshape(t, c, d), 2, 1)
    jp = np.moveaxis(np.asarray(jp).reshape(t, c, d), 2, 1)
    jl = np.asarray(jl).reshape(t, c)
    np.testing.assert_allclose(tq.numpy(), jq, rtol=Q_TOL, atol=Q_TOL)
    np.testing.assert_allclose(tp.numpy(), jp, rtol=Q_TOL, atol=Q_TOL)
    np.testing.assert_array_equal(np.isneginf(tl.numpy()), np.isneginf(jl))
    fin = np.isfinite(jl)
    np.testing.assert_allclose(tl.numpy()[fin], jl[fin], rtol=QXY_TOL, atol=QXY_TOL)
    if name.startswith("correlated"):
        assert np.isneginf(tl.numpy()[0, 3]) or x[0, 0, 3] >= 0  # outside the box: -inf


def _jax_draws(keys, d):
    """r0 [T, D, C] and u [T, C] as make_chees draws them (chees.py:74-103)."""
    ks = jax.vmap(jax.vmap(lambda k: jax.random.split(k, 4)))(keys)
    u = jax.vmap(jax.vmap(
        lambda k: jax.random.uniform(k, (), dtype=jnp.float32, minval=1e-3, maxval=1.0)
    ))(ks[:, :, 1])
    r0 = jax.vmap(jax.vmap(lambda k: jax.random.normal(k, (d,), dtype=jnp.float32),
                           out_axes=-1))(ks[:, :, 0])
    return np.asarray(r0), np.asarray(u)


@pytest.mark.parametrize("name,it", [("correlated200", 5), ("correlated200", 200),
                                     ("hierarchical50", 5)])
def test_chees_core_matches_xla_leapfrog(name, it):
    """The ChEES step at 200-D (and 50-D) against the JAX package's XLA
    while-loop leapfrog, in burn-in and after it."""
    t, c, max_steps = 2, 16, 16
    t_model, j_model, _, x, chol, betas = _setup(name, t, c, 1)
    d = t_model.ndim
    chol_inv = np.linalg.inv(chol).astype(np.float32)
    kw = dict(ndim=d, ntemps=t, nchains=c, groups=(tuple(range(d)),), burn=100,
              hmc_stepsize=0.02, chees_max_steps=max_steps)
    jc = dataclasses.replace(j_config.SamplerConfig(
        jumps=j_config.build_default_jumps(CHEESweight=1, have_grads=True), **kw),
        use_pallas=False)
    tc = t_config.SamplerConfig(jumps=t_config.build_default_jumps(CHEESweight=1, have_grads=True),
                                **kw)
    vals = dict(chees_eps=0.02, chees_epsbar=0.02, chees_hbar=0.01, chees_mu=np.log(0.2),
                chees_count=3.0, chees_m=0.1, chees_v=0.02, chees_tlen=0.2)
    ss = {k: np.full((t, c), v, np.float32) for k, v in vals.items()}
    jctx = JCtx(group_u=None, group_s=None, chol=jnp.asarray(chol), chol_inv=jnp.asarray(chol_inv),
                de_buf=None, de_valid=None)
    tctx = TCtx(group_u=None, group_s=None, chol=torch.tensor(chol),
                chol_inv=torch.tensor(chol_inv), de_buf=None, de_valid=0)
    keys = split_grid(jax.random.key(5), (t, c))
    jq, jqxy, jss = j_chees.make_chees(jc, _func_grad(j_model))(
        keys, jnp.asarray(x), jnp.asarray(betas), it, jctx,
        {k: jnp.asarray(v) for k, v in ss.items()})
    r0, u = _jax_draws(keys, d)
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


@pytest.mark.parametrize("name", ["interval40", "hierarchical50"])
def test_chees_step_plain_is_the_trajectory_entry_inside(name):
    """The wide models' fused step (plain version) runs the trajectory
    entry's plain version from q0 = chol_inv^T x, bit for bit."""
    t, c = 2, 12
    t_model, _, rng, x, chol, betas = _setup(name, t, c, 2)
    d = t_model.ndim
    chol_t = torch.tensor(chol)
    chol_inv = torch.linalg.inv(chol_t).contiguous()
    r0 = torch.tensor(rng.normal(size=(t, d, c)).astype(np.float32))
    u = torch.tensor(rng.uniform(1e-3, 1.0, (t, c)).astype(np.float32))
    eps = torch.full((t, c), 0.05)
    tlen = torch.full((t, c), 0.3)
    x1, q0, z1, r1, _, alpha = chees_step(torch.tensor(x), r0, u, torch.tensor(betas), eps,
                                          tlen, 0.05, 16, chol_t, chol_inv, t_model)
    nsteps = torch.clamp(torch.ceil(u * tlen / eps), 1, 16).to(torch.int32)
    zt, rt, _ = chees_trajectories_plain(q0, r0, torch.tensor(betas), eps, nsteps, chol_t,
                                         t_model)
    assert torch.equal(z1, zt) and torch.equal(r1, rt)
    assert ((alpha >= 0) & (alpha <= 1)).all()
