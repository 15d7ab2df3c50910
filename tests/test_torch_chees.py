"""PyTorch port vs the JAX package: the ChEES trajectory (plain version of
the CUDA kernel) and the ChEES proposal with adaptation.

The plain trajectory is held to the Pallas kernel run by the interpreter
(``fused_chees_trajectories(interpret=True)``), and ``make_chees``'s core to
the JAX ``make_chees(use_pallas=False)`` fed the same momenta and jitter,
replayed from its key splits (chees.py:74-103). Tolerances are those of
tests/test_pallas_ops.py:129-137: the banana's leapfrog amplifies f32 ulp
differences between XLA and PyTorch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptmcmcsampler_torch import config as t_config
from ptmcmcsampler_torch.models import CurvedLikelihood as TCurved
from ptmcmcsampler_torch.ops.chees import (
    chees_step, chees_step_plain, chees_trajectories, lane_efficiency,
)
from ptmcmcsampler_torch.proposals import chees as t_chees
from ptmcmcsampler_torch.proposals.base import ProposalContext as TCtx
from ptmcmcsampler_tpu import config as j_config
from ptmcmcsampler_tpu.models import CurvedLikelihood as JCurved
from ptmcmcsampler_tpu.ops.chees_pallas import fused_chees_trajectories
from ptmcmcsampler_tpu.proposals import chees as j_chees
from ptmcmcsampler_tpu.proposals import gradient as j_gradient
from ptmcmcsampler_tpu.proposals.base import ProposalContext as JCtx
from ptmcmcsampler_tpu.utils import split_grid

torch.set_num_threads(2)

T, C, D, MAX_STEPS = 2, 9, 2, 32
Q_TOL, QXY_TOL = 2e-4, 2e-3
SS_RTOL, SS_ATOL = 2e-3, 2e-4


def _func_grad(x, beta):
    m = JCurved()
    ll, gll = m.lnlikefn_grad(x)
    lp, glp = m.lnpriorfn_grad(x)
    return beta * ll + lp, beta * gll + glp


def _setup(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(0.0, 0.3, (T, D, C)) + np.array([0.0, -1.0])[None, :, None]).astype(np.float32)
    x[0, :, 3] = [12.0, 0.5]  # starts outside the prior box
    cov = np.array([[0.25, 0.05], [0.05, 0.2]])
    chol = np.linalg.cholesky(cov).astype(np.float32)
    chol_inv = np.linalg.inv(chol).astype(np.float32)
    betas = np.array([1.0, 0.3], np.float32)
    jctx = JCtx(group_u=None, group_s=None, chol=jnp.asarray(chol), chol_inv=jnp.asarray(chol_inv),
                de_buf=None, de_valid=None)
    tctx = TCtx(group_u=None, group_s=None, chol=torch.tensor(chol),
                chol_inv=torch.tensor(chol_inv), de_buf=None, de_valid=0)
    return rng, x, betas, chol, jctx, tctx


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_trajectory_matches_pallas_interpreted(seed):
    rng, x, betas, chol, jctx, tctx = _setup(seed)
    q0 = np.einsum("ki,tkc->tic", np.linalg.inv(chol).astype(np.float32), x).astype(np.float32)
    p0 = rng.normal(size=(T, D, C)).astype(np.float32)
    eps = np.repeat(np.array([[0.05], [0.12]], np.float32), C, axis=1)
    nsteps = rng.integers(1, MAX_STEPS + 1, size=(T, C)).astype(np.int32)
    nsteps[0, 3] = MAX_STEPS

    def flat(a):  # [T, D, C] -> [T*C, D]
        return jnp.asarray(np.moveaxis(a, 1, 2).reshape(T * C, D))

    jq, jp, jl = fused_chees_trajectories(
        flat(q0), flat(p0), jnp.asarray(np.repeat(betas, C)), jnp.asarray(eps.reshape(-1)),
        jnp.asarray(nsteps.reshape(-1)), jnp.asarray(chol), func_grad=_func_grad, ndim=D,
        max_steps=MAX_STEPS, interpret=True,
    )
    tq, tp, tl = chees_trajectories(
        torch.tensor(q0), torch.tensor(p0), torch.tensor(betas), torch.tensor(eps),
        torch.tensor(nsteps), torch.tensor(chol), TCurved(),
    )
    assert tq.shape == (T, D, C) and tl.shape == (T, C)
    jq = np.moveaxis(np.asarray(jq).reshape(T, C, D), 2, 1)
    jp = np.moveaxis(np.asarray(jp).reshape(T, C, D), 2, 1)
    jl = np.asarray(jl).reshape(T, C)
    np.testing.assert_allclose(tq.numpy(), jq, rtol=Q_TOL, atol=Q_TOL)
    np.testing.assert_allclose(tp.numpy(), jp, rtol=Q_TOL, atol=Q_TOL)
    np.testing.assert_array_equal(np.isneginf(tl.numpy()), np.isneginf(jl))
    assert np.isneginf(tl.numpy()[0, 3])  # the chain outside the box stays at -inf
    fin = np.isfinite(jl)
    np.testing.assert_allclose(tl.numpy()[fin], jl[fin], rtol=QXY_TOL, atol=QXY_TOL)


def _jax_draws(keys):
    """r0 [T, D, C] and u [T, C] as make_chees draws them (chees.py:74-103)."""
    ks = jax.vmap(jax.vmap(lambda k: jax.random.split(k, 4)))(keys)
    u = jax.vmap(jax.vmap(
        lambda k: jax.random.uniform(k, (), dtype=jnp.float32, minval=1e-3, maxval=1.0)
    ))(ks[:, :, 1])
    r0 = jax.vmap(jax.vmap(lambda k: jax.random.normal(k, (D,), dtype=jnp.float32),
                           out_axes=-1))(ks[:, :, 0])
    return np.asarray(r0), np.asarray(u)


def _ss(first_call):
    vals = dict(chees_eps=0.05, chees_epsbar=0.05, chees_hbar=0.01, chees_mu=np.log(0.5),
                chees_count=3.0, chees_m=0.1, chees_v=0.02, chees_tlen=0.4)
    if first_call:
        vals.update(chees_eps=0.0, chees_epsbar=0.0, chees_hbar=0.0, chees_mu=0.0,
                    chees_count=0.0, chees_m=0.0, chees_v=0.0, chees_tlen=0.08)
    return {k: np.full((T, C), v, np.float32) for k, v in vals.items()}


@pytest.mark.parametrize("it,first_call", [(5, True), (5, False), (200, False)])
def test_chees_core_matches_make_chees(it, first_call):
    """In burn-in (adaptation moving) and after it (frozen), from the first
    call (the chees_mu == 0 sentinel) and from adapted state."""
    _, x, betas, chol, jctx, tctx = _setup(2)
    kw = dict(ndim=D, ntemps=T, nchains=C, groups=((0, 1),), burn=100, hmc_stepsize=0.08,
              chees_max_steps=MAX_STEPS)
    jc = j_config.SamplerConfig(jumps=j_config.build_default_jumps(CHEESweight=1, have_grads=True),
                                **kw)
    tc = t_config.SamplerConfig(jumps=t_config.build_default_jumps(CHEESweight=1, have_grads=True),
                                **kw)
    jc = dataclasses.replace(jc, use_pallas=False)
    keys = split_grid(jax.random.key(11), (T, C))
    ss = _ss(first_call)
    jq, jqxy, jss = j_chees.make_chees(jc, _func_grad)(
        keys, jnp.asarray(x), jnp.asarray(betas), it, jctx, {k: jnp.asarray(v) for k, v in ss.items()}
    )
    r0, u = _jax_draws(keys)
    tq, tqxy, tss = t_chees.make_chees(tc, TCurved()).core(
        torch.tensor(x), torch.tensor(betas), it, tctx,
        {k: torch.tensor(v) for k, v in ss.items()}, torch.tensor(r0), torch.tensor(u),
    )
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=Q_TOL, atol=Q_TOL)
    jqxy = np.asarray(jqxy)
    np.testing.assert_array_equal(np.isneginf(tqxy.numpy()), np.isneginf(jqxy))
    fin = np.isfinite(jqxy)
    np.testing.assert_allclose(tqxy.numpy()[fin], jqxy[fin], rtol=QXY_TOL, atol=QXY_TOL)
    for k in ss:
        np.testing.assert_allclose(tss[k].numpy(), np.asarray(jss[k]), rtol=SS_RTOL,
                                   atol=SS_ATOL, err_msg=k)
    if it > 100:  # frozen after burn-in
        np.testing.assert_array_equal(tss["chees_count"].numpy(), ss["chees_count"])


EPS0 = 0.08


def _step_inputs(seed, start=(0.2, -0.8)):
    """x, r0, u and the step-size state of a fused step: rung 0 at its first
    call (eps 0, so eps0 is used), rung 1 with a length below its step
    size (so tlen = eps). Chain (0, 3) starts at ``start``."""
    rng, x, betas, chol, jctx, tctx = _setup(seed)
    x[0, :, 3] = start
    r0 = rng.normal(size=(T, D, C)).astype(np.float32)
    u = rng.uniform(1e-3, 1.0, size=(T, C)).astype(np.float32)
    eps = np.repeat(np.array([[0.0], [0.12]], np.float32), C, axis=1)
    tlen = np.repeat(np.array([[1.3], [0.05]], np.float32), C, axis=1)
    return x, r0, u, betas, eps, tlen, chol, jctx, tctx


def _jax_step(x, r0, u, betas, eps, tlen, jctx):
    """The JAX package's pieces of make_chees around its Pallas kernel
    (chees.py:80-166, :235), run interpreted."""
    forward, backward, fgw = j_gradient.make_whitened_funcs(_func_grad)
    eps_tc = jnp.where(eps > 0, eps, EPS0)
    tlen_tc = jnp.maximum(tlen, eps_tc)
    nsteps = jnp.clip(jnp.ceil(u * tlen_tc / eps_tc), 1, MAX_STEPS).astype(jnp.int32)
    q0 = jax.vmap(jax.vmap(lambda xx: forward(jctx, xx), in_axes=-1, out_axes=-1))(x)
    fgw_b = jax.vmap(jax.vmap(lambda qq, b: fgw(jctx, qq, b), in_axes=(-1, None),
                              out_axes=(0, -1)), in_axes=(0, 0))
    logp0, _ = fgw_b(q0, betas)
    n = T * C
    z1f, r1f, logp1f = fused_chees_trajectories(
        jnp.moveaxis(q0, 1, 2).reshape(n, D), jnp.moveaxis(r0, 1, 2).reshape(n, D),
        jnp.repeat(betas, C), eps_tc.reshape(n), nsteps.reshape(n), jctx.chol,
        func_grad=_func_grad, ndim=D, max_steps=MAX_STEPS, interpret=True,
    )
    z1 = jnp.moveaxis(z1f.reshape(T, C, D), 1, 2)
    r1 = jnp.moveaxis(r1f.reshape(T, C, D), 1, 2)
    k0 = 0.5 * jnp.sum(r0 * r0, axis=1)
    k1 = 0.5 * jnp.sum(r1 * r1, axis=1)
    denergy = (logp1f.reshape(T, C) - k1) - (logp0 - k0)
    denergy = jnp.where(jnp.isnan(denergy), -jnp.inf, denergy)
    qxy = jnp.where(jnp.isnan(k0 - k1), -jnp.inf, k0 - k1)
    alpha = jnp.minimum(1.0, jnp.exp(denergy))
    x1 = jax.vmap(jax.vmap(lambda zz: backward(jctx, zz), in_axes=-1, out_axes=-1))(z1)
    return [np.asarray(a) for a in (x1, q0, z1, r1, qxy, alpha)]


@pytest.mark.parametrize("seed,start,alpha_out", [
    (0, (0.2, -0.8), None), (1, (0.2, -0.8), None),
    (0, (30.0, 0.5), 0.0),  # starts and ends outside the box: dH NaN -> -inf
    (0, (12.0, 0.5), 1.0),  # starts outside, ends inside: dH = +inf
])
def test_chees_step_plain_matches_jax_pieces(seed, start, alpha_out):
    """The fused step's plain version against forward, fgw, the interpreted
    Pallas trajectory, the qxy/alpha formulas and backward of the JAX
    package; chain (0, 3) starts inside the prior box or outside it
    (``alpha_out``: its acceptance probability)."""
    x, r0, u, betas, eps, tlen, chol, jctx, tctx = _step_inputs(seed, start)
    want = _jax_step(jnp.asarray(x), jnp.asarray(r0), jnp.asarray(u), jnp.asarray(betas),
                     jnp.asarray(eps), jnp.asarray(tlen), jctx)
    got = chees_step(
        torch.tensor(x), torch.tensor(r0), torch.tensor(u), torch.tensor(betas),
        torch.tensor(eps), torch.tensor(tlen), EPS0, MAX_STEPS, tctx.chol, tctx.chol_inv, TCurved(),
    )
    got = [g.numpy() for g in got]
    for name, g, w in zip(("x1", "q0", "z1", "r1"), got[:4], want[:4]):
        assert g.shape == (T, D, C)
        np.testing.assert_allclose(g, w, rtol=Q_TOL, atol=Q_TOL, err_msg=name)
    for name, g, w in zip(("qxy", "alpha"), got[4:], want[4:]):
        assert g.shape == (T, C)
        np.testing.assert_array_equal(np.isneginf(g), np.isneginf(w), err_msg=name)
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=QXY_TOL, atol=QXY_TOL, err_msg=name)
    alpha = got[5]
    assert ((alpha >= 0) & (alpha <= 1)).all()
    if alpha_out is None:
        assert (alpha > 0).all()
    else:  # logp0 = -inf; qxy depends on the momenta alone
        assert alpha[0, 3] == alpha_out and np.isfinite(got[4][0, 3])


def test_chees_step_plain_is_the_trajectory_entry_inside():
    """The fused step's plain version runs the trajectory entry's plain
    version from q0 = chol_inv^T x at its own nsteps."""
    x, r0, u, betas, eps, tlen, chol, _, tctx = _step_inputs(3)
    args = [torch.tensor(a) for a in (x, r0, u, betas, eps, tlen)]
    x1, q0, z1, r1, _, _ = chees_step_plain(*args, EPS0, MAX_STEPS, tctx.chol, tctx.chol_inv,
                                            TCurved())
    eps_tc = torch.where(args[4] > 0, args[4], EPS0)
    tlen_tc = torch.maximum(args[5], eps_tc)
    nsteps = torch.clamp(torch.ceil(args[2] * tlen_tc / eps_tc), 1, MAX_STEPS).to(torch.int32)
    assert int(nsteps[1].max()) == 1 and int(nsteps[0].max()) > 1  # tlen < eps: one step
    zt, rt, _ = chees_trajectories(q0, args[1], args[3], eps_tc, nsteps, tctx.chol, TCurved())
    assert torch.equal(z1, zt) and torch.equal(r1, rt)
    torch.testing.assert_close(q0, tctx.chol_inv.T @ args[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(x1, tctx.chol.T @ z1, rtol=1e-6, atol=1e-6)


def test_make_chees_core_goes_through_chees_step(monkeypatch):
    """``make_chees(...).core`` computes its per-chain part in one
    ``chees_step`` call and never calls the trajectory entry."""
    calls = []

    def counting(*args):
        calls.append(args)
        return chees_step(*args)

    def refuse(*args):
        raise AssertionError("core called chees_trajectories")

    monkeypatch.setattr(t_chees, "chees_step", counting)
    monkeypatch.setattr("ptmcmcsampler_torch.ops.chees.chees_trajectories", refuse)
    x, r0, u, betas, _, _, _, _, tctx = _step_inputs(4, (30.0, 0.5))
    tc = t_config.SamplerConfig(
        ndim=D, ntemps=T, nchains=C, groups=((0, 1),), burn=100, hmc_stepsize=EPS0,
        chees_max_steps=MAX_STEPS,
        jumps=t_config.build_default_jumps(CHEESweight=1, have_grads=True))
    ss = {k: torch.tensor(v) for k, v in _ss(False).items()}
    q, qxy, _ = t_chees.make_chees(tc, TCurved()).core(
        torch.tensor(x), torch.tensor(betas), 5, tctx, ss, torch.tensor(r0), torch.tensor(u))
    assert len(calls) == 1
    want = chees_step(*calls[0])
    assert torch.equal(q, want[0]) and torch.equal(qxy, want[4])


@pytest.mark.parametrize("grouped,want", [(False, 528 * 8 / (32 * 8 * 32)),
                                          (True, 528 * 8 / (32 * 144))])
def test_lane_efficiency_of_one_block(grouped, want):
    """One block whose every warp holds the lengths 1..32: unsorted each warp
    issues 32 steps; sorted, warp w holds 4w+1..4w+4."""
    nsteps = (torch.arange(256) % 32 + 1).view(2, 128)
    assert lane_efficiency(nsteps, grouped) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("grouped", [False, True])
def test_lane_efficiency_of_a_ragged_batch(grouped):
    """300 chains of 5 steps: the last block's 212 padding lanes cost
    nothing, sorted (padding first) or not (padding last)."""
    nsteps = torch.full((3, 100), 5, dtype=torch.int32)
    assert lane_efficiency(nsteps, grouped) == pytest.approx(1500 / (32 * 5 * 10), rel=1e-12)
