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
from ptmcmcsampler_torch.ops.chees import chees_trajectories
from ptmcmcsampler_torch.proposals import chees as t_chees
from ptmcmcsampler_torch.proposals.base import ProposalContext as TCtx
from ptmcmcsampler_tpu import config as j_config
from ptmcmcsampler_tpu.models import CurvedLikelihood as JCurved
from ptmcmcsampler_tpu.ops.chees_pallas import fused_chees_trajectories
from ptmcmcsampler_tpu.proposals import chees as j_chees
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
