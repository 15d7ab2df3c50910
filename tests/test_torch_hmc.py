"""PyTorch port vs the JAX package: the HMC trajectories (plain version of
the CUDA kernel) and the HMC proposal.

The plain trajectories are held to the Pallas kernel run by the interpreter
(``fused_hmc_trajectories(interpret=True)``) on the curved model, and
``make_hmc``'s core to the JAX ``gradient.make_hmc`` fed the same momenta and
trajectory lengths, replayed from its key splits (gradient.py:109-116).
Tolerances are those of tests/test_pallas_ops.py:70-71: the banana's
leapfrog amplifies f32 ulp differences between XLA and PyTorch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptmcmcsampler_torch import config as t_config
from ptmcmcsampler_torch.models import CurvedLikelihood as TCurved
from ptmcmcsampler_torch.ops.hmc import hmc_trajectories
from ptmcmcsampler_torch.proposals import gradient as t_gradient
from ptmcmcsampler_torch.proposals.base import ProposalContext as TCtx
from ptmcmcsampler_tpu import config as j_config
from ptmcmcsampler_tpu.models import CurvedLikelihood as JCurved
from ptmcmcsampler_tpu.ops.hmc_pallas import fused_hmc_trajectories
from ptmcmcsampler_tpu.proposals import gradient as j_gradient
from ptmcmcsampler_tpu.proposals.base import ProposalContext as JCtx
from ptmcmcsampler_tpu.utils import split_grid

torch.set_num_threads(2)

T, C, D = 2, 24, 2
Q_TOL, QXY_TOL = 2e-4, 2e-3


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


def _flat(a):  # [T, D, C] -> [T*C, D]
    return jnp.asarray(np.moveaxis(a, 1, 2).reshape(-1, a.shape[1]))


@pytest.mark.parametrize("eps,nmin,nmax", [(0.08, 2, 50), (5.0, 10, 30)])
def test_plain_trajectories_match_pallas_interpreted(eps, nmin, nmax):
    """At the path's settings, and at a huge step size where most lanes
    leave the prior box and are rejected (cf. test_pallas_ops.py:74-90)."""
    rng, x, betas, chol, _, _ = _setup(0)
    q0 = np.einsum("ki,tkc->tic", np.linalg.inv(chol).astype(np.float32), x).astype(np.float32)
    p0 = rng.normal(size=(T, D, C)).astype(np.float32)
    nsteps = rng.integers(nmin, nmax, size=(T, C)).astype(np.int32)
    jq, jqxy = fused_hmc_trajectories(
        _flat(q0), _flat(p0), jnp.asarray(np.repeat(betas, C)), jnp.asarray(nsteps.reshape(-1)),
        jnp.asarray(chol), func_grad=_func_grad, ndim=D, eps=eps, nmax_steps=nmax - 1,
        interpret=True,
    )
    tq, tqxy = hmc_trajectories(
        torch.tensor(q0), torch.tensor(p0), torch.tensor(betas), torch.tensor(nsteps),
        torch.tensor(chol), eps, TCurved(),
    )
    assert tq.shape == (T, D, C) and tqxy.shape == (T, C)
    jq = np.moveaxis(np.asarray(jq).reshape(T, C, D), 2, 1)
    jqxy = np.asarray(jqxy).reshape(T, C)
    np.testing.assert_array_equal(np.isneginf(tqxy.numpy()), np.isneginf(jqxy))
    fin = np.isfinite(jqxy)
    np.testing.assert_allclose(tqxy.numpy()[fin], jqxy[fin], rtol=QXY_TOL, atol=QXY_TOL)
    np.testing.assert_allclose(tq.numpy(), jq, rtol=Q_TOL, atol=Q_TOL)
    if eps > 1.0:
        assert np.mean(~fin) > 0.5  # most first steps left the prior box


def test_hmc_core_matches_make_hmc():
    _, x, betas, _, jctx, tctx = _setup(2)
    kw = dict(ndim=D, ntemps=T, nchains=C, groups=((0, 1),), hmc_stepsize=0.08,
              hmc_nminsteps=2, hmc_nmaxsteps=50)
    jc = j_config.SamplerConfig(jumps=j_config.build_default_jumps(HMCweight=1, have_grads=True),
                                **kw)
    tc = t_config.SamplerConfig(jumps=t_config.build_default_jumps(HMCweight=1, have_grads=True),
                                **kw)
    keys = split_grid(jax.random.key(3), (T, C))
    hmc = j_gradient.make_hmc(jc, _func_grad)
    per_chain = jax.vmap(lambda k, xx, b: hmc(k, xx, b, 0, jctx), in_axes=(0, -1, None),
                         out_axes=(-1, 0))
    jq, jqxy = jax.vmap(per_chain)(keys, jnp.asarray(x), jnp.asarray(betas))

    # The JAX draws, replayed: kp, kn = split(key); p0 = normal(kp, (D,)),
    # nsteps = randint(kn, (), nmin, nmax).
    ks = jax.vmap(jax.vmap(jax.random.split))(keys)
    p0 = jax.vmap(jax.vmap(lambda k: jax.random.normal(k, (D,), dtype=jnp.float32),
                           out_axes=-1))(ks[:, :, 0])
    nsteps = jax.vmap(jax.vmap(lambda k: jax.random.randint(k, (), 2, 50)))(ks[:, :, 1])
    tq, tqxy = t_gradient.make_hmc(tc, TCurved()).core(
        torch.tensor(x), torch.tensor(betas), tctx, torch.tensor(np.asarray(p0)),
        torch.tensor(np.asarray(nsteps, np.int32)),
    )
    jqxy = np.asarray(jqxy)
    np.testing.assert_array_equal(np.isneginf(tqxy.numpy()), np.isneginf(jqxy))
    assert np.isneginf(tqxy.numpy()[0, 3])  # the chain outside the box is rejected
    fin = np.isfinite(jqxy)
    np.testing.assert_allclose(tqxy.numpy()[fin], jqxy[fin], rtol=QXY_TOL, atol=QXY_TOL)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=Q_TOL, atol=Q_TOL)
