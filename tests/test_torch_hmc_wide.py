"""PyTorch port vs the JAX package: the HMC trajectories and the fused HMC
step (plain versions of the wide CUDA kernel's entries) on the wide models.

At 40-D (interval-transformed Gaussian), 50-D (hierarchical) and a 20-D
correlated Gaussian (one start outside its box), ``hmc_trajectories_plain``
is held to the Pallas kernel run by the interpreter
(``fused_hmc_trajectories(interpret=True)``), and ``hmc_step_plain`` to the
JAX ``gradient.make_hmc`` fed the same momenta and lengths, replayed from
its key splits (gradient.py:106-113), at the path's step size 0.08 and at
5.0, where most trajectories leave the posterior's bulk. Tolerances are
test_torch_hmc.py's (Q_TOL, QXY_TOL): f32 sums over D are ordered
differently in XLA and in the port. The 200-D model's step is held to the
JAX ``make_hmc`` too, at 0.08.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptmcmcsampler_torch import models as tm
from ptmcmcsampler_torch.ops.hmc import hmc_step_plain, hmc_trajectories_plain
from ptmcmcsampler_tpu import config as j_config
from ptmcmcsampler_tpu import models as jm
from ptmcmcsampler_tpu.ops.hmc_pallas import fused_hmc_trajectories
from ptmcmcsampler_tpu.proposals import gradient as j_gradient
from ptmcmcsampler_tpu.proposals.base import ProposalContext as JCtx
from ptmcmcsampler_tpu.utils import split_grid

torch.set_num_threads(2)

Q_TOL, QXY_TOL = 2e-4, 2e-3
NMIN, NMAX = 2, 12
T = 2

MODELS = {
    "interval40": (lambda: tm.IntervalTransformedGaussian(),
                   lambda: jm.IntervalTransformedGaussian()),
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


def _setup(name, c, seed):
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
    x = (centre[None, :, None] + scale * rng.normal(size=(T, d, c))).astype(np.float32)
    if name.startswith("correlated"):
        x = x.clip(0.05, 9.95)  # inside the closed box [0, 10] ...
        x[0, 0, 3] = -0.5  # ... but for this one
    a = rng.normal(size=(d, d)) / d
    chol = np.linalg.cholesky(0.05 * np.eye(d) + 0.05 * a @ a.T).astype(np.float32)
    betas = np.array([1.0, 0.3], np.float32)
    return t_model, j_model, rng, x, chol, betas


def _flat(a):  # [T, D, C] -> [T*C, D]
    return jnp.asarray(np.moveaxis(a, 1, 2).reshape(-1, a.shape[1]))


def _assert_close(tq, tqxy, jq, jqxy):
    np.testing.assert_array_equal(np.isneginf(tqxy), np.isneginf(jqxy))
    fin = np.isfinite(jqxy)
    np.testing.assert_allclose(tqxy[fin], jqxy[fin], rtol=QXY_TOL, atol=QXY_TOL)
    np.testing.assert_allclose(tq, jq, rtol=Q_TOL, atol=Q_TOL)


@pytest.mark.parametrize("eps", [0.08, 5.0])
@pytest.mark.parametrize("name", ["interval40", "hierarchical50", "correlated20"])
def test_plain_trajectories_match_pallas_interpreted(name, eps):
    c = 16
    t_model, j_model, rng, x, chol, betas = _setup(name, c, 0)
    d = t_model.ndim
    q0 = np.einsum("ki,tkc->tic", np.linalg.inv(chol).astype(np.float32), x).astype(np.float32)
    p0 = rng.normal(size=(T, d, c)).astype(np.float32)
    nsteps = rng.integers(NMIN, NMAX, size=(T, c)).astype(np.int32)
    jq, jqxy = fused_hmc_trajectories(
        _flat(q0), _flat(p0), jnp.asarray(np.repeat(betas, c)), jnp.asarray(nsteps.reshape(-1)),
        jnp.asarray(chol), func_grad=_func_grad(j_model), ndim=d, eps=eps, nmax_steps=NMAX - 1,
        interpret=True,
    )
    tq, tqxy = hmc_trajectories_plain(
        torch.tensor(q0), torch.tensor(p0), torch.tensor(betas), torch.tensor(nsteps),
        torch.tensor(chol), eps, t_model,
    )
    assert tq.shape == (T, d, c) and tqxy.shape == (T, c)
    _assert_close(tq.numpy(), tqxy.numpy(), np.moveaxis(np.asarray(jq).reshape(T, c, d), 2, 1),
                  np.asarray(jqxy).reshape(T, c))
    if name.startswith("correlated"):
        assert np.isneginf(tqxy.numpy()[0, 3])  # the start outside the box is rejected


@pytest.mark.parametrize("name,eps", [("interval40", 0.08), ("interval40", 5.0),
                                      ("hierarchical50", 0.08), ("hierarchical50", 5.0),
                                      ("correlated20", 0.08), ("correlated200", 0.08)])
def test_hmc_step_plain_matches_make_hmc(name, eps):
    """The fused step's plain version (whitening, the trajectory on the JAX
    draws, back-mapping) against the JAX ``make_hmc`` under per-chain key
    splits."""
    c = 8 if name == "correlated200" else 12
    t_model, j_model, _, x, chol, betas = _setup(name, c, 1)
    d = t_model.ndim
    chol_inv = np.linalg.inv(chol).astype(np.float32)
    jc = j_config.SamplerConfig(
        jumps=j_config.build_default_jumps(HMCweight=1, have_grads=True), ndim=d, ntemps=T,
        nchains=c, groups=(tuple(range(d)),), hmc_stepsize=eps, hmc_nminsteps=NMIN,
        hmc_nmaxsteps=NMAX)
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
    nsteps = jax.vmap(jax.vmap(lambda k: jax.random.randint(k, (), NMIN, NMAX)))(ks[:, :, 1])
    draws = (torch.tensor(np.asarray(p0)), torch.tensor(np.asarray(nsteps, np.int32)))
    tq, tqxy = hmc_step_plain(torch.tensor(x), torch.tensor(betas), draws, torch.tensor(chol),
                              torch.tensor(chol_inv), eps, NMIN, NMAX, t_model)
    _assert_close(tq.numpy(), tqxy.numpy(), np.asarray(jq), np.asarray(jqxy))
    if name.startswith("correlated"):
        assert np.isneginf(tqxy.numpy()[0, 3])
