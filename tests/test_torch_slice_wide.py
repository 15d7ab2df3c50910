"""The slice end to end on the 50-D hierarchical Gaussian: the port's
``build_step``/``run_block`` against the JAX package's, both on the CPU, on
the bench's headline cycle (SCAM/AM/DE/ChEES at 10/10/10/20) at a small
shape (4 temperatures x 128 chains, chees_max_steps=16, 600 burn-in + 600
measured iterations). Held statistically, as tests/test_torch_slice.py:
both pass the bench's moment gate against the closed-form
``posterior_moments()``, and their cold-chain acceptance per jump kind
agrees within 0.05. Also the port's diagnostics, which the card's gate on
a wide run computes on the device, against the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptmcmcsampler_torch import SamplerConfig as TConfig
from ptmcmcsampler_torch import build_default_jumps as t_jumps
from ptmcmcsampler_torch import build_step as t_build_step
from ptmcmcsampler_torch import diagnostics
from ptmcmcsampler_torch import init_state as t_init_state
from ptmcmcsampler_torch.diagnostics import moment_gate
from ptmcmcsampler_torch.ladder import ladder_betas, temperature_ladder
from ptmcmcsampler_torch.models import HierarchicalGaussian as THier
from ptmcmcsampler_tpu import diagnostics as j_diagnostics
from ptmcmcsampler_tpu.config import SamplerConfig as JConfig
from ptmcmcsampler_tpu.config import build_default_jumps as j_jumps
from ptmcmcsampler_tpu.kernel import build_step as j_build_step
from ptmcmcsampler_tpu.models import HierarchicalGaussian as JHier
from ptmcmcsampler_tpu.state import init_state as j_init_state

torch.set_num_threads(2)

T, C, D = 4, 128, 50
BURN, MEASURED = 600, 600
X0 = np.zeros(D)
ACC_TOL = 0.05


def _config_kwargs():
    burn = BURN // 2
    jumps = dict(SCAMweight=10, AMweight=10, DEweight=10, CHEESweight=20, burn=burn,
                 have_grads=True)
    cfg = dict(ndim=D, ntemps=T, nchains=C, groups=(tuple(range(D)),), tskip=5, cov_update=200,
               burn=burn, thin=1, de_size=1000, hmc_stepsize=0.08, chees_max_steps=16)
    return jumps, cfg


def _betas():
    return ladder_betas(temperature_ladder(D, T))[1]


def _acceptance(accepted, proposed):
    return accepted[:, 0].sum(-1) / np.maximum(proposed[:, 0].sum(-1), 1)


@pytest.fixture(scope="module")
def jax_run():
    jumps, kw = _config_kwargs()
    cfg = JConfig(jumps=j_jumps(**jumps), **kw)
    model = JHier()

    def func_grad(x, beta):
        ll, gll = model.lnlikefn_grad(x)
        lp, glp = model.lnpriorfn_grad(x)
        return beta * ll + lp, beta * gll + glp

    _, run_block = j_build_step(cfg, model.lnlikefn, model.lnpriorfn, func_grad)
    xs = jnp.broadcast_to(jnp.asarray(X0, jnp.float32), (T, C, D))
    state = j_init_state(cfg, jax.random.key(7), X0, np.eye(D), _betas(),
                         jax.vmap(jax.vmap(model.lnlikefn))(xs),
                         jax.vmap(jax.vmap(model.lnpriorfn))(xs))
    state, _ = run_block(state, BURN)
    state, out = run_block(state, MEASURED)
    chains = np.moveaxis(np.asarray(out.x)[:, 0], 2, 0)  # [C, N, D]
    ctr = state.counters
    return chains, _acceptance(np.asarray(ctr.jump_accepted), np.asarray(ctr.jump_proposed))


@pytest.fixture(scope="module")
def port_run():
    jumps, kw = _config_kwargs()
    cfg = TConfig(jumps=t_jumps(**jumps), **kw)
    model = THier()
    _, run_block = t_build_step(cfg, model, device="cpu")
    xs = torch.zeros((T, D, C))
    state = t_init_state(cfg, 7, X0, np.eye(D), _betas(), model.lnlike(xs), model.lnprior(xs),
                         device="cpu")
    state, _ = run_block(state, BURN)
    state, out = run_block(state, MEASURED)
    assert out.x.shape == (MEASURED, T, D, C) and torch.isfinite(out.x).all()
    chains = out.x[:, 0].permute(2, 0, 1).numpy()
    ctr = state.counters
    return chains, _acceptance(ctr.jump_accepted.numpy(), ctr.jump_proposed.numpy())


def test_jax_reference_passes_moment_gate(jax_run):
    ok, max_z, _ = moment_gate(jax_run[0], JHier().posterior_moments()[0])
    assert ok, max_z


def test_port_passes_moment_gate(port_run):
    ok, max_z, _ = moment_gate(port_run[0], THier().posterior_moments()[0])
    assert ok, max_z


def test_port_acceptance_matches_jax(jax_run, port_run):
    names = [j.name for j in TConfig(jumps=t_jumps(**_config_kwargs()[0]),
                                     **_config_kwargs()[1]).jumps]
    for name, a, b in zip(names, port_run[1], jax_run[1]):
        assert abs(a - b) < ACC_TOL, (name, a, b)


@pytest.mark.parametrize("shape", [(7, 300, 3), (1, 50, 2), (5, 3, 4)])
def test_diagnostics_match_jax_package(shape):
    """split R-hat and the cross-chain ESS, on a numpy array and on a torch
    tensor, equal the JAX package's numpy diagnostics to rounding; the
    moment gate equals bench.py's arithmetic on the JAX package's ESS."""
    rng = np.random.default_rng(0)
    x = (np.cumsum(rng.normal(size=shape), axis=1) * 0.1 + rng.normal(size=shape)).astype(
        np.float32)
    target = np.full(shape[2], 0.05)
    ess_ref = j_diagnostics.multichain_ess(x)
    flat = x.reshape(-1, shape[2])
    mean, sd = flat.mean(axis=0, dtype=np.float64), flat.std(axis=0, dtype=np.float64)
    se = np.maximum(sd / np.sqrt(np.maximum(ess_ref, 1.0)), 1e-9)
    z_ref = float((np.abs(mean - target) / se).max())
    ok_ref = bool(np.all(np.abs(mean - target) < 8.0 * se + 0.02 * np.maximum(sd, 1e-9)))
    for chains in (x, torch.tensor(x)):
        np.testing.assert_allclose(diagnostics.multichain_ess(chains), ess_ref, rtol=1e-10)
        np.testing.assert_allclose(diagnostics.split_rhat(chains), j_diagnostics.split_rhat(x),
                                   rtol=1e-10, equal_nan=True)
        ok, z, _ = moment_gate(chains, target)
        assert ok == ok_ref and z == pytest.approx(z_ref, rel=1e-10)
