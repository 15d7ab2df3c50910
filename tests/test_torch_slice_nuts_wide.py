"""The second path end to end on the 50-D hierarchical Gaussian: the port's
``build_step``/``run_block`` against the JAX package's, both on the CPU, on
the bench's ``grad_mode=nuts`` cycle (bench.py:163-199: SCAM/AM/DE/NUTS/HMC
at 10 each, hmc_stepsize=0.08) at a small shape: 2 temperatures x 48
chains, nuts_max_depth=5, hmc_nmaxsteps=20, 300 burn-in + 300 measured
iterations.

Torch generators cannot replay JAX's streams, so the two runs are held
statistically, as tests/test_torch_slice_nuts.py holds the curved model's:
both pass the bench's moment gate against the closed-form
``posterior_moments()`` (bench.py:294-304), and their cold-chain acceptance
per jump kind agrees within ACC_TOL = 0.08 (48 chains: the acceptance of a
jump kind is a mean over about 1400 cold proposals, sd about 0.013).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptmcmcsampler_torch import SamplerConfig as TConfig
from ptmcmcsampler_torch import build_default_jumps as t_jumps
from ptmcmcsampler_torch import build_step as t_build_step
from ptmcmcsampler_torch import init_state as t_init_state
from ptmcmcsampler_torch.diagnostics import moment_gate
from ptmcmcsampler_torch.ladder import ladder_betas, temperature_ladder
from ptmcmcsampler_torch.models import HierarchicalGaussian as THier
from ptmcmcsampler_tpu.config import SamplerConfig as JConfig
from ptmcmcsampler_tpu.config import build_default_jumps as j_jumps
from ptmcmcsampler_tpu.kernel import build_step as j_build_step
from ptmcmcsampler_tpu.models import HierarchicalGaussian as JHier
from ptmcmcsampler_tpu.state import init_state as j_init_state

torch.set_num_threads(2)

T, C, D = 2, 48, 50
BURN, MEASURED = 300, 300
X0 = np.zeros(D)
ACC_TOL = 0.08


def _config_kwargs():
    burn = BURN // 2
    jumps = dict(SCAMweight=10, AMweight=10, DEweight=10, NUTSweight=10, HMCweight=10,
                 burn=burn, have_grads=True)
    cfg = dict(ndim=D, ntemps=T, nchains=C, groups=(tuple(range(D)),), tskip=5, cov_update=100,
               burn=burn, thin=1, de_size=500, hmc_stepsize=0.08, hmc_nmaxsteps=20,
               nuts_max_depth=5)
    return jumps, cfg


def _betas():
    return ladder_betas(temperature_ladder(D, T))[1]


def _acceptance(accepted, proposed):
    """Cold-chain acceptance per jump kind: [J]."""
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
    xs = torch.tensor(X0, dtype=torch.float32)[None, :, None].expand(T, D, C)
    state = t_init_state(cfg, 7, X0, np.eye(D), _betas(), model.lnlike(xs), model.lnprior(xs),
                         device="cpu")
    state, _ = run_block(state, BURN)
    state, out = run_block(state, MEASURED)
    assert out.x.shape == (MEASURED, T, D, C)
    assert torch.isfinite(out.x).all()
    assert (state.stepsize.epsilon > 0).all()  # every chain's NUTS step size was searched
    chains = out.x[:, 0].permute(2, 0, 1).numpy()
    ctr = state.counters
    return chains, _acceptance(ctr.jump_accepted.numpy(), ctr.jump_proposed.numpy())


def test_jax_reference_passes_moment_gate(jax_run):
    ok, max_z, _ = moment_gate(jax_run[0], THier().posterior_moments()[0])
    assert ok, max_z


def test_port_passes_moment_gate(port_run):
    ok, max_z, _ = moment_gate(port_run[0], THier().posterior_moments()[0])
    assert ok, max_z


def test_port_acceptance_matches_jax(jax_run, port_run):
    names = [j.name for j in TConfig(jumps=t_jumps(**_config_kwargs()[0]),
                                     **_config_kwargs()[1]).jumps]
    for name, a, b in zip(names, port_run[1], jax_run[1]):
        assert abs(a - b) < ACC_TOL, (name, a, b)
