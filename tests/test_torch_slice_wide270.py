"""Both paths end to end on a 270-D hierarchical Gaussian, the whole-array
pulsar-timing class (67 pulsars with a red-noise and a DM-noise power law
each, plus a common process: 2 x 67 x 2 + 2 parameters), past the 256
dimensions the wide layout once stopped at: the port's
``build_step``/``run_block`` against the JAX package's, both on the CPU.

* Path 1, the headline cycle (SCAM/AM/DE/ChEES at 10/10/10/20),
  chees_max_steps=8;
* path 2, ``grad_mode=nuts`` (SCAM/AM/DE/NUTS/HMC at 10 each),
  nuts_max_depth=4, hmc_nmaxsteps=10;

each at 2 temperatures x 64 chains, 400 burn-in + 400 measured iterations
(the plain versions' ordered sums over 270 dimensions are slow on the
CPU). Held statistically, as tests/test_torch_slice_wide.py and
test_torch_slice_nuts_wide.py hold the 50-D model: both packages pass the
bench's moment gate against the closed-form ``posterior_moments()``, and
their cold-chain acceptance per jump kind agrees within ACC_TOL = 0.08
(test_torch_slice_nuts_wide.py's, for about as many cold proposals).
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

T, C, D = 2, 64, 270
BURN, MEASURED = 400, 400
X0 = np.zeros(D)
ACC_TOL = 0.08
PATHS = {
    "chees": (dict(SCAMweight=10, AMweight=10, DEweight=10, CHEESweight=20),
              dict(chees_max_steps=8)),
    "nuts": (dict(SCAMweight=10, AMweight=10, DEweight=10, NUTSweight=10, HMCweight=10),
             dict(nuts_max_depth=4, hmc_nmaxsteps=10)),
}


def _config_kwargs(path):
    burn = BURN // 2
    weights, extra = PATHS[path]
    jumps = dict(burn=burn, have_grads=True, **weights)
    cfg = dict(ndim=D, ntemps=T, nchains=C, groups=(tuple(range(D)),), tskip=5, cov_update=200,
               burn=burn, thin=1, de_size=1000, hmc_stepsize=0.08, **extra)
    return jumps, cfg


def _betas():
    return ladder_betas(temperature_ladder(D, T))[1]


def _acceptance(accepted, proposed):
    """Cold-chain acceptance per jump kind: [J]."""
    return accepted[:, 0].sum(-1) / np.maximum(proposed[:, 0].sum(-1), 1)


@pytest.fixture(scope="module", params=sorted(PATHS))
def path(request):
    return request.param


@pytest.fixture(scope="module")
def jax_run(path):
    jumps, kw = _config_kwargs(path)
    cfg = JConfig(jumps=j_jumps(**jumps), **kw)
    model = JHier(ngroups=D - 1)

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
def port_run(path):
    jumps, kw = _config_kwargs(path)
    cfg = TConfig(jumps=t_jumps(**jumps), **kw)
    model = THier(ngroups=D - 1)
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
    ok, max_z, _ = moment_gate(jax_run[0], THier(ngroups=D - 1).posterior_moments()[0])
    assert ok, max_z


def test_port_passes_moment_gate(port_run):
    ok, max_z, _ = moment_gate(port_run[0], THier(ngroups=D - 1).posterior_moments()[0])
    assert ok, max_z


def test_port_acceptance_matches_jax(path, jax_run, port_run):
    jumps, kw = _config_kwargs(path)
    names = [j.name for j in TConfig(jumps=t_jumps(**jumps), **kw).jumps]
    for name, a, b in zip(names, port_run[1], jax_run[1]):
        assert abs(a - b) < ACC_TOL, (name, a, b)
