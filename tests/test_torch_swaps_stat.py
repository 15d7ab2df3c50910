"""Statistical checks of the port's replica exchange, mirroring
tests/test_swaps_stat.py at sizes a CPU run takes in seconds: the default
ladder's design point (about 25% adjacent-pair acceptance,
PTMCMCSampler.py:699-704), DEO against the sweep, and a hot chain that
samples the prior."""

import numpy as np
import torch

from ptmcmcsampler_torch.config import SamplerConfig, build_default_jumps
from ptmcmcsampler_torch.kernel import build_step
from ptmcmcsampler_torch.ladder import ladder_betas, temperature_ladder
from ptmcmcsampler_torch.state import init_state
from test_torch_per_chain import Gaussian

torch.set_num_threads(2)


def build(ndim=8, ntemps=6, nchains=32, swap_mode="sweep", hot_chain=False, seed=0):
    cfg = SamplerConfig(
        ndim=ndim, ntemps=ntemps, nchains=nchains, groups=(tuple(range(ndim)),),
        jumps=build_default_jumps(burn=200), tskip=10, cov_update=200, burn=200, thin=5,
        de_size=500, swap_mode=swap_mode)
    model = Gaussian(ndim)
    _, run_block = build_step(cfg, model, device="cpu")
    _, betas = ladder_betas(temperature_ladder(ndim, ntemps), hot_chain=hot_chain)
    xs = torch.full((ntemps, ndim, nchains), 0.1)
    state = init_state(cfg, seed, np.full(ndim, 0.1), np.eye(ndim) * 0.5, betas,
                       model.lnlike(xs), model.lnprior(xs), device="cpu")
    return cfg, run_block, state


def swap_rates(state):
    """Per adjacent pair: acceptances over proposals (every pair each sweep
    event, alternating pairs under DEO), comparable across the schemes."""
    prop = state.counters.swaps_proposed.double().numpy()[:-1]
    acc = state.counters.swaps_accepted.double().numpy()
    return acc.mean(axis=1)[:-1] / np.maximum(prop, 1.0)


def test_sweep_acceptance_design_point():
    cfg, run_block, state = build(swap_mode="sweep")
    state, _ = run_block(state, 80)  # burn-in
    state, _ = run_block(state, 320)
    rates = swap_rates(state)
    assert np.all(rates > 0.08), rates
    assert np.all(rates < 0.8), rates
    assert 0.12 < rates.mean() < 0.6, rates


def test_deo_matches_sweep_statistics():
    """64 chains over 3200 iterations (320 swap events): the cold chains'
    marginal spread and each pair's acceptance agree between the schemes."""
    _, run_sweep, s1 = build(swap_mode="sweep", seed=1, nchains=64)
    _, run_deo, s2 = build(swap_mode="deo", seed=2, nchains=64)
    outs = []
    for run, s in ((run_sweep, s1), (run_deo, s2)):
        s, _ = run(s, 80)
        s, o = run(s, 640)
        outs.append((s, o))
    (s1, o1), (s2, o2) = outs
    std1, std2 = (o.x[:, 0].movedim(1, 2).reshape(-1, 8).std(0).numpy() for o in (o1, o2))
    np.testing.assert_allclose(std1, std2, rtol=0.15)
    r1, r2 = swap_rates(s1), swap_rates(s2)
    np.testing.assert_allclose(r1, r2, rtol=0.2)
    np.testing.assert_allclose(r1.mean(), r2.mean(), rtol=0.1)


def test_hot_chain_samples_prior():
    cfg, run_block, state = build(hot_chain=True, ntemps=4, ndim=2)
    assert float(state.betas[-1]) == 0.0
    state, out = run_block(state, 800)
    hot = out.x[400:, -1].movedim(1, 2).reshape(-1, 2)
    # The beta = 0 chain samples the uniform box prior: wide, no pull to 0.
    assert float(hot.std()) > 5.0
    cold = out.x[400:, 0].movedim(1, 2).reshape(-1, 2)
    assert float(cold.std()) < 3.0
