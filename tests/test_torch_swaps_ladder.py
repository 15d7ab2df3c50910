"""The port's DEO swaps and adaptive ladder against the JAX package.

* ``deo_swap_apply``, ``deo_swap_map`` + ``apply_swap`` (its select form to
  16 rungs, its gather form above) and ``sweep_swap_map``, bit for bit,
  fed the JAX functions' own uniforms (``pair_uniforms``, the sweep's
  ``uniform(key, (T-1, C))``), at both parities, T in {1, 2, 6, 17, 64},
  with -inf rows as ``tests/test_swaps_impl.py`` has them.
* ``adapt_ladder_betas`` within 1e-6 relative and ``ladder_window_rates``
  exactly, on the cases of ``tests/test_ladder_adapt.py``.
* That file's end-to-end run through the port's ``build_step`` on the CPU:
  its asserts, and the adapted betas within 10% of the JAX package's run.
* DEO with the adaptive ladder through ``run_block`` with graphs simulated
  (a stand-in replays the captured body with the host values of its
  capture): equal to the eager loop bit for bit, so neither the parity nor
  the decay is read from a host value a graph would freeze.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptmcmcsampler_torch import SamplerConfig, build_default_jumps, init_state
from ptmcmcsampler_torch import kernel as t_kernel
from ptmcmcsampler_torch import ladder as t_ladder
from ptmcmcsampler_torch import swaps as t_swaps
from ptmcmcsampler_torch.kernel import build_step
from ptmcmcsampler_torch.state import Counters
from ptmcmcsampler_tpu import config as j_config
from ptmcmcsampler_tpu import kernel as j_kernel
from ptmcmcsampler_tpu import ladder as j_ladder
from ptmcmcsampler_tpu import state as j_state
from ptmcmcsampler_tpu import swaps as j_swaps
from test_torch_block_runner import (  # noqa: F401 (simulated_graphs: a fixture)
    assert_outputs_equal,
    assert_states_equal,
    eager_run_block,
    simulated_graphs,
)

torch.set_num_threads(2)


def _swap_state(seed, t, c=33, d=3):
    """As ``tests/test_swaps_impl.py``: random rows, the top one and part of
    row 2 at -inf, betas descending."""
    rng = np.random.default_rng(seed)
    lnlike = rng.normal(size=(t, c)).astype(np.float32)
    lnlike[-1] = -np.inf
    lnlike[min(2, t - 1), :5] = -np.inf
    lnprior = rng.normal(size=(t, c)).astype(np.float32)
    x = rng.normal(size=(t, d, c)).astype(np.float32)
    betas = np.sort(rng.uniform(0.01, 1.0, size=t).astype(np.float32))[::-1].copy()
    return x, lnlike, lnprior, betas


def _assert_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("t", [1, 2, 6, 17, 64])
def test_deo_bitwise(t, parity):
    x, lnlike, lnprior, betas = _swap_state(t + parity, t)
    c = lnlike.shape[1]
    key = jax.random.key(10 * t + parity)
    j_args = [jnp.asarray(a) for a in (x, lnlike, lnprior, betas)]
    t_args = [torch.tensor(a) for a in (x, lnlike, lnprior, betas)]
    us = torch.tensor(np.asarray(j_swaps.pair_uniforms(key, t, c))[:-1])  # swaps.py:154
    want = j_swaps.deo_swap_apply(key, *j_args, jnp.asarray(parity))
    got = t_swaps.deo_swap_apply(us, *t_args, parity)
    _assert_equal(got, want)
    jmap = j_swaps.deo_swap_map(key, j_args[1], j_args[3], jnp.asarray(parity))
    tmap = t_swaps.deo_swap_map(us, t_args[1], t_args[3], parity)
    _assert_equal(tmap, jmap)
    assert tmap[0].dtype == torch.int32
    # apply_swap's select form (T <= 16) or gather form; either equals the
    # neighbour selects of deo_swap_apply.
    applied = t_swaps.apply_swap(tmap[0], t_args[0], t_args[1], t_args[2])
    _assert_equal(applied, j_swaps.apply_swap(jmap[0], j_args[0], j_args[1], j_args[2]))
    _assert_equal(applied, got[:3])
    if t > 2:
        assert got[3].any()  # some pair swapped


@pytest.mark.parametrize("t", [1, 2, 6, 17, 64])
def test_sweep_map_and_apply_swap_bitwise(t):
    x, lnlike, lnprior, betas = _swap_state(100 + t, t)
    c = lnlike.shape[1]
    key = jax.random.key(t)
    j_args = [jnp.asarray(a) for a in (x, lnlike, lnprior, betas)]
    t_args = [torch.tensor(a) for a in (x, lnlike, lnprior, betas)]
    us = torch.tensor(np.asarray(jax.random.uniform(key, (t - 1, c))))  # swaps.py:54
    jmap = j_swaps.sweep_swap_map(key, j_args[1], j_args[3])
    tmap = t_swaps.sweep_swap_map(us, t_args[1], t_args[3])
    _assert_equal(tmap, jmap)
    applied = t_swaps.apply_swap(tmap[0], t_args[0], t_args[1], t_args[2])
    _assert_equal(applied, j_swaps.apply_swap(jmap[0], j_args[0], j_args[1], j_args[2]))
    # The map applied equals the sweep that carries its rows.
    _assert_equal(applied, t_swaps.sweep_swap_apply(us, *t_args)[:3])


# ---- the adaptive ladder: tests/test_ladder_adapt.py's cases ----

def _both(betas, rates, it, **kw):
    """The JAX and the port's update on the same inputs."""
    want = np.asarray(j_ladder.adapt_ladder_betas(
        jnp.asarray(betas, jnp.float32), jnp.asarray(rates, jnp.float32), it,
        **{k: (jnp.asarray(v) if k == "pair_valid" else v) for k, v in kw.items()}))
    got = t_ladder.adapt_ladder_betas(
        torch.tensor(betas, dtype=torch.float32), torch.tensor(rates, dtype=torch.float32),
        torch.tensor(it), **{k: (torch.tensor(v) if k == "pair_valid" else v)
                             for k, v in kw.items()}).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    return got


LADDER_CASES = {
    "endpoints-and-direction": (1.0 / np.geomspace(1.0, 100.0, 5), [0.9, 0.1, 0.5, 0.5, 0.0],
                                10, dict(lag=100.0, time=1.0)),
    "equal-rates": (1.0 / np.geomspace(1.0, 50.0, 6), [0.3] * 6, 5, dict(lag=100.0, time=1.0)),
    "unproposed-pairs": (1.0 / np.geomspace(1.0, 50.0, 6), [0.8, 0.0, 0.8, 0.0, 0.0, 0.0], 1,
                         dict(lag=100.0, time=1.0,
                              pair_valid=[True, False, True, False, False, False])),
    "skip-top": ([1.0, 0.5, 0.2, 0.05, 0.0], [0.8, 0.2, 0.5, 0.0, 0.0], 10,
                 dict(lag=100.0, time=1.0, skip_top=True)),
    "defaults-64-rungs": (1.0 / (1 + np.sqrt(2 / 50)) ** np.arange(64),
                          np.linspace(0.9, 0.1, 64), 2500, {}),
    "two-rungs": ([1.0, 0.3], [0.5, 0.0], 3, {}),
}


@pytest.mark.parametrize("case", list(LADDER_CASES))
def test_adapt_ladder_betas_matches_jax(case):
    betas, rates, it, kw = LADDER_CASES[case]
    got = _both(np.asarray(betas, np.float32), rates, it, **kw)
    old = np.asarray(betas, np.float32)
    assert got[0] == old[0] and got[-1] == old[-1]  # endpoints fixed
    if case == "endpoints-and-direction":
        assert got[1] < old[1] and np.all(np.diff(got) < 0) and np.all(got > 0)
    if case in ("equal-rates", "unproposed-pairs", "two-rungs"):
        np.testing.assert_allclose(got, old, rtol=1e-5)
    if case == "skip-top":
        assert got[-2] == old[-2] and np.all(np.isfinite(got))


def test_persistent_imbalance_cannot_invert_the_ladder():
    """3000 updates under the largest imbalance, as the JAX test: both
    packages' ladders stay strictly descending and within 1e-5."""
    jb = jnp.asarray(1.0 / np.geomspace(1.0, 8.0, 4), jnp.float32)
    tb = torch.tensor(np.asarray(jb))
    rates = [1.0, 0.0, 0.0]
    for i in range(3000):
        jb = j_ladder.adapt_ladder_betas(jb, jnp.asarray(rates, jnp.float32), i + 1,
                                         lag=100.0, time=5.0)
        tb = t_ladder.adapt_ladder_betas(tb, torch.tensor(rates), torch.tensor(i + 1),
                                         lag=100.0, time=5.0)
    b = tb.numpy()
    np.testing.assert_allclose(b, np.asarray(jb), rtol=1e-5)
    assert np.all(np.diff(b) < 0) and b[-2] > b[-1] > 0


def _counters(prop, acc, prop_lad, acc_lad):
    t, c = np.shape(acc)
    z = np.zeros((t, c), np.int32)
    kw = dict(naccepted=z, jump_proposed=z[None], jump_accepted=z[None], swaps_proposed=prop,
              swaps_accepted=acc, swaps_proposed_lad=prop_lad, swaps_accepted_lad=acc_lad)
    return (j_state.Counters(**{k: jnp.asarray(v, jnp.int32) for k, v in kw.items()}),
            Counters(**{k: torch.tensor(np.asarray(v, np.int32)) for k, v in kw.items()}))


@pytest.mark.parametrize("case", ["stale-history", "empty-window", "random"])
def test_ladder_window_rates_exact(case):
    rng = np.random.default_rng(4)
    if case == "stale-history":  # tests/test_ladder_adapt.py: the window's rate is 0.1
        t, c = 4, 8
        args = (np.full(t, 1010), np.full((t, c), 901), np.full(t, 1000), np.full((t, c), 900))
    elif case == "empty-window":
        t, c = 3, 4
        args = ([5, 0, 5], np.zeros((t, c)), np.zeros(t), np.zeros((t, c)))
    else:
        t, c = 64, 37
        lad = rng.integers(0, 500, size=t)
        lad_acc = rng.integers(0, 400, size=(t, c))
        win = rng.integers(0, 3, size=t)
        args = (lad + win, lad_acc + rng.integers(0, 3, size=(t, c)) * (win > 0)[:, None],
                lad, lad_acc)
    jc, tc = _counters(*args)
    jr, jv = j_kernel.ladder_window_rates(jc, jnp.float32)
    tr, tv = t_kernel.ladder_window_rates(tc)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if case == "stale-history":
        np.testing.assert_allclose(tr.numpy(), 0.1, rtol=1e-6)
    if case == "empty-window":
        assert tv.tolist() == [True, False, True]


# ---- tests/test_ladder_adapt.py's end-to-end run ----

class _Gauss4:
    """The JAX test's 4-D standard normal inside |x| < 30, batched."""

    def lnlike(self, x):
        return -0.5 * (x ** 2).sum(-2)

    def lnprior(self, x):
        return torch.where((x.abs() < 30.0).all(-2), 0.0, float("-inf"))


E2E = dict(ndim=4, ntemps=6, nchains=64, groups=(tuple(range(4)),), tskip=5, cov_update=200,
           burn=4000, thin=1, de_size=500, ladder_adapt_lag=1000.0, ladder_adapt_time=10.0)


def _port_e2e(adapt, swap_mode="sweep", seed=0):
    model = _Gauss4()
    cfg = SamplerConfig(jumps=build_default_jumps(burn=400), adapt_ladder=adapt,
                        swap_mode=swap_mode, **E2E)
    _, run_block = build_step(cfg, model, device="cpu")
    _, betas = t_ladder.ladder_betas(np.geomspace(1.0, 1e6, 6))  # a deliberately bad ladder
    xs = torch.full((6, 4, 64), 0.1)
    state = init_state(cfg, seed, np.zeros(4) + 0.1, np.eye(4) * 0.5, betas, model.lnlike(xs),
                       model.lnprior(xs), device="cpu")
    state, _ = run_block(state, 1500)
    c0 = state.counters.swaps_accepted.clone(), state.counters.swaps_proposed.clone()
    state, _ = run_block(state, 1500)
    dacc = (state.counters.swaps_accepted - c0[0]).double().mean(1).numpy()[:-1]
    dprop = (state.counters.swaps_proposed - c0[1]).numpy()[:-1]
    return dacc / np.maximum(dprop, 1), state.betas.numpy()


def _jax_e2e_betas():
    def logl(x):
        return -0.5 * jnp.sum(x ** 2)

    def logp(x):
        return jnp.where(jnp.all(jnp.abs(x) < 30.0), 0.0, -jnp.inf)

    cfg = j_config.SamplerConfig(jumps=j_config.build_default_jumps(burn=400),
                                 adapt_ladder=True, **E2E)
    _, run_block = j_kernel.build_step(cfg, logl, logp)
    _, betas = j_ladder.ladder_betas(np.geomspace(1.0, 1e6, 6))
    xs = jnp.zeros((6, 64, 4)) + 0.1
    state = j_state.init_state(cfg, jax.random.PRNGKey(0), np.zeros(4) + 0.1, np.eye(4) * 0.5,
                               betas, jax.vmap(jax.vmap(logl))(xs), jax.vmap(jax.vmap(logp))(xs))
    state, _ = run_block(state, 3000)
    return np.asarray(state.betas)


def test_adaptation_equalizes_and_raises_acceptance():
    """The JAX test's asserts on the port's run, and its final betas within
    10% of the JAX package's (the packages' random streams differ)."""
    rates_static, betas_static = _port_e2e(adapt=False)
    rates_adapt, betas_adapt = _port_e2e(adapt=True)
    assert not np.allclose(betas_adapt, betas_static)  # the ladder moved
    assert betas_adapt[0] == betas_static[0]
    np.testing.assert_allclose(betas_adapt[-1], betas_static[-1], rtol=1e-6)
    assert rates_adapt.min() > rates_static.min() + 0.05, (rates_static, rates_adapt)
    assert rates_adapt.std() < 0.5 * rates_static.std(), (rates_static, rates_adapt)
    np.testing.assert_allclose(betas_adapt, _jax_e2e_betas(), rtol=0.1)


def test_deo_adaptation_moves_the_ladder_and_keeps_it_descending():
    """The same run under DEO: the window covers both parities before an
    update, the ladder moves, stays descending and keeps both ends, and
    the bottleneck opens."""
    rates_static, betas_static = _port_e2e(adapt=False, swap_mode="deo")
    rates_adapt, betas_adapt = _port_e2e(adapt=True, swap_mode="deo")
    assert not np.allclose(betas_adapt, betas_static)
    assert np.all(np.diff(betas_adapt) < 0)
    assert betas_adapt[0] == betas_static[0] and betas_adapt[-1] == betas_static[-1]
    assert rates_adapt.min() > rates_static.min() + 0.05, (rates_static, rates_adapt)


# ---- DEO and the ladder under the graph stand-in ----

def _graph_case(hot=False):
    """A 4-D hierarchy, 6 rungs x 16 chains, SCAM/AM/DE/ChEES with DEO, the
    rolled DE and the ladder (``hot``: with a beta = 0 top rung)."""
    from ptmcmcsampler_torch.models import HierarchicalGaussian

    model = HierarchicalGaussian(ngroups=3)
    d, t, c = model.ndim, 6, 16
    cfg = SamplerConfig(
        ndim=d, ntemps=t, nchains=c, groups=(tuple(range(d)),),
        jumps=build_default_jumps(SCAMweight=10, AMweight=10, DEweight=10, CHEESweight=20,
                                  burn=20, have_grads=True),
        tskip=3, cov_update=40, burn=60, thin=2, de_size=64, chees_max_steps=8,
        swap_mode="deo", de_pair="rolled", adapt_ladder=True, ladder_adapt_lag=50.0,
        ladder_adapt_time=2.0, ladder_adapt_skip_top=hot)
    _, betas = t_ladder.ladder_betas(t_ladder.temperature_ladder(d, t, tmax=200.0),
                                     hot_chain=hot)
    xs = torch.full((t, d, c), 0.3)

    def fresh():
        return init_state(cfg, 5, np.full(d, 0.3), np.eye(d), betas, model.lnlike(xs),
                          model.lnprior(xs), device="cpu")

    return cfg, model, fresh


def _against_eager(cfg, model, fresh, blocks=(20, 25)):
    step, run_block = build_step(cfg, model, device="cpu")
    ref, got, b0 = fresh(), fresh(), fresh().betas.clone()
    for n in blocks:  # 90 iterations: burn 60 ends in the second block
        ref, ref_out = eager_run_block(step, cfg, ref, n)
        got, got_out = run_block(got, n)
        assert_outputs_equal(ref_out, got_out)
    return ref, got, b0, run_block.stats


@pytest.mark.parametrize("hot", [False, True])
def test_deo_and_ladder_replay_like_the_eager_loop(simulated_graphs, hot):
    """Both parities and both ladder keys replay (the update's iterations
    differ only in the device iteration its decay reads), and the runner
    equals the eager loop bit for bit."""
    cfg, model, fresh = _graph_case(hot)
    ref, got, b0, stats = _against_eager(cfg, model, fresh)
    assert_states_equal(ref, got)
    events = {key[1] for key in stats.replays}
    assert {("deo", 0, "ladder"), ("deo", 1, "ladder"), ("deo", 0), ("deo", 1)} <= events
    assert not torch.equal(got.betas, b0)  # the ladder moved, in replays too
    assert torch.all(got.betas[1:] < got.betas[:-1]) if not hot else \
        torch.all(got.betas[1:-1] < got.betas[:-2]) and got.betas[-1] == 0
    assert got.betas[0] == b0[0] and got.betas[-1] == b0[-1]


def test_simulated_graphs_catch_a_key_without_the_parity(simulated_graphs, monkeypatch):
    """With the parity left out of the key, a DEO graph captured at one
    parity replays it at the other, and the runner leaves the eager loop."""
    real = t_kernel.step_key

    def without_parity(*a):
        key = real(*a)
        event = key[1] if key[1] is None else key[1][:1] + key[1][2:]
        return key[:1] + (event,) + key[2:]

    monkeypatch.setattr(t_kernel, "step_key", without_parity)
    cfg, model, fresh = _graph_case()
    with pytest.raises(AssertionError):
        ref, got, _, _ = _against_eager(cfg, model, fresh)
        assert_states_equal(ref, got)


# ---- PTSampler: the ladder's settings, and an exact resume ----

def _ladder_run(outdir, niter, resume):
    from ptmcmcsampler_torch import PTSampler
    from ptmcmcsampler_torch.models import CurvedLikelihood

    cl = CurvedLikelihood()
    s = PTSampler(2, cl.lnlikefn, cl.lnpriorfn, np.eye(2), logl_grad=cl.lnlikefn_grad,
                  logp_grad=cl.lnpriorfn_grad, ntemps=5, nchains=16, seed=3, outDir=outdir,
                  resume=resume, device="cpu", verbose=False, swap_mode="deo",
                  de_pair="iid")
    s.sample([-0.1, -0.5], niter, burn=150, Tskip=3, isave=100, covUpdate=100, thin=2,
             SCAMweight=10, AMweight=10, DEweight=10, CHEESweight=20, NUTSweight=0,
             HMCweight=0, MALAweight=0, HMCstepsize=0.08, hotChain=True, adaptLadder=True,
             ladderAdaptLag=100.0, ladderAdaptTime=5.0)
    return s


def test_ladder_sampler_resume_continues_byte_for_byte(tmp_path):
    """``sample(adaptLadder=True)`` with DEO, the iid DE and a hot chain: the
    config takes the settings (the hot rung left out of the geometry), the
    ladder moves in burn-in (150 iterations), the checkpoint holds
    the adapted betas, and a run of 100 iterations resumed to 200 leaves the
    same bytes in every file as an unbroken run of 200."""
    from ptmcmcsampler_torch.io.checkpoint import load_checkpoint

    whole, parts = str(tmp_path / "whole"), str(tmp_path / "parts")
    s_whole = _ladder_run(whole, 200, False)
    cfg = s_whole.config
    assert (cfg.swap_mode, cfg.de_pair, cfg.adapt_ladder, cfg.ladder_adapt_skip_top,
            cfg.ladder_adapt_lag, cfg.ladder_adapt_time) == ("deo", "iid", True, True, 100.0, 5.0)
    first = _ladder_run(parts, 100, False)
    mid = first.state.betas.clone()
    s = _ladder_run(parts, 200, True)
    assert s._resume_start_iter == 100
    b0 = torch.tensor(1.0 / first.ladder, dtype=torch.float32)
    end = s.state.betas
    assert not torch.equal(mid, b0) and not torch.equal(end, mid)  # moved before and after 100
    assert torch.all(end[1:-1] < end[:-2]) and end[0] == b0[0] and end[-2] == b0[-2]
    assert end[-1] == 0  # the hot chain
    ckpt, _, _ = load_checkpoint(os.path.join(parts, "checkpoint.npz"), s.config, "cpu", 0)
    assert torch.equal(ckpt.betas, end) and torch.equal(end, s_whole.state.betas)
    assert ckpt.counters.swaps_proposed_lad.gt(0).any()
    names = sorted(n for n in os.listdir(whole) if not n.startswith("checkpoint"))
    assert names == sorted(n for n in os.listdir(parts) if not n.startswith("checkpoint"))
    for name in names:
        with open(os.path.join(whole, name), "rb") as a, open(os.path.join(parts, name), "rb") as b:
            assert a.read() == b.read(), name
