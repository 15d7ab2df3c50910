"""jump_select="per_chain" on the port against the JAX package (mirroring
tests/test_per_chain.py): the rotation's partition and its per-kind
proposal totals, exact whatever the draws; the stacked mode with gradient
jumps; ChEES under rotation; moments against the JAX per_chain run and the
shared selection; the CUDA-graph stand-in against the eager loop, with a
host-made offset as the mutation it must catch; the user's torch jumps on
a slice; and PTSampler's exact resume.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptmcmcsampler_torch import PTSampler
from ptmcmcsampler_torch import config as t_config
from ptmcmcsampler_torch import kernel as t_kernel
from ptmcmcsampler_torch.models import CurvedLikelihood
from ptmcmcsampler_torch.proposals.cycle import phase_partitions, rotation_partition
from ptmcmcsampler_torch.state import init_state as t_init_state
from ptmcmcsampler_tpu import config as j_config
from ptmcmcsampler_tpu.kernel import build_step as j_build_step
from ptmcmcsampler_tpu.state import init_state as j_init_state
from test_torch_block_runner import _SimulatedGraphs, assert_outputs_equal, assert_states_equal

torch.set_num_threads(2)


class Gaussian:
    """A standard Gaussian in a box, batched over ``[..., D, C]``, with the
    tempered value and gradient the gradient jumps take (plain versions on
    the CPU)."""

    def __init__(self, ndim):
        self.ndim = ndim

    def lnlike(self, x):
        return -0.5 * (x * x).sum(-2)

    def lnprior(self, x):
        inside = (x.abs() < 30.0).all(-2)
        return torch.where(inside, 0.0, float("-inf"))

    def value_grad(self, x, beta):
        beta = torch.as_tensor(beta, dtype=x.dtype)
        b = beta.unsqueeze(-2) if beta.dim() else beta
        return beta * self.lnlike(x) + self.lnprior(x), -b * x


def _jax_gaussian(ndim):
    def logl(x):
        return -0.5 * jnp.sum(x**2)

    def logp(x):
        return jnp.where(jnp.all(jnp.abs(x) < 30.0), 0.0, -jnp.inf)

    def func_grad(x, beta):
        return beta * logl(x) + logp(x), beta * jax.grad(logl)(x)

    return logl, logp, func_grad


def _kw(ndim, ntemps, nchains, mode, burn, **kw):
    return dict(ndim=ndim, ntemps=ntemps, nchains=nchains, groups=(tuple(range(ndim)),),
                tskip=10, cov_update=100, burn=burn, thin=2, de_size=200, jump_select="per_chain",
                per_chain_mode=mode, hmc_stepsize=0.1, hmc_nmaxsteps=10, nuts_max_depth=4,
                chees_max_steps=16, **kw)


def _weights(**w):
    base = dict(SCAMweight=20, AMweight=20, DEweight=20, MALAweight=10, NUTSweight=0,
                HMCweight=0)
    base.update(w)
    return base


def _port(ndim=3, ntemps=2, nchains=128, mode="rotation", burn=30, seed=0, weights=None,
          jumps=(), aux=(), **kw):
    weights = weights or _weights()
    cfg = t_config.SamplerConfig(
        jumps=t_config.build_default_jumps(burn=burn, have_grads=True, **weights) + tuple(jumps),
        aux_jumps=tuple(aux), **_kw(ndim, ntemps, nchains, mode, burn, **kw))
    model = Gaussian(ndim)
    xs = torch.full((ntemps, ndim, nchains), 0.3)
    betas = 1.0 / 1.5 ** np.arange(ntemps)

    def fresh(s=seed):
        return t_init_state(cfg, s, np.full(ndim, 0.3), np.eye(ndim) * 0.2, betas,
                            model.lnlike(xs), model.lnprior(xs), device="cpu")

    return cfg, model, fresh


def _jax(ndim=3, ntemps=2, nchains=128, mode="rotation", burn=30, seed=0, weights=None,
         jumps=None):
    logl, logp, func_grad = _jax_gaussian(ndim)
    weights = weights or _weights()
    cfg = j_config.SamplerConfig(
        jumps=jumps or j_config.build_default_jumps(burn=burn, have_grads=True, **weights),
        **_kw(ndim, ntemps, nchains, mode, burn))
    _, run_block = j_build_step(cfg, logl, logp, func_grad)
    xs = jnp.zeros((ntemps, nchains, ndim)) + 0.3
    state = j_init_state(cfg, jax.random.key(seed), np.zeros(ndim) + 0.3, np.eye(ndim) * 0.2,
                         1.0 / 1.5 ** np.arange(ntemps), jax.vmap(jax.vmap(logl))(xs),
                         jax.vmap(jax.vmap(logp))(xs))
    return cfg, run_block, state


@pytest.mark.parametrize("nchains", [90, 128])
def test_rotation_totals_equal_the_jax_runs(nchains):
    """60 iterations across DE's activation at 30: each kind's proposals,
    summed over the batch, equal the JAX package's exactly, and equal the
    two phases' partitions times T times their iterations."""
    jcfg, jrun, jstate = _jax(nchains=nchains)
    jstate, _ = jrun(jstate, 30)
    jprop = np.asarray(jstate.counters.jump_proposed).sum(axis=(1, 2))
    cfg, model, fresh = _port(nchains=nchains)
    _, run_block = t_kernel.build_step(cfg, model, device="cpu")
    state, out = run_block(fresh(), 30)
    prop = state.counters.jump_proposed.sum((1, 2)).numpy()
    np.testing.assert_array_equal(prop, jprop)
    parts = phase_partitions(cfg)
    np.testing.assert_array_equal(prop, 2 * 30 * (parts[0] + parts[1]))
    assert parts[0][cfg.jump_names().index("DEJump")] == 0 and parts[1].sum() == nchains
    assert torch.isfinite(out.x).all()
    # Every chain drew one kind an iteration.
    assert torch.all(state.counters.jump_proposed.sum(0) == 60)


@pytest.mark.parametrize("weights,nchains", [((20, 20, 20), 7), ((3, 5, 11), 10),
                                             ((1, 1, 1), 128), ((7, 13, 2), 33)])
def test_partition_equals_the_jax_packages(weights, nchains):
    """rotation_partition against the JAX kernel's layout (its one
    iteration's per-kind proposals over T), with all jumps active."""
    names = ("covarianceJumpProposalSCAM", "covarianceJumpProposalAM", "DEJump")
    kinds = (j_config.KIND_SCAM, j_config.KIND_AM, j_config.KIND_DE)
    jumps = tuple(j_config.JumpSpec(n, k, w) for n, k, w in zip(names, kinds, weights))
    jcfg, jrun, jstate = _jax(ndim=2, ntemps=1, nchains=nchains, jumps=jumps)
    jstate, _ = jrun(jstate, 1)
    counts = np.asarray(jstate.counters.jump_proposed).sum(axis=(1, 2)) // 2
    tcfg = t_config.SamplerConfig(jumps=tuple(
        t_config.JumpSpec(n, k, w) for n, k, w in zip(names, kinds, weights)),
        **_kw(2, 1, nchains, "rotation", 30))
    np.testing.assert_array_equal(rotation_partition(tcfg, set()), counts)


def test_stacked_mode_with_gradient_jumps():
    """Stacked at 16 chains with every gradient jump: each chain one kind an
    iteration, every kind drawn, the kinds' shares near their weights."""
    w = _weights(NUTSweight=10, HMCweight=10, CHEESweight=10)
    cfg, model, fresh = _port(nchains=16, mode="stacked", burn=10, weights=w)
    assert not cfg.per_chain_rotation
    _, run_block = t_kernel.build_step(cfg, model, device="cpu")
    state, out = run_block(fresh(), 60)
    assert torch.isfinite(out.x).all()
    prop = state.counters.jump_proposed
    assert torch.all(prop.sum(0) == 120) and torch.all(prop.sum((1, 2)) > 0)
    share = prop.sum((1, 2)).double() / prop.sum()
    w, act = cfg.weights_and_activation()
    before, after = w * (act == 0), w.astype(np.float64)  # DE joins after iteration 10
    expect = (10 * before / before.sum() + 110 * after / after.sum()) / 120
    np.testing.assert_allclose(share.numpy(), expect, atol=0.04)


def test_rotation_with_chees_keeps_its_fields_per_temperature():
    w = dict(SCAMweight=0, AMweight=20, DEweight=0, MALAweight=0, CHEESweight=20)
    cfg, model, fresh = _port(ndim=2, nchains=128, burn=40, weights=w)
    _, run_block = t_kernel.build_step(cfg, model, device="cpu")
    state, out = run_block(fresh(), 60)
    assert torch.isfinite(out.x).all()
    assert torch.all(state.counters.jump_proposed.sum((1, 2)) > 0)
    for f in ("chees_eps", "chees_tlen", "chees_count"):
        v = getattr(state.stepsize, f)
        assert torch.equal(v, v[:, :1].expand_as(v)), f
    assert torch.all(state.stepsize.chees_eps > 0)
    assert torch.all(state.stepsize.chees_count[:, 0] == 40)  # one update an iteration of burn-in


def _cold(x):
    """Cold chains of thinned rows ``[rows, T, D, C]`` -> ``[samples, D]``."""
    return np.asarray(x[:, 0]).transpose(0, 2, 1).reshape(-1, x.shape[2])


def test_moments_match_the_jax_run_and_the_shared_selection():
    """A 3-D standard Gaussian, SCAM/AM/DE/MALA/HMC at 128 chains: the
    rotation's cold-chain moments against the JAX package's per_chain run,
    the port's shared selection and the target."""
    w = _weights(HMCweight=10)
    jcfg, jrun, jstate = _jax(ntemps=1, weights=w, seed=3)
    jstate, _ = jrun(jstate, 100)
    jstate, jout = jrun(jstate, 200)
    res = {"jax": _cold(jout.x)}
    for mode in ("per_chain", "shared"):
        cfg, model, fresh = _port(ntemps=1, weights=w, seed=3)
        if mode == "shared":
            cfg = t_config.SamplerConfig(**{**cfg.__dict__, "jump_select": "shared"})
        _, run_block = t_kernel.build_step(cfg, model, device="cpu")
        state, _ = run_block(fresh(), 100)
        state, out = run_block(state, 200)
        res[mode] = _cold(out.x.numpy())
    m, s = res["per_chain"].mean(0), res["per_chain"].std(0)
    for other in ("jax", "shared"):
        np.testing.assert_allclose(m, res[other].mean(0), atol=0.1)
        np.testing.assert_allclose(s, res[other].std(0), rtol=0.1)
    np.testing.assert_allclose(s, np.ones(3), rtol=0.12)


class _FrozenHostReplay(_SimulatedGraphs):
    """The graph stand-in, also holding the host's default generator as the
    capture left it (a real graph repeats whatever the host drew while it
    was captured): a value drawn on the host in the step repeats at every
    replay."""

    def capture(self, fn, static):
        replay = super().capture(fn, static)
        frozen = torch.default_generator.get_state()
        inner = replay.replay

        def frozen_replay():
            now = torch.default_generator.get_state()
            torch.default_generator.set_state(frozen)
            inner()
            torch.default_generator.set_state(now)

        replay.replay = frozen_replay
        return replay


def _it_jump(rng, x, it, beta):
    """A torch-native custom jump (reads the device iteration)."""
    q = x + 0.05 * torch.randn(x.shape, generator=rng, device=x.device) * (1 + (it % 3))
    return q, torch.zeros((), device=x.device)


def _draw_box(rng):
    """A torch-native prior draw: the Gaussian's box prior, uniform."""
    return 60.0 * torch.rand(3, generator=rng, device=rng.device) - 30.0


def _flip_aux(rng, x, q, it, beta):
    """A torch-native auxiliary jump: the Gaussian's reflection q -> -q."""
    return -q, torch.zeros((), device=x.device)


def _eager(step, state, n, thin):
    rows = []
    for _ in range(n):
        for _ in range(thin):
            state = step(state)
        rows.append(state.x.clone())
    return state, torch.stack(rows)


@pytest.mark.parametrize("mode", ["rotation", "stacked"])
def test_graph_stand_in_replays_like_the_eager_loop(monkeypatch, mode):
    """Under the graph stand-in (a key's second iteration captured, later
    ones replayed with the host values of their capture) the runner equals
    the eager loop bit for bit, across the activation phases, with a torch
    custom jump and a prior draw on their slices and an auxiliary jump after
    every branch."""
    from ptmcmcsampler_torch.config import KIND_CUSTOM, KIND_PRIOR, JumpSpec

    custom = [JumpSpec("ItJump", KIND_CUSTOM, 10, fn=_it_jump),
              JumpSpec("DrawFromPrior", KIND_PRIOR, 5, fn=_draw_box)]
    aux = [JumpSpec("Flip", KIND_CUSTOM, 1, fn=_flip_aux)]
    cfg, model, fresh = _port(nchains=96 if mode == "rotation" else 12, mode=mode, burn=20,
                              weights=_weights(HMCweight=10), jumps=custom, aux=aux)
    step, _ = t_kernel.build_step(cfg, model, device="cpu")
    ref, ref_x = _eager(step, fresh(), 30, cfg.thin)
    monkeypatch.setattr(t_kernel, "_graphs_on", lambda device: True)
    monkeypatch.setattr(t_kernel, "_CudaGraphs", _FrozenHostReplay)
    _, run_block = t_kernel.build_step(cfg, model, device="cpu")
    got, out = run_block(fresh(), 30)
    assert torch.equal(out.x, ref_x)
    assert_states_equal(ref, got)
    keys = set(run_block.stats.replays)
    assert {k[0] for k in keys} == {("per_chain", mode, 0), ("per_chain", mode, 1)}
    assert sum(run_block.stats.replays.values()) > 40
    for name in ("ItJump", "DrawFromPrior"):
        assert int(got.counters.jump_proposed[cfg.jump_names().index(name)].sum()) > 0


def test_graph_stand_in_catches_an_offset_drawn_on_the_host(monkeypatch):
    """The mutation: the rotation's offset drawn from the host's generator
    (``torch.roll``'s way, a host shift). A graph would repeat its captured
    offset, and the stand-in then leaves the eager loop."""
    monkeypatch.setattr(t_kernel, "rotation_offset",
                        lambda rng, c, device: torch.randint(0, c, ()).to(device))
    with pytest.raises(AssertionError):
        test_graph_stand_in_replays_like_the_eager_loop(monkeypatch, "rotation")


def _per_chain_run(outdir, niter, resume):
    cl = CurvedLikelihood()
    s = PTSampler(2, cl.lnlikefn, cl.lnpriorfn, np.eye(2), logl_grad=cl.lnlikefn_grad,
                  logp_grad=cl.lnpriorfn_grad, ntemps=2, nchains=128, seed=3, outDir=outdir,
                  resume=resume, device="cpu", verbose=False, jump_select="per_chain")
    s.sample([-0.1, -0.5], niter, burn=60, Tskip=5, isave=40, covUpdate=40, thin=2,
             SCAMweight=10, AMweight=10, DEweight=10, CHEESweight=10, NUTSweight=0,
             HMCweight=0, MALAweight=0, HMCstepsize=0.08)
    return s


def test_sampler_per_chain_resumes_byte_for_byte(tmp_path):
    """PTSampler(jump_select="per_chain"): the config takes it (rotation at
    128 chains), the per-jump files count each chain's kind, and 80
    iterations resumed to 120 leave the bytes of an unbroken 120."""
    whole, parts = str(tmp_path / "whole"), str(tmp_path / "parts")
    s = _per_chain_run(whole, 120, False)
    assert s.config.jump_select == "per_chain" and s.config.per_chain_rotation
    prop = s.state.counters.jump_proposed[:, 0].sum(-1)
    assert int(prop.sum()) == 120 * 128 and torch.all(prop > 0)
    _per_chain_run(parts, 80, False)
    r = _per_chain_run(parts, 120, True)
    assert r._resume_start_iter == 80
    names = sorted(n for n in os.listdir(whole) if not n.startswith("checkpoint"))
    assert names == sorted(n for n in os.listdir(parts) if not n.startswith("checkpoint"))
    for name in names:
        with open(os.path.join(whole, name), "rb") as a, open(os.path.join(parts, name), "rb") as b:
            assert a.read() == b.read(), name
