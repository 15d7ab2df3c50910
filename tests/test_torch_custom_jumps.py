"""The user's custom, prior-draw and auxiliary jumps (``proposals/custom.py``,
``PTSampler.addProposalToCycle``, ``addPriorDrawToCycle``,
``addAuxilaryJump``) against the JAX package on the CPU.

* Deterministic custom jumps (a reflection with a ``log_qxy`` that reads
  ``it`` and ``beta``) and a chain of two deterministic auxiliary jumps give
  the JAX branches' and ``build_aux_chain``'s results within 1e-6, in each
  protocol (torch-native, the reference's batched by ``vmap``, numpy on the
  host against the JAX host callback).
* The prior draw's Hastings term against the JAX model's ``lnpriorfn`` on
  the same ``x`` and ``q`` (rtol 1e-5, atol 1e-4: each package sums the
  f32 prior in its own order, the port multiplies by f32 reciprocals).
* A config-4 cycle's jump names and pick probabilities equal the JAX
  sampler's ``_build_config``; ``draw_prior``'s sample moments match the
  prior's within 5 standard errors.
* Mirrors of ``tests/test_hierarchical.py::test_prior_draw_jump_correctness_prior_only``
  (every prior draw accepted, exactly) and of ``test_sampler_e2e.py``'s
  custom-jump tests; a config-4 run's pooled moments within 0.5 posterior
  sd, as the JAX test, and its per-jump acceptance within ``ACC_TOL`` of
  the JAX sampler's on the same cycle.
* ``run_block`` with graphs simulated (``test_torch_block_runner``'s
  stand-in, which replays the body with the host values of its capture)
  equals the eager step loop bit for bit with a custom and an auxiliary jump
  that read ``it``: the stand-in would freeze a host ``it``. Numpy jumps make
  only their own iterations eager (every one, for an auxiliary jump).
* A resumed config-4 run equals an unbroken one byte for byte; its
  checkpoint (five jump counters) loads in the JAX package and back.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptmcmcsampler_torch import PTSampler, SamplerConfig, build_default_jumps, init_state
from ptmcmcsampler_torch import kernel as t_kernel
from ptmcmcsampler_torch.config import KIND_CUSTOM, KIND_PRIOR, JumpSpec
from ptmcmcsampler_torch.io.checkpoint import load_checkpoint
from ptmcmcsampler_torch.kernel import build_step
from ptmcmcsampler_torch.models import CorrelatedGaussian, HierarchicalGaussian
from ptmcmcsampler_torch.proposals import custom
from ptmcmcsampler_torch.proposals.base import ProposalContext as TCtx
from ptmcmcsampler_torch.proposals.cycle import build_jump_branches, jump_probabilities
from ptmcmcsampler_torch.state import state_to_numpy
from ptmcmcsampler_tpu import PTSampler as JPTSampler
from ptmcmcsampler_tpu import config as j_config
from ptmcmcsampler_tpu.io.checkpoint import _path_name
from ptmcmcsampler_tpu.io.checkpoint import load_checkpoint as j_load_checkpoint
from ptmcmcsampler_tpu.io.checkpoint import save_checkpoint as j_save_checkpoint
from ptmcmcsampler_tpu.models import HierarchicalGaussian as JHierarchical
from ptmcmcsampler_tpu.proposals import cycle as j_cycle
from ptmcmcsampler_tpu.proposals.base import ProposalContext as JCtx
from ptmcmcsampler_tpu.state import init_state as j_init_state
from ptmcmcsampler_tpu.utils import split_grid
from test_torch_block_runner import (
    _SimulatedGraphs,
    assert_outputs_equal,
    assert_states_equal,
    eager_run_block,
)

torch.set_num_threads(2)

T, D, C = 2, 5, 6
TOL = 1e-6
ACC_TOL = 0.08  # ~5 binomial standard deviations of a rate difference
CENTER = np.linspace(-1.0, 1.0, D)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, D, C)).astype(np.float32)
    betas = np.array([1.0, 0.4], np.float32)
    return x, betas


# A reflection about CENTER whose log_qxy reads it and beta, in each protocol.
def reflect_torch(rng, x, it, beta):
    m = torch.as_tensor(CENTER, dtype=x.dtype, device=x.device)
    return 2.0 * m - x, 0.5 * beta + 0.001 * it


def reflect_reference(x, it, beta):
    return reflect_torch(None, x, it, beta)


def reflect_numpy(x, it, beta):
    return 2.0 * CENTER - x, 0.5 * beta + 0.001 * it


def reflect_jax(key, x, it, beta):
    return 2.0 * jnp.asarray(CENTER, x.dtype) - x, 0.5 * beta + 0.001 * it


def _port_sampler(outdir, ndim=D, **kw):
    return PTSampler(ndim, lambda x: -0.5 * torch.sum(x * x), lambda x: torch.zeros(()),
                     np.eye(ndim), outDir=str(outdir), device="cpu", verbose=False, **kw)


def _port_branch(spec, it, x, betas, model=None):
    cfg = SamplerConfig(ndim=D, ntemps=T, nchains=C, groups=(tuple(range(D)),),
                        jumps=(spec,))
    branch = build_jump_branches(cfg, model, torch.device("cpu"))[0]
    rng = torch.Generator()
    rng.manual_seed(0)
    ctx = TCtx(group_u=None, group_s=None, chol=None, chol_inv=None, de_buf=None, de_valid=0,
               iteration=torch.tensor(it))
    q, qxy, _ = branch(rng, torch.tensor(x), torch.tensor(betas), it, ctx, {})
    return q.numpy(), qxy.numpy()


def _jax_branch(spec, it, x, betas, logp=None):
    cfg = j_config.SamplerConfig(ndim=D, ntemps=T, nchains=C, groups=(tuple(range(D)),),
                                 jumps=(spec,))
    branch = j_cycle.build_jump_branches(cfg, logp=logp)[0]
    ctx = JCtx(group_u=None, group_s=None, chol=None, chol_inv=None, de_buf=None,
               de_valid=None)
    keys = split_grid(jax.random.key(3), (T, C))
    q, qxy, _ = branch(keys, jnp.asarray(x), jnp.asarray(betas), jnp.int32(it), ctx, {})
    return np.asarray(q), np.asarray(qxy)


@pytest.mark.parametrize("protocol", ["torch", "reference", "host"])
def test_deterministic_custom_jump_equals_the_jax_branch(protocol, tmp_path):
    s = _port_sampler(tmp_path)
    fn = {"torch": reflect_torch, "reference": reflect_reference,
          "host": reflect_numpy}[protocol]
    s.addProposalToCycle(fn, 3, name="Reflect")
    (spec,) = s._custom_jumps
    assert (spec.name, spec.kind, spec.protocol) == (
        "Reflect", KIND_CUSTOM, "host" if protocol == "host" else "torch")
    jspec = (j_config.JumpSpec("Reflect", j_config.KIND_CUSTOM, 3, fn=reflect_numpy,
                               protocol="legacy") if protocol == "host" else
             j_config.JumpSpec("Reflect", j_config.KIND_CUSTOM, 3, fn=reflect_jax))
    x, betas = _inputs()
    for it in (7, 1234):
        q, qxy = _port_branch(spec, it, x, betas)
        jq, jqxy = _jax_branch(jspec, it, x, betas)
        np.testing.assert_allclose(q, jq, rtol=0, atol=TOL)
        np.testing.assert_allclose(qxy, jqxy, rtol=0, atol=TOL)


def mid_torch(rng, x, q, it, beta):
    return 0.5 * q + 0.5 * x, -D * np.log(2.0) + 0.01 * it


def shift_reference(x, q, it, beta):
    return q + 0.1 * beta, beta


def mid_numpy(x, q, it, beta):
    return 0.5 * np.asarray(q) + 0.5 * np.asarray(x), -D * np.log(2.0) + 0.01 * it


def mid_jax(key, x, q, it, beta):
    return 0.5 * q + 0.5 * x, -D * np.log(2.0) + 0.01 * it


def shift_jax(key, x, q, it, beta):
    return q + 0.1 * beta, beta


@pytest.mark.parametrize("first", ["torch", "host"])
def test_deterministic_aux_chain_equals_build_aux_chain(first, tmp_path):
    s = _port_sampler(tmp_path)
    s.addAuxilaryJump(mid_torch if first == "torch" else mid_numpy, name="Mid")
    s.addAuxilaryJump(shift_reference, name="Shift")
    assert [(a.name, a.kind, a.protocol) for a in s._aux_jumps] == [
        ("Mid", KIND_CUSTOM, first), ("Shift", KIND_CUSTOM, "torch")]
    cfg = SamplerConfig(ndim=D, ntemps=T, nchains=C, groups=(tuple(range(D)),),
                        jumps=build_default_jumps(SCAMweight=1, AMweight=0, DEweight=0),
                        aux_jumps=tuple(s._aux_jumps))
    jcfg = j_config.SamplerConfig(
        ndim=D, ntemps=T, nchains=C, groups=(tuple(range(D)),),
        jumps=j_config.build_default_jumps(SCAMweight=1, AMweight=0, DEweight=0),
        aux_jumps=(j_config.JumpSpec("Mid", j_config.KIND_CUSTOM, 1, fn=mid_jax),
                   j_config.JumpSpec("Shift", j_config.KIND_CUSTOM, 1, fn=shift_jax)))
    x, betas = _inputs(1)
    q = (x + 0.3).astype(np.float32)
    qxy = np.full((T, C), -0.25, np.float32)
    apply = custom.make_aux_chain(cfg)
    j_apply = j_cycle.build_aux_chain(jcfg)
    for it in (3, 500):
        ctx = TCtx(group_u=None, group_s=None, chol=None, chol_inv=None, de_buf=None,
                   de_valid=0, iteration=torch.tensor(it))
        got_q, got_qxy = apply(torch.Generator(), torch.tensor(x), torch.tensor(q),
                               torch.tensor(qxy), torch.tensor(betas), it, ctx)
        keys = split_grid(jax.random.key(1), (T, C, 2))
        jq, jqxy = j_apply(keys, jnp.asarray(x), jnp.asarray(q), jnp.asarray(qxy),
                           jnp.asarray(betas), jnp.int32(it))
        np.testing.assert_allclose(got_q.numpy(), np.asarray(jq), rtol=0, atol=TOL)
        np.testing.assert_allclose(got_qxy.numpy(), np.asarray(jqxy), rtol=0, atol=TOL)


def test_prior_draw_hastings_term_against_the_jax_prior():
    model, jmodel = HierarchicalGaussian(ngroups=D - 1), JHierarchical(ngroups=D - 1)
    spec = JumpSpec("DrawFromPrior", KIND_PRIOR, 2, fn=model.draw_prior)
    x, betas = _inputs(2)
    q, qxy = _port_branch(spec, 11, x, betas, model=model)
    assert np.all(np.isfinite(q)) and not np.allclose(q, x)

    def lp(a):  # [T, D, C] -> [T, C]
        return np.asarray(jax.vmap(jax.vmap(jmodel.lnpriorfn, in_axes=1), in_axes=0)(
            jnp.asarray(a)))

    np.testing.assert_allclose(qxy, lp(x) - lp(q), rtol=1e-5, atol=1e-4)


def _config4(s):
    """The config-4 cycle of examples/hierarchical_gaussian.py in a sampler's
    ``_build_config``."""
    weights = dict(SCAM=20, AM=20, DE=20, NUTS=0, MALA=0, HMC=0, CHEES=0)
    return s._build_config(weights, 2000, 100, 500, 2, dict(stepsize=0.1, nminsteps=2,
                                                              nmaxsteps=300))


def test_config4_cycle_names_and_probabilities_equal_the_jax_config(tmp_path):
    model, jmodel = HierarchicalGaussian(), JHierarchical()
    s = PTSampler(model.ndim, model.lnlikefn, model.lnpriorfn, np.eye(model.ndim),
                  ntemps=2, nchains=8, outDir=str(tmp_path / "port"), device="cpu",
                  verbose=False)
    s.addProposalToCycle(lambda rng, x, it, beta: (x, 0.0), 5, name="SmallGauss")
    s.addPriorDrawToCycle(model.draw_prior, 2)
    js = JPTSampler(jmodel.ndim, jmodel.lnlikefn, jmodel.lnpriorfn, np.eye(jmodel.ndim),
                    ntemps=2, nchains=8, outDir=str(tmp_path / "jax"), verbose=False,
                    swap_mode="sweep")
    js.addProposalToCycle(lambda key, x, it, beta: (x, jnp.zeros(())), 5, name="SmallGauss")
    js.addPriorDrawToCycle(jmodel.draw_prior, 2)
    cfg, jcfg = _config4(s), _config4(js)
    assert cfg.jump_names() == jcfg.jump_names() == (
        "covarianceJumpProposalSCAM", "covarianceJumpProposalAM", "DEJump", "SmallGauss",
        "DrawFromPrior")
    assert [j.kind for j in cfg.jumps] == [j.kind for j in jcfg.jumps]
    for it in (0, 1, 2000, 2001, 9999):
        np.testing.assert_allclose(jump_probabilities(cfg, it),
                                   np.asarray(j_cycle.jump_probabilities(jcfg, it)),
                                   rtol=0, atol=TOL)


def test_draw_prior_sample_moments_match_the_prior():
    model = HierarchicalGaussian()
    n = 20000
    rng = torch.Generator()
    rng.manual_seed(4)
    q = custom.batch_draw(model.draw_prior)(rng, torch.zeros((1, model.ndim, n)))[0]
    q = q.double().numpy()  # [D, n]
    var_th = model.s_mu**2 + model.s_t**2
    cov = np.cov(q)
    se = 5 / np.sqrt(n)
    assert np.all(np.abs(q.mean(axis=1)) < se * np.sqrt(var_th))
    np.testing.assert_allclose(np.sqrt(cov[0, 0]), model.s_mu, rtol=5 * np.sqrt(0.5 / n))
    np.testing.assert_allclose(np.diag(cov)[1:].mean(), var_th, rtol=0.02)
    np.testing.assert_allclose(cov[0, 1:].mean(), model.s_mu**2, rtol=0.03)
    off = cov[1:, 1:][~np.eye(model.ngroups, dtype=bool)]
    np.testing.assert_allclose(off.mean(), model.s_mu**2, rtol=0.03)


def test_prior_draw_jump_correctness_prior_only(tmp_path):
    """With a flat likelihood a cycle of the prior draw alone samples the
    prior: every proposal accepted (qxy cancels exactly)."""
    model = HierarchicalGaussian()
    ndim = model.ndim
    s = PTSampler(ndim, lambda x: torch.zeros(()), model.lnpriorfn, np.eye(ndim) * 0.1,
                  ntemps=1, nchains=32, outDir=str(tmp_path), verbose=False, seed=3,
                  device="cpu")
    s.addPriorDrawToCycle(model.draw_prior, 10)
    s.sample(np.zeros(ndim), 1500, burn=200, thin=1, isave=500, covUpdate=500,
             SCAMweight=0, AMweight=0, DEweight=0, NUTSweight=0, HMCweight=0, MALAweight=0)
    names = s.config.jump_names()
    assert names == ("DrawFromPrior",)
    prop = int(s.state.counters.jump_proposed[0].sum())
    acc = int(s.state.counters.jump_accepted[0].sum())
    assert prop == 1500 * 32 and acc == prop
    mu = s.pooled_chain[32 * 300:, 0]
    assert abs(mu.mean()) < 0.35
    np.testing.assert_allclose(mu.std(), model.s_mu, rtol=0.15)


def _glo():
    return CorrelatedGaussian(ndim=6, pmin=-10, pmax=10)


def test_custom_torch_jump(tmp_path):
    glo = _glo()

    def uniform_jump(rng, x, it, beta):
        return torch.rand(x.shape, generator=rng, device=x.device) * 20.0 - 10.0, 0.0

    s = PTSampler(6, glo.lnlikefn, glo.lnpriorfn, np.eye(6) * 0.5, ntemps=1, nchains=8,
                  outDir=str(tmp_path), verbose=False, seed=2, device="cpu")
    s.addProposalToCycle(uniform_jump, 5, name="UniformJump")
    s.sample(np.clip(glo.mu, -9, 9), 1000, burn=200, thin=1, covUpdate=200, isave=500,
             SCAMweight=20, AMweight=20, DEweight=20)
    names = s.config.jump_names()
    assert "UniformJump" in names and s.route == "plain"
    assert int(s.state.counters.jump_proposed[names.index("UniformJump")].sum()) > 0


def test_custom_numpy_jump_fallback(tmp_path):
    glo = _glo()

    def numpy_uniform_jump(x, it, beta):
        return np.random.uniform(-10, 10, len(x)), 0.0

    s = PTSampler(6, glo.lnlikefn, glo.lnpriorfn, np.eye(6) * 0.5, ntemps=1, nchains=2,
                  outDir=str(tmp_path), verbose=False, seed=3, device="cpu")
    s.addProposalToCycle(numpy_uniform_jump, 5, name="UniformJump")
    assert s._custom_jumps[0].protocol == "host"
    s.sample(np.clip(glo.mu, -9, 9), 200, burn=100, thin=1, covUpdate=100, isave=100,
             SCAMweight=20, AMweight=20, DEweight=20)
    assert s.chain.shape[0] == 201


CONFIG4 = dict(burn=1000, thin=2, isave=1000, covUpdate=500, SCAMweight=20, AMweight=20,
               DEweight=20, NUTSweight=0, HMCweight=0, MALAweight=0, Tskip=100)
CONFIG4_ITERS = 4000


def test_config4_moments_and_acceptance_against_the_jax_sampler(tmp_path):
    model, jmodel = HierarchicalGaussian(), JHierarchical()
    ndim = model.ndim
    mean, cov = model.posterior_moments()
    sd = np.sqrt(np.diag(cov))

    def small_gauss(rng, x, it, beta):
        return x + 0.05 * torch.randn(x.shape, generator=rng, device=x.device), 0.0

    def small_gauss_jax(key, x, it, beta):
        return x + 0.05 * jax.random.normal(key, x.shape, x.dtype), jnp.zeros(())

    s = PTSampler(ndim, model.lnlikefn, model.lnpriorfn, np.eye(ndim) * 0.05, ntemps=2,
                  nchains=64, outDir=str(tmp_path / "port"), verbose=False, seed=11,
                  device="cpu")
    s.addProposalToCycle(small_gauss, 5, name="SmallGauss")
    s.addPriorDrawToCycle(model.draw_prior, 2)
    s.sample(np.zeros(ndim), CONFIG4_ITERS, **CONFIG4)
    js = JPTSampler(ndim, jmodel.lnlikefn, jmodel.lnpriorfn, np.eye(ndim) * 0.05, ntemps=2,
                    nchains=64, outDir=str(tmp_path / "jax"), verbose=False, seed=11)
    js.addProposalToCycle(small_gauss_jax, 5, name="SmallGauss")
    js.addPriorDrawToCycle(jmodel.draw_prior, 2)
    js.sample(np.zeros(ndim), CONFIG4_ITERS, **CONFIG4)

    assert s.config.jump_names() == js.config.jump_names()
    for sampler in (s, js):
        post = sampler.chains[:, CONFIG4["burn"] // CONFIG4["thin"]:].reshape(-1, ndim)
        err = np.abs(post.mean(axis=0) - mean) / sd
        assert np.all(err < 0.5), err.max()
        np.testing.assert_allclose(post.std(axis=0), sd, rtol=0.25)
    for name in s.config.jump_names():
        rate = np.loadtxt(str(tmp_path / "port" / f"{name}_jump.txt"))[-1]
        jrate = np.loadtxt(str(tmp_path / "jax" / f"{name}_jump.txt"))[-1]
        assert abs(rate - jrate) < ACC_TOL, (name, rate, jrate)


# ---- run_block's graphs (simulated on the CPU) with the user's jumps ----

def _it_jump(rng, x, it, beta):
    """A symmetric Gaussian step whose size follows the iteration."""
    scale = 0.05 + 0.01 * (it % 7).to(x.dtype)
    return x + scale * torch.randn(x.shape, generator=rng, device=x.device), 0.0


def _it_aux(rng, x, q, it, beta):
    """Reflects the last coordinate about x's on odd iterations."""
    flip = (it % 2).to(q.dtype)
    last = q[-1] - flip * 2.0 * (q[-1] - x[-1])
    return torch.cat([q[:-1], last[None]]), 0.0


def _numpy_jump(x, it, beta):
    return x + 0.01 * np.sin(it + np.arange(len(x))), 0.0


def _numpy_aux(x, q, it, beta):
    return q + 1e-3 * (it % 3), 0.0


def _graph_config(model, custom_jumps, aux_jumps=()):
    d = model.ndim
    return SamplerConfig(
        ndim=d, ntemps=3, nchains=8, groups=(tuple(range(d)),),
        jumps=build_default_jumps(SCAMweight=10, AMweight=10, DEweight=10, CHEESweight=10,
                                  burn=12, have_grads=True) + tuple(custom_jumps),
        aux_jumps=tuple(aux_jumps), tskip=3, cov_update=10, burn=12, thin=2, de_size=16,
        hmc_stepsize=0.08, chees_max_steps=16)


def _graph_state(cfg, model):
    d, t, c = cfg.ndim, cfg.ntemps, cfg.nchains
    x0 = np.full(d, 0.3)
    xs = torch.tensor(x0, dtype=torch.float32)[None, :, None].expand(t, d, c)
    return init_state(cfg, 5, x0, np.eye(d), 1.0 / 1.5 ** np.arange(t), model.lnlike(xs),
                      model.lnprior(xs), device="cpu")


def _simulate_graphs(monkeypatch):
    monkeypatch.setattr(t_kernel, "_graphs_on", lambda device: True)
    monkeypatch.setattr(t_kernel, "_CudaGraphs", _SimulatedGraphs)


def _runner_against_eager(cfg, model, monkeypatch, blocks=(6, 9)):
    step, _ = build_step(cfg, model, device="cpu")
    eager = _graph_state(cfg, model)
    outs = []
    for n in blocks:
        eager, out = eager_run_block(step, cfg, eager, n)
        outs.append(out)
    _simulate_graphs(monkeypatch)
    _, run_block = build_step(cfg, model, device="cpu")
    state = _graph_state(cfg, model)
    for n, ref in zip(blocks, outs):
        state, out = run_block(state, n)
        assert_outputs_equal(out, ref)
    assert_states_equal(state, eager)
    return run_block.stats


def test_jumps_that_read_it_replay_with_the_true_iteration(monkeypatch):
    """A custom and an auxiliary jump whose results depend on ``it`` give
    the eager loop's states under the graph stand-in, which holds every
    host value of its capture: a frozen ``it`` would differ."""
    model = HierarchicalGaussian(ngroups=4)
    x = torch.zeros((1, model.ndim, 2))
    rng = torch.Generator()
    q3 = custom.batch_jump(_it_jump)(rng.manual_seed(1), x, torch.ones(1), torch.tensor(3))[0]
    q4 = custom.batch_jump(_it_jump)(rng.manual_seed(1), x, torch.ones(1), torch.tensor(4))[0]
    assert not torch.equal(q3, q4)
    cfg = _graph_config(model, [JumpSpec("ItJump", KIND_CUSTOM, 10, fn=_it_jump),
                                JumpSpec("DrawFromPrior", KIND_PRIOR, 10, fn=model.draw_prior)],
                        [JumpSpec("ItAux", KIND_CUSTOM, 1, fn=_it_aux)])
    stats = _runner_against_eager(cfg, model, monkeypatch, blocks=(10, 15))
    kinds = {key[0] for key in stats.replays}
    assert {cfg.jump_names().index("ItJump"), cfg.jump_names().index("DrawFromPrior")} <= kinds
    assert stats.eager["host jump"] == 0


@pytest.mark.parametrize("where", ["jump", "aux"])
def test_numpy_jumps_run_eagerly_on_their_own_iterations(monkeypatch, where):
    model = HierarchicalGaussian(ngroups=4)
    jumps = [JumpSpec("NumpyJump", KIND_CUSTOM, 10, fn=_numpy_jump, protocol="host")]
    aux = [JumpSpec("NumpyAux", KIND_CUSTOM, 1, fn=_numpy_aux, protocol="host")]
    cfg = (_graph_config(model, jumps) if where == "jump" else
           _graph_config(model, [JumpSpec("ItJump", KIND_CUSTOM, 10, fn=_it_jump)], aux))
    stats = _runner_against_eager(cfg, model, monkeypatch)
    if where == "jump":
        own = cfg.jump_names().index("NumpyJump")
        assert stats.eager["host jump"] > 0
        assert stats.eager["host jump"] + stats.eager["warm-up"] + sum(
            stats.replays.values()) == 30
        assert sum(stats.replays.values()) > 0 and own not in {k[0] for k in stats.replays}
    else:
        assert stats.eager["host jump"] == 30 and not stats.replays


# ---- resume and the checkpoint across the packages ----

def _draw_numpy(model):
    def draw(np_rng):
        mu = model.s_mu * np_rng.normal()
        return np.concatenate([[mu], mu + model.s_t * np_rng.normal(size=model.ngroups)])
    return draw


def _config4_run(outdir, niter, resume):
    model = HierarchicalGaussian(ngroups=9)
    s = PTSampler(model.ndim, model.lnlikefn, model.lnpriorfn, np.eye(model.ndim) * 0.05,
                  ntemps=2, nchains=8, outDir=outdir, verbose=False, seed=9, resume=resume,
                  device="cpu")
    s.addProposalToCycle(_it_jump, 5, name="SmallGauss")
    s.addPriorDrawToCycle(_draw_numpy(model), 2)
    s.addAuxilaryJump(_it_aux, name="ItAux")
    s.sample(np.zeros(model.ndim), niter, burn=100, thin=2, isave=100, covUpdate=100,
             SCAMweight=20, AMweight=20, DEweight=20, NUTSweight=0, HMCweight=0,
             MALAweight=0, Tskip=5)
    return s


def _files(outdir):
    out = {}
    for name in sorted(os.listdir(outdir)):
        if not name.startswith("checkpoint"):
            with open(os.path.join(outdir, name), "rb") as f:
                out[name] = f.read()
    return out


def test_config4_resume_equals_an_unbroken_run(tmp_path):
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    s_full = _config4_run(full, 400, False)
    _config4_run(part, 200, False)
    s_part = _config4_run(part, 400, True)
    assert s_part.config.jump_names() == s_full.config.jump_names()
    assert "SmallGauss_jump.txt" in _files(full) and "DrawFromPrior_jump.txt" in _files(full)
    assert _files(part) == _files(full)
    assert set(state_to_numpy(s_part.state)) == set(state_to_numpy(s_full.state))
    for k, v in state_to_numpy(s_full.state).items():
        np.testing.assert_array_equal(state_to_numpy(s_part.state)[k], v, err_msg=k)


def test_config4_checkpoint_loads_in_the_jax_package_and_back(tmp_path):
    out = str(tmp_path / "chains")
    s = _config4_run(out, 200, False)
    cfg = s.config
    assert cfg.njumps == 5
    jcfg = j_config.SamplerConfig(
        ndim=cfg.ndim, ntemps=2, nchains=8, groups=cfg.groups,
        jumps=j_config.build_default_jumps(SCAMweight=20, AMweight=20, DEweight=20, burn=100)
        + (j_config.JumpSpec("SmallGauss", j_config.KIND_CUSTOM, 5, fn=reflect_jax),
           j_config.JumpSpec("DrawFromPrior", j_config.KIND_PRIOR, 2, fn=reflect_jax)),
        tskip=5, cov_update=100, burn=100, thin=2, de_size=cfg.de_size)
    template = j_init_state(jcfg, jax.random.key(0), np.zeros(cfg.ndim), np.eye(cfg.ndim),
                            np.ones(2), np.zeros((2, 8)), np.zeros((2, 8)))
    loaded, meta = j_load_checkpoint(os.path.join(out, "checkpoint.npz"), template)
    assert meta["iter"] == 200
    ours = state_to_numpy(s.state)
    for leaf_path, leaf in jax.tree_util.tree_flatten_with_path(loaded)[0]:
        name = _path_name(leaf_path)
        if name != "key":
            np.testing.assert_array_equal(np.asarray(leaf), ours[name], err_msg=name)
    assert np.asarray(loaded.counters.jump_proposed).shape == (5, 2, 8)
    back_path = str(tmp_path / "back.npz")
    j_save_checkpoint(back_path, loaded, meta=meta)
    back, _, restored = load_checkpoint(back_path, cfg, "cpu", seed=0)
    assert not restored
    for k, v in state_to_numpy(back).items():
        np.testing.assert_array_equal(v, ours[k], err_msg=k)
