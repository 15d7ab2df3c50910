"""The port's ``PTSampler`` on the CPU: against the JAX package's on the same
configuration, the user-callable routes and refusals, what the user-jump
methods register, JAX checkpoints loaded and continued by the port, and
mirrors of the JAX package's ``tests/test_sampler_e2e.py`` (all but its
Pallas-reshape test; its custom-jump tests are mirrored in
``tests/test_torch_custom_jumps.py``) and ``tests/test_resume_progress.py``,
and of the chain-file resume tests of ``tests/test_resume_fixes.py``.

The pair of runs (curved likelihood, 2 temperatures x 16 chains,
SCAM/AM/DE/ChEES at 10/10/10/20, 1000 iterations) is held:

* byte for byte where no random number enters: ``jumps.txt``, the set of
  file names, row 0's parameter and rate columns;
* within ``LNP_TOL`` on row 0's lnprob and lnlike: each package evaluates
  the model at ``p0`` in float32 in its own operation order, and ``%f``
  prints six decimals;
* statistically elsewhere (torch generators cannot replay JAX's streams):
  equal row, column and jump-series counts, each jump's pooled cold
  acceptance within ``ACC_TOL``, and both runs' moments through the bench's
  moment gate.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptmcmcsampler_torch import PTSampler, SamplerConfig, build_default_jumps
from ptmcmcsampler_torch.diagnostics import moment_gate
from ptmcmcsampler_torch.io.checkpoint import load_checkpoint
from ptmcmcsampler_torch.models import CurvedLikelihood
from ptmcmcsampler_torch.sampler import _wrap_fn
from ptmcmcsampler_torch.state import state_to_numpy
from ptmcmcsampler_tpu import PTSampler as JPTSampler
from ptmcmcsampler_tpu.models import CurvedLikelihood as JCurved

torch.set_num_threads(2)

T, C, NITER, BURN, ISAVE = 2, 16, 1000, 200, 250
P0 = [-0.1, -0.5]
LNP_TOL = 2e-6  # %f rounds to 1e-6; f32 evaluation orders differ by ulps
ACC_TOL = 0.08  # ~5 binomial standard deviations of the rate difference
# f32 exp/log1p differ between XLA and PyTorch by ulps (tests/test_torch_model.py).
RTOL, ATOL = 1e-5, 1e-6
SAMPLE_KW = dict(burn=BURN, Tskip=5, isave=ISAVE, covUpdate=250, thin=1, SCAMweight=10,
                 AMweight=10, DEweight=10, CHEESweight=20, NUTSweight=0, HMCweight=0,
                 MALAweight=0, HMCstepsize=0.08)


def _jax_sampler(outdir, **kw):
    cl = JCurved()
    return JPTSampler(2, cl.lnlikefn, cl.lnpriorfn, np.eye(2), logl_grad=cl.lnlikefn_grad,
                      logp_grad=cl.lnpriorfn_grad, ntemps=T, nchains=C, seed=7,
                      outDir=outdir, verbose=False, **kw)


def _port_sampler(outdir, **kw):
    cl = CurvedLikelihood()
    kw.setdefault("verbose", False)
    return PTSampler(2, cl.lnlikefn, cl.lnpriorfn, np.eye(2), logl_grad=cl.lnlikefn_grad,
                     logp_grad=cl.lnpriorfn_grad, ntemps=T, nchains=C, seed=7,
                     outDir=outdir, device="cpu", **kw)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("pair")
    jdir, pdir = str(root / "jax"), str(root / "port")
    js = _jax_sampler(jdir)
    js.sample(P0, NITER, **SAMPLE_KW)
    ps = _port_sampler(pdir)
    ps.sample(P0, NITER, **SAMPLE_KW)
    return (js, jdir), (ps, pdir)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_pair_file_names_and_jumps_byte_equal(pair):
    (_, jdir), (_, pdir) = pair
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    assert _read(os.path.join(pdir, "jumps.txt")) == _read(os.path.join(jdir, "jumps.txt"))


def test_pair_initial_row(pair):
    (_, jdir), (_, pdir) = pair
    jrow = _read(os.path.join(jdir, "chain_1.0.txt")).split(b"\n")[0].split(b"\t")
    prow = _read(os.path.join(pdir, "chain_1.0.txt")).split(b"\n")[0].split(b"\t")
    assert len(prow) == len(jrow) == 6
    assert prow[:2] == jrow[:2] and prow[4:] == jrow[4:]
    np.testing.assert_allclose([float(v) for v in prow[2:4]], [float(v) for v in jrow[2:4]],
                               rtol=0, atol=LNP_TOL)


def test_pair_counts_acceptance_and_moments(pair):
    (js, jdir), (ps, pdir) = pair
    jdata = np.loadtxt(os.path.join(jdir, "chain_1.0.txt"), ndmin=2)
    pdata = np.loadtxt(os.path.join(pdir, "chain_1.0.txt"), ndmin=2)
    assert pdata.shape == jdata.shape == (1 + NITER, 6)
    assert ps.config.jump_names() == js.config.jump_names()
    for name in ps.config.jump_names():
        jrates = np.loadtxt(os.path.join(jdir, name + "_jump.txt"), ndmin=1)
        prates = np.loadtxt(os.path.join(pdir, name + "_jump.txt"), ndmin=1)
        assert len(prates) == len(jrates) == NITER // ISAVE
        assert abs(prates[-1] - jrates[-1]) < ACC_TOL, (name, prates[-1], jrates[-1])
    target, _ = CurvedLikelihood().posterior_moments()
    for s in (js, ps):
        assert s.chains.shape == (C, 1 + NITER, 2)
        ok, max_z, _ = moment_gate(s.chains[:, BURN:], target)
        assert ok, max_z


def test_jax_checkpoint_loads_into_the_port(pair):
    """Every array of a JAX checkpoint arrives unchanged (the JAX key is not
    a torch stream: the generators are seeded, and the loader says so)."""
    (_, jdir), _ = pair
    cfg = SamplerConfig(
        ndim=2, ntemps=T, nchains=C, groups=((0, 1),),
        jumps=build_default_jumps(SCAMweight=10, AMweight=10, DEweight=10, CHEESweight=20,
                                  burn=BURN, have_grads=True),
        tskip=5, cov_update=250, burn=BURN, thin=1, de_size=max(BURN, C), hmc_stepsize=0.08,
    )
    path = os.path.join(jdir, "checkpoint.npz")
    state, meta, restored = load_checkpoint(path, cfg, "cpu", seed=0)
    assert not restored and meta["iter"] == NITER and meta["swap_mode"] == "sweep"
    with np.load(path) as data:
        stored = {k: data[k] for k in data.files if k not in ("__format__", "key")}
    ours = state_to_numpy(state)
    assert set(ours) == set(stored)
    ring = stored["de/buf"].shape[1]
    filled = int(stored.pop("de/filled"))  # the JAX count runs on; the port's stays < 2 B
    assert int(ours["de/filled"]) % ring == filled % ring
    assert min(int(ours["de/filled"]), ring) == min(filled, ring)
    for name, a in stored.items():
        np.testing.assert_array_equal(ours[name], a, err_msg=name)


def test_port_resumes_a_jax_run_directory(pair, tmp_path, capsys):
    (_, jdir), _ = pair
    out = str(tmp_path / "chains")
    shutil.copytree(jdir, out)
    s = _port_sampler(out, resume=True, verbose=True)
    s.sample(P0, 2 * NITER, **SAMPLE_KW)
    text = capsys.readouterr().out
    assert f"Resuming from checkpoint at iteration {NITER}" in text
    assert "percent of new work" in text
    data = np.loadtxt(os.path.join(out, "chain_1.0.txt"), ndmin=2)
    assert data.shape == (1 + 2 * NITER, 6)
    assert s.chains.shape == (C, 1 + 2 * NITER, 2)
    assert len(np.loadtxt(os.path.join(out, "DEJump_jump.txt"))) == 2 * NITER // ISAVE
    assert torch.isfinite(s.state.x).all() and s.state.it == 2 * NITER


def _grid(n=300, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(scale=0.5, size=(n, 2)) + np.array([0.0, 1.0])
    pts[:20] = rng.uniform(-12, 12, size=(20, 2))  # some outside the prior box
    return pts.astype(np.float32)


@pytest.mark.parametrize("what", ["lnlike", "lnprior", "lnlike_grad", "lnprior_grad"])
def test_vmapped_callables_match_batched_model_and_jax(what):
    """The per-point methods, batched by the sampler's vmap wrapper, equal
    the batched model (rtol 1e-6) and the JAX model's methods vmapped on
    the same points (RTOL, ATOL)."""
    cl, jcl = CurvedLikelihood(), JCurved()
    pts = _grid()
    grad = what.endswith("_grad")
    name = {"lnlike": "lnlikefn", "lnprior": "lnpriorfn"}[what.replace("_grad", "")]
    fn, traceable = _wrap_fn(getattr(cl, name + ("_grad" if grad else "")), [], {}, 2, "cpu",
                             grad=grad)
    assert traceable
    x = torch.from_numpy(pts.T.copy())  # [D, C]
    got = fn(x)
    jout = jax.vmap(getattr(jcl, name + ("_grad" if grad else "")))(jnp.asarray(pts))
    if grad:
        v, g = got
        if name == "lnlikefn":  # value_grad's value adds the prior
            bv, bg = cl.lnlike(x), cl.value_grad(x, torch.tensor(1.0))[1]
        else:
            bv, bg = cl.lnprior(x), torch.zeros_like(x)
        torch.testing.assert_close(v, bv, rtol=1e-6, atol=0)
        torch.testing.assert_close(g, bg, rtol=1e-6, atol=0)
        np.testing.assert_allclose(v.numpy(), np.asarray(jout[0]), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g.numpy().T, np.asarray(jout[1]), rtol=RTOL, atol=ATOL)
    else:
        batched = getattr(cl, what)(x)
        torch.testing.assert_close(got, batched, rtol=1e-6, atol=0)
        np.testing.assert_allclose(got.numpy(), np.asarray(jout), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- routes


def _curved_callables(kind):
    cl = CurvedLikelihood()
    if kind == "bound":
        return cl.lnlikefn, cl.lnpriorfn, cl.lnlikefn_grad, cl.lnpriorfn_grad
    return (lambda x: cl.lnlikefn(x), lambda x: cl.lnpriorfn(x),
            lambda x: cl.lnlikefn_grad(x), lambda x: cl.lnpriorfn_grad(x))


@pytest.mark.parametrize("kind, kwargs, route", [
    ("bound", {}, "kernel"),
    ("bound", {"loglargs": [], "logpkwargs": {}}, "kernel"),
    ("lambda", {}, "plain"),
    ("bound", {"logpkwargs": {"scale": 1.0}}, "host"),
    ("two_objects", {}, "plain"),
])
def test_route_choice(tmp_path, capsys, kind, kwargs, route):
    """The kernel route takes the four bound methods of one model with a
    functor and no extra arguments; anything else is the plain route, or the
    host route where a callable does not batch under ``torch.func.vmap``
    (``lnpriorfn`` takes no ``scale``)."""
    ll, lp, llg, lpg = _curved_callables("lambda" if kind == "lambda" else "bound")
    if kind == "two_objects":
        lp = CurvedLikelihood().lnpriorfn
    s = PTSampler(2, ll, lp, np.eye(2), logl_grad=llg, logp_grad=lpg, outDir=str(tmp_path),
                  device="cpu", **kwargs)
    assert s.route == route
    text = capsys.readouterr().out
    if route == "kernel":
        assert s._model.cuda_functor == "curved"
        assert "Model route: kernel (functor 'curved')" in text
    else:
        assert not hasattr(s._model, "cuda_functor")
        assert ("Model route: plain PyTorch on cpu" if route == "plain" else
                "Model route: host callables from plain PyTorch on cpu") in text


@pytest.mark.parametrize("kind, kwargs, refused", [
    ("bound", {}, False),
    ("lambda", {}, True),
    ("numpy", {}, True),
    ("bound", {"logpkwargs": {"scale": 1.0}}, True),
])
def test_card_refuses_gradients_without_a_functor(tmp_path, monkeypatch, kind, kwargs,
                                                  refused):
    """On the card a kernel wrapper launches its kernel or raises, so a model
    with gradients but no functor route is refused there at construction,
    naming the CPU and how to register a functor; the bound methods of a model with
    a functor take the kernel route. The constructor allocates nothing on
    the device on either branch, so a stand-in device suffices here."""
    from ptmcmcsampler_torch import sampler as sampler_module

    monkeypatch.setattr(sampler_module.utils, "resolve_device",
                        lambda device, what: torch.device("cuda"))
    if kind == "numpy":
        fns = (lambda x: -0.5 * np.sum(x**2), lambda x: 0.0,
               lambda x: (-0.5 * np.sum(x**2), -x), lambda x: (0.0, np.zeros(2)))
    else:
        fns = _curved_callables(kind)
    make = lambda: PTSampler(2, fns[0], fns[1], np.eye(2), logl_grad=fns[2],  # noqa: E731
                             logp_grad=fns[3], outDir=str(tmp_path), verbose=False, **kwargs)
    if refused:
        with pytest.raises(NotImplementedError, match=r'register_functor.*device="cpu"'):
            make()
    else:
        s = make()
        assert s.route == "kernel" and s.device.type == "cuda"


def test_without_grads_no_gradient_jump(tmp_path):
    cl = CurvedLikelihood()
    s = PTSampler(2, cl.lnlikefn, cl.lnpriorfn, np.eye(2), ntemps=1, nchains=4,
                  outDir=str(tmp_path), device="cpu", verbose=False)
    s.sample(P0, 20, burn=10, thin=1, isave=10, CHEESweight=20, NUTSweight=20, HMCweight=20,
             MALAweight=20)
    assert s.route == "plain"
    assert s.config.jump_names() == ("covarianceJumpProposalSCAM", "covarianceJumpProposalAM",
                                     "DEJump")


@pytest.mark.parametrize("call, error, item", [
    ("mesh", TypeError, "PTMesh"),  # a mesh is a parallel.PTMesh (ROADMAP A12, done)
    ("dtype", ValueError, "float32"),
])
def test_refusals_name_the_item(tmp_path, call, error, item):
    ll, lp, llg, lpg = _curved_callables("bound")
    kw = dict(outDir=str(tmp_path), device="cpu", verbose=False)
    with pytest.raises(error, match=item):
        if call == "mesh":
            PTSampler(2, ll, lp, np.eye(2), mesh=object(), **kw)
        else:
            PTSampler(2, ll, lp, np.eye(2), dtype=np.float64, **kw)


# One callable of each user-jump method in each protocol: torch-native, or
# numpy (run on the host). The reference's signatures without ``rng`` are
# batched on the device when vmap batches them.
_USER_JUMPS = {
    ("addProposalToCycle", "torch"): lambda rng, x, it, beta: (
        x + 0.1 * torch.randn(x.shape, generator=rng, device=x.device), 0.0),
    ("addProposalToCycle", "host"): lambda x, it, beta: (
        x + 0.1 * np.random.standard_normal(len(x)), 0.0),
    ("addPriorDrawToCycle", "torch"): lambda rng: torch.rand(
        2, generator=rng, device=rng.device) - 0.5,
    ("addPriorDrawToCycle", "host"): lambda np_rng: np_rng.uniform(-0.5, 0.5, 2),
    ("addAuxilaryJump", "torch"): lambda x, q, it, beta: (q.flip(0), 0.0),
    ("addAuxilaryJump", "host"): lambda x, q, it, beta: (np.asarray(q)[::-1], 0.0),
}


@pytest.mark.parametrize("call, protocol", sorted(_USER_JUMPS))
def test_user_jump_methods_register_their_jump(tmp_path, call, protocol):
    """Each method registers one ``JumpSpec`` with the name, kind and
    protocol its callable implies, in the JAX package's place (custom jumps
    after the built-in ones, auxiliary jumps in ``aux_jumps``); the model's
    route does not change."""
    ll, lp, llg, lpg = _curved_callables("bound")
    s = PTSampler(2, ll, lp, np.eye(2), logl_grad=llg, logp_grad=lpg, outDir=str(tmp_path),
                  device="cpu", verbose=False)
    fn = _USER_JUMPS[call, protocol]
    if call == "addAuxilaryJump":
        s.addAuxilaryJump(fn, name="Aux")
    else:
        getattr(s, call)(fn, 3, name="Mine")
        getattr(s, call)(fn, 0, name="Dropped")  # weight 0: not registered
    weights = dict(SCAM=10, AM=10, DE=10, NUTS=0, MALA=0, HMC=0, CHEES=20)
    cfg = s._build_config(weights, 100, 5, 100, 1, {})
    if call == "addAuxilaryJump":
        (spec,) = cfg.aux_jumps
        assert (spec.name, spec.kind) == ("Aux", "custom")
        assert len(cfg.jumps) == 4
    else:
        assert cfg.jump_names()[4:] == ("Mine",)
        spec = cfg.jumps[4]
        assert (spec.kind, spec.weight) == (
            "custom" if call == "addProposalToCycle" else "prior_draw", 3)
    assert spec.protocol == protocol
    assert s.route == "kernel"


def test_defaults_to_the_card(tmp_path):
    ll, lp, _, _ = _curved_callables("bound")
    if torch.cuda.is_available():
        assert PTSampler(2, ll, lp, np.eye(2), outDir=str(tmp_path)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PTSampler(2, ll, lp, np.eye(2), outDir=str(tmp_path))


def test_tpu_dispatch_keywords_are_accepted(tmp_path, capsys):
    ll, lp, _, _ = _curved_callables("bound")
    s = PTSampler(2, ll, lp, np.eye(2), outDir=str(tmp_path), device="cpu", rng_impl="rbg",
                  use_pallas=True, nuts_impl="xla", nuts_pass1_depth=0,
                  per_chain_mode="stacked",
                  comm=object())
    s.sample(P0, 20, burn=10, thin=1, isave=10, maxIter=100, profile_dir=str(tmp_path / "prof"))
    assert "maxIter/i0 are accepted" in capsys.readouterr().out
    assert os.path.isfile(str(tmp_path / "prof" / "trace.json"))


# ------------------------------------------- mirrors of test_sampler_e2e.py


class GaussianLikelihood:
    """The reference test model (tests/test_simple.py:14-41), in torch."""

    def __init__(self, ndim=20, pmin=-10.0, pmax=10.0, seed=42):
        self.a = np.ones(ndim) * pmin
        self.b = np.ones(ndim) * pmax
        rng = np.random.default_rng(seed)
        self.mu = rng.uniform(pmin, pmax, ndim)
        cov = 0.5 - rng.random(ndim**2).reshape((ndim, ndim))
        cov = np.triu(cov)
        cov += cov.T - np.diag(cov.diagonal())
        self.cov = np.dot(cov, cov)
        self.icov = np.linalg.inv(self.cov)
        self._mu = torch.tensor(self.mu, dtype=torch.float32)
        self._icov = torch.tensor(self.icov, dtype=torch.float32)
        self._a = torch.tensor(self.a, dtype=torch.float32)
        self._b = torch.tensor(self.b, dtype=torch.float32)

    def lnlikefn(self, x):
        diff = x - self._mu
        return -torch.dot(diff, self._icov @ diff) / 2.0

    def lnpriorfn(self, x):
        inside = torch.all(self._a <= x) & torch.all(self._b >= x)
        return torch.where(inside, 0.0, float("-inf"))


@pytest.fixture
def glo():
    return GaussianLikelihood(ndim=6, pmin=-10, pmax=10)


def _glo_sampler(glo, outdir, **kw):
    ndim = len(glo.mu)
    defaults = dict(ntemps=2, nchains=16, outDir=outdir, verbose=False, seed=1, device="cpu")
    defaults.update(kw)
    return PTSampler(ndim, glo.lnlikefn, glo.lnpriorfn, np.eye(ndim) * 0.5, **defaults)


def run_sampler(glo, tmp_path, niter=3000, **kw):
    sampler = _glo_sampler(glo, str(tmp_path / "chains"), **kw)
    sampler.sample(
        np.clip(glo.mu + 0.1, -9, 9), niter, burn=500, thin=2, covUpdate=500, isave=500,
        SCAMweight=20, AMweight=20, DEweight=20, Tskip=50,
    )
    return sampler


def _resume(glo, tmp_path, niter):
    s2 = _glo_sampler(glo, str(tmp_path / "chains"), resume=True)
    s2.sample(
        np.clip(glo.mu + 0.1, -9, 9), niter, burn=500, thin=2, covUpdate=500,
        isave=500, SCAMweight=20, AMweight=20, DEweight=20, Tskip=50,
    )
    return s2


class TestSimpleSampler:
    def test_runs_and_writes_chains(self, glo, tmp_path):
        sampler = run_sampler(glo, tmp_path)
        outdir = str(tmp_path / "chains")
        data = np.loadtxt(os.path.join(outdir, "chain_1.0.txt"), ndmin=2)
        assert data.shape[1] == sampler.ndim + 4
        assert data.shape[0] == 1 + 3000 // 2
        # Per-row cumulative acceptance (PTMCMCSampler.py:731-745): it
        # varies inside an isave block.
        assert np.all(data[1:, -2] >= 0) and np.all(data[1:, -2] <= 1)
        assert data[-1, -2] > 0
        isave_rows = 500 // 2
        assert np.unique(data[1 : 1 + isave_rows, -2]).size > isave_rows // 4
        for name in ("cov.npy", "jumps.txt", "covarianceJumpProposalAM_jump.txt"):
            assert os.path.isfile(os.path.join(outdir, name))

    def test_posterior_moments(self, glo, tmp_path):
        sampler = run_sampler(glo, tmp_path, niter=6000, nchains=48)
        samples = sampler.chain[500:]
        err = np.abs(samples.mean(axis=0) - glo.mu) / np.sqrt(np.diag(glo.cov))
        assert np.all(err < 1.0)

    @pytest.mark.parametrize("grads", [False, True])
    def test_numpy_loglike_fallback(self, tmp_path, grads):
        """numpy callables run on the host, one call a point; with numpy
        gradients the gradient jumps run too (ChEES and HMC here)."""
        ndim = 3

        def lnlike(x):
            return float(-0.5 * np.sum(x**2))

        def lnprior(x):
            return 0.0 if np.all(np.abs(x) < 10) else float(-np.inf)

        extra, weights = {}, {}
        if grads:
            extra = dict(logl_grad=lambda x: (lnlike(x), list(-x)),
                         logp_grad=lambda x: (lnprior(x), np.zeros(ndim)))
            weights = dict(CHEESweight=20, HMCweight=20, HMCsteps=10, NUTSweight=0,
                           MALAweight=0)
        sampler = PTSampler(ndim, lnlike, lnprior, np.eye(ndim) * 0.25, ntemps=1, nchains=2,
                            outDir=str(tmp_path / "c4"), verbose=False, seed=4, device="cpu",
                            **extra)
        assert not sampler._logl_traceable and not sampler._logp_traceable
        sampler.sample(np.zeros(ndim), 200, burn=100, thin=1, covUpdate=100, isave=100,
                       SCAMweight=20, AMweight=20, DEweight=20, **weights)
        assert sampler.chain.shape[0] == 201
        if grads:
            assert not sampler._logl_grad_traceable and not sampler._logp_grad_traceable
            proposed = dict(zip(sampler.config.jump_names(),
                                sampler.state.counters.jump_proposed[:, 0, 0].tolist()))
            assert proposed["HMCJump"] > 0 and proposed["ChEESHMCJump"] > 0


class TestResume:
    @pytest.mark.parametrize("flow", ["checkpoint", "chain_files"])
    def test_resume_continues(self, glo, tmp_path, flow):
        outdir = str(tmp_path / "chains")
        run_sampler(glo, tmp_path, niter=1000)
        assert os.path.isfile(os.path.join(outdir, "checkpoint.npz"))
        if flow == "chain_files":
            os.remove(os.path.join(outdir, "checkpoint.npz"))
        _resume(glo, tmp_path, 2000)
        data = np.loadtxt(os.path.join(outdir, "chain_1.0.txt"), ndmin=2)
        assert data.shape[0] == 501 + 500

    def test_torn_resume_truncates_jump_series(self, glo, tmp_path):
        outdir = str(tmp_path / "chains")
        run_sampler(glo, tmp_path, niter=1500)
        jf = os.path.join(outdir, "covarianceJumpProposalAM_jump.txt")
        assert len(open(jf).readlines()) == 3
        with open(jf, "a") as f:
            f.write("0.5\n")  # torn post-checkpoint entry
        _resume(glo, tmp_path, 3000)
        assert len(open(jf).readlines()) == 6


class TestNeffTermination:
    @pytest.mark.parametrize("nchains, niter, target", [(16, 100000, 50), (64, 50000, 2000)])
    def test_stops_early(self, glo, tmp_path, nchains, niter, target):
        """The pooled multichain ESS (or, with one chain, iter/tau) drives the
        neff stop well before Niter."""
        ndim = len(glo.mu)
        sampler = PTSampler(ndim, glo.lnlikefn, glo.lnpriorfn, np.copy(glo.cov), ntemps=1,
                            nchains=nchains, outDir=str(tmp_path / "c5"), verbose=False,
                            seed=5, device="cpu")
        sampler.sample(np.clip(glo.mu, -9, 9), niter, burn=100, thin=2, covUpdate=200,
                       isave=200, SCAMweight=20, AMweight=20, DEweight=20, neff=target)
        assert sampler.state.it < niter

    def test_single_chain_stops_on_autocorrelation_time(self, glo, tmp_path):
        ndim = len(glo.mu)
        sampler = PTSampler(ndim, glo.lnlikefn, glo.lnpriorfn, np.copy(glo.cov), ntemps=1,
                            nchains=1, outDir=str(tmp_path / "c7"), verbose=False, seed=5,
                            device="cpu")
        sampler.sample(np.clip(glo.mu, -9, 9), 100000, burn=100, thin=2, covUpdate=200,
                       isave=200, SCAMweight=20, AMweight=20, DEweight=20, neff=50)
        assert sampler.state.it < 100000


class TestAllChainHarvest:
    def test_all_chains_recorded_and_written(self, glo, tmp_path):
        nchains = 64
        sampler = run_sampler(glo, tmp_path, niter=1000, nchains=nchains)
        rows = sampler.chain.shape[0]
        assert rows == 1 + 1000 // 2
        chains = sampler.chains
        assert chains.shape == (nchains, rows, sampler.ndim)
        assert sampler.pooled_chain.shape == (nchains * rows, sampler.ndim)
        np.testing.assert_allclose(chains[0], sampler.chain, rtol=1e-6)
        assert not np.allclose(chains[0, rows // 2:], chains[1, rows // 2:])
        loaded = sampler._writer.load_all(0)
        assert loaded is not None and loaded.shape == (rows, nchains, sampler.ndim)
        np.testing.assert_allclose(np.moveaxis(loaded, 0, 1), chains, rtol=1e-5, atol=1e-6)


def _small(outdir, nchains, seed, resume=True):
    return PTSampler(
        2, lambda x: -0.5 * torch.sum(x**2),
        lambda x: torch.where(torch.all(torch.abs(x) < 10.0), 0.0, float("-inf")),
        np.eye(2) * 0.1, outDir=outdir, verbose=False, ntemps=2, nchains=nchains, seed=seed,
        resume=resume, device="cpu",
    )


SMALL_KW = dict(burn=20, thin=1, isave=50, SCAMweight=1, AMweight=1, DEweight=0, NUTSweight=0,
                HMCweight=0, MALAweight=0)


def test_chainfile_resume_restores_per_chain_positions(tmp_path):
    """Chain-file resume restarts every chain from its own last position
    (the chain_all sidecar), not a broadcast of chain 0's."""
    outdir = str(tmp_path / "chains")
    _small(outdir, 8, 4).sample(np.zeros(2), 100, **SMALL_KW)
    os.remove(os.path.join(outdir, "checkpoint.npz"))
    s2 = _small(outdir, 8, 4)
    s2.sample(np.zeros(2), 150, **SMALL_KW)
    chains = s2.chains
    row = chains[:, min(101, chains.shape[1] - 1), :]
    assert not np.allclose(row, row[0]), "chains restarted degenerate"


def test_resume_falls_back_on_stale_checkpoint(tmp_path):
    """A checkpoint with missing leaves falls back to chain-file resume."""
    outdir = str(tmp_path / "chains")
    _small(outdir, 4, 3).sample(np.zeros(2), 100, **SMALL_KW)
    ckpt = os.path.join(outdir, "checkpoint.npz")
    data = dict(np.load(ckpt, allow_pickle=False))
    keys = [k for k in data if not k.startswith("__") and not k.startswith("torch/")]
    for k in sorted(keys)[-4:]:
        del data[k]
    np.savez(ckpt, **data)
    _small(outdir, 4, 3).sample(np.zeros(2), 200, **SMALL_KW)
    rows = np.loadtxt(os.path.join(outdir, "chain_1.0.txt"), ndmin=2)
    assert rows.shape[0] >= 150


# ----------------------- mirrors of test_resume_progress.py, test_resume_fixes.py


def test_resume_progress_line(tmp_path, capsys):
    out = str(tmp_path / "chains")
    kw = dict(burn=50, thin=1, isave=100, SCAMweight=20, AMweight=20, DEweight=20)
    s = _small(out, 4, 1, resume=False)
    s.verbose = True
    s.sample(np.zeros(2), 200, **kw)
    assert "percent of new work" not in capsys.readouterr().out
    s2 = _small(out, 4, 1)
    s2.verbose = True
    s2.sample(np.zeros(2), 400, **kw)
    assert "percent of new work" in capsys.readouterr().out


@pytest.mark.parametrize("cov_file", [True, False])
def test_chain_file_resume_cov_warm_start(tmp_path, capsys, cov_file):
    """Without a checkpoint, resume reloads cov.npy when there is one, and
    warns that the adaptive state re-burns otherwise."""
    out = str(tmp_path / "chains")
    kw = dict(burn=50, thin=1, isave=100, Tskip=10, SCAMweight=20, AMweight=20, DEweight=20)
    _small(out, 4, 2, resume=False).sample(np.zeros(2), 300, **kw)
    os.remove(os.path.join(out, "checkpoint.npz"))
    os.remove(os.path.join(out, "checkpoint.npz.json"))
    if not cov_file:
        os.remove(os.path.join(out, "cov.npy"))
    s2 = _small(out, 4, 2)
    s2.verbose = True
    s2.sample(np.zeros(2), 400, **kw)
    text = capsys.readouterr().out
    assert ("warm-started from cov.npy" in text) == cov_file
    assert ("will re-burn in" in text) != cov_file
