"""A user's model in the port's kernels: ``register_functor`` (ops/user.py).

On the CPU, without nvcc: registration's checks, the generated translation
units, the build key, the refusals, the sampler's kernel route for a user
model, and the plain versions (the model's ``value_grad``, which the kernels
are held to on the card) against the JAX package's Pallas kernels run by the
interpreter, with the same model written as a JAX ``func_grad`` and the same
numpy-seeded inputs. The two user models are ``chip_smoke.py``'s, as the
card runs them. Tolerances are test_torch_chees_wide.py's and
test_torch_nuts_wide.py's: f32 sums over D are ordered differently in XLA
and in the port.
"""

import os
import shutil
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ptmcmcsampler_torch import PTSampler, build_default_jumps, register_functor
from ptmcmcsampler_torch.diagnostics import moment_gate
from ptmcmcsampler_torch.ops import build, common, user
from ptmcmcsampler_torch.ops.chees import chees_step_plain
from ptmcmcsampler_torch.ops.hmc import hmc_step_plain
from ptmcmcsampler_torch.ops.nuts import nuts_trees_plain
from ptmcmcsampler_torch.sampler import _functor_model, card_refusal
from ptmcmcsampler_tpu.ops.chees_pallas import fused_chees_trajectories
from ptmcmcsampler_tpu.ops.hmc_pallas import fused_hmc_trajectories
from ptmcmcsampler_tpu.ops.nuts_pallas import fused_nuts_trees

torch.set_num_threads(2)

Q_TOL, QXY_TOL, LOGP_TOL, ALPHA_RTOL = 2e-4, 2e-3, 2e-3, 1e-4
T, C = 2, 12
SOURCE = chip_smoke.USER_REF_GAUSSIAN_SOURCE


def test_register_returns_the_prefixed_name_and_fills_the_tables():
    name = register_functor("t_tables", SOURCE, dims=(3, 7))
    assert name == "user_t_tables"
    assert common.FUNCTORS[name] == {"chees": (3, 7), "nuts": (3, 7), "hmc": (3, 7)}
    assert set(user.libraries(name)) <= set(build.GENERATED)
    assert user.libraries(name) == ("chees_trajectory_user_t_tables",
                                    "nuts_tree_user_t_tables", "hmc_trajectory_user_t_tables",
                                    "nuts_general_user_t_tables")


@pytest.mark.parametrize("name", ["", "1model", "my-model", "two words", "curved",
                                  "hierarchical_gaussian", 7])
def test_register_refuses_names(name):
    with pytest.raises(ValueError, match="register_functor"):
        register_functor(name, SOURCE)


@pytest.mark.parametrize("dims", [(0, 4), (5, 4), (1, common.WIDE_MAX_D + 1), (-2, 3)])
def test_register_refuses_dims(dims):
    with pytest.raises(ValueError, match="dims"):
        register_functor("t_dims", SOURCE, dims=dims)


@pytest.mark.parametrize("source", [
    "",
    "__device__ static float value_grad(const float* x, float beta, float* g) { return 0; }",
    "__device__ static double value_grad(const double* x, int s, int D, double b, "
    "const double* p, double* g) { return 0; }",
    SOURCE.replace("value_grad", "logp_grad"),
])
def test_register_refuses_sources_without_the_signature(source):
    with pytest.raises(ValueError, match="value_grad"):
        register_functor("t_source", source)


def test_register_again():
    """The same source and dims again is a no-op; another source or other
    dims under the same name raise."""
    a = register_functor("t_again", SOURCE, dims=(2, 9))
    text = build.GENERATED[user.library_name("chees", a)]
    assert register_functor("t_again", SOURCE, dims=(2, 9)) == a
    assert build.GENERATED[user.library_name("chees", a)] == text
    with pytest.raises(ValueError, match="another source"):
        register_functor("t_again", SOURCE + "\n// edited\n", dims=(2, 9))
    with pytest.raises(ValueError, match="other dims"):
        register_functor("t_again", SOURCE, dims=(2, 10))
    assert common.FUNCTORS[a]["nuts"] == (2, 9)


def test_generated_units_hold_the_source_and_the_entries():
    """Each kernel's unit includes its templates' header, holds the user's
    source in the struct it names, and instantiates the kernel's entry
    macro with WidePerChain of that struct, under the user_<name> symbols
    the header's macro defines; the built-in sources include the same
    headers and instantiate the macros for the three built-in functors."""
    name = register_functor("t_unit", SOURCE)
    for kernel, (source, header, macro, symbols) in user.KERNELS.items():
        unit = user.translation_unit(kernel, name)
        assert unit == build.GENERATED[user.library_name(kernel, name)]
        assert f'#include "{header}"' in unit
        assert f"struct {name}_functor {{\n{SOURCE}\n}};" in unit
        assert f"{macro}({name}, ptmc::WidePerChain<ptmc_user::{name}_functor>)" in unit
        defined = (build.CSRC / header).read_text()
        assert f"#define {macro}(NAME, MODEL)" in defined
        for symbol in symbols:
            assert f"{symbol}_##NAME(" in defined
        builtin = (build.CSRC / f"{source}.cu").read_text()
        assert f'#include "{header}"' in builtin
        for functor in ("correlated_gaussian", "interval_gaussian", "hierarchical_gaussian"):
            assert f"{macro}({functor}, " in builtin
    assert "struct WidePerChain" in (build.CSRC / "models.cuh").read_text()


def test_library_path_follows_the_source_and_the_headers(tmp_path, monkeypatch):
    """A user library's key changes with its generated source and with every
    header it includes (its kernel's, models.cuh, philox.cuh where the
    kernel draws from it), and with nothing else."""
    name = register_functor("t_key", SOURCE)
    libs = {k: user.library_name(k, name) for k in user.KERNELS}
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    before = {k: build.library_path(lib, csrc) for k, lib in libs.items()}
    assert before == {k: build.library_path(lib) for k, lib in libs.items()}
    assert len(set(before.values())) == 4

    def changed():
        return sorted(k for k, lib in libs.items() if build.library_path(lib, csrc) != before[k])

    for other in ("chees_trajectory.cu", "nuts_tree.cu", "hmc_trajectory.cu", "nuts_general.cu"):
        (csrc / other).write_text((csrc / other).read_text() + "\n// edited\n")
    assert changed() == []
    edits = [("chees_kernels.cuh", ["chees"]), ("philox.cuh", ["hmc", "nuts", "nuts_general"]),
             ("models.cuh", ["chees", "hmc", "nuts", "nuts_general"]),
             ("nuts_kernels.cuh", ["nuts", "nuts_general"]),
             ("nuts_general.cuh", ["nuts_general"])]
    for header, expect in edits:
        shutil.rmtree(csrc)
        shutil.copytree(build.CSRC, csrc)
        (csrc / header).write_text((csrc / header).read_text() + "\n// edited\n")
        assert changed() == sorted(expect), header
    shutil.rmtree(csrc)
    shutil.copytree(build.CSRC, csrc)
    lib = libs["nuts"]
    monkeypatch.setitem(build.GENERATED, lib, build.GENERATED[lib].replace("0.9189385f",
                                                                           "0.9189386f"))
    assert changed() == ["nuts"]


def test_refusals_follow_the_registered_dims():
    """kernel_refusal and card_refusal take a registered functor at every D
    of its dims and refuse it outside them, on the card only."""
    name = register_functor("t_dims_ok", SOURCE, dims=(4, 12))
    jumps = build_default_jumps(SCAMweight=10, CHEESweight=10, NUTSweight=10, HMCweight=10,
                                MALAweight=10, have_grads=True)
    for ndim in (3, 4, 10, 12, 13):
        inside = 4 <= ndim <= 12
        for kernel in ("chees", "nuts", "hmc"):
            why = common.kernel_refusal(name, kernel, ndim)
            assert (why is None) == inside
            if not inside:
                assert f"4 <= D <= 12, got {ndim}" in why
        assert (card_refusal("cuda", name, jumps, ndim) is None) == inside
        assert card_refusal("cpu", name, jumps, ndim) is None
    assert "register_functor" in common.kernel_refusal("user_nosuch", "chees", 5)


def test_kernel_structure_keeps_the_tag_for_a_user_functor():
    model = chip_smoke.UserRefGaussian()
    assert common.kernel_structure(model, "diagonal") == "diagonal"
    assert common.kernel_structure(model, "dense") == "dense"


def test_constants_of_length_zero_are_legal():
    model = chip_smoke.UserRefGaussian()
    prm = common.cuda_params("t", model, model.cuda_functor, torch.device("cpu"))
    assert prm.shape == (0,) and prm.dtype == torch.float32


def test_functor_model_takes_a_user_models_bound_methods(tmp_path, capsys):
    model = chip_smoke.UserRefGaussian()
    fns = (model.lnlikefn, model.lnpriorfn, model.lnlikefn_grad, model.lnpriorfn_grad)
    assert _functor_model(fns, (None, None, None, None)) is model
    assert _functor_model(fns, ([1.0], None, None, None)) is None
    s = PTSampler(model.ndim, *fns[:2], np.eye(model.ndim), logl_grad=fns[2],
                  logp_grad=fns[3], outDir=str(tmp_path), device="cpu")
    assert s.route == "kernel" and s._model is model
    assert ("Model route: kernel (functor 'user_ref_gaussian'), its plain versions on the CPU"
            in capsys.readouterr().out)


def test_prepare_builds_nothing_for_a_built_in_model(monkeypatch):
    from ptmcmcsampler_torch.models import HierarchicalGaussian

    monkeypatch.setattr(build, "nvcc_path", lambda: pytest.fail("nvcc was looked for"))
    assert user.prepare(HierarchicalGaussian(), torch.device("cpu")) == {}


def test_prepare_raises_naming_the_functor(tmp_path, monkeypatch):
    """No fallback: a missing nvcc, or a failed build with nvcc's log, raises
    naming the functor."""
    model = chip_smoke.UserRefGaussian()
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")

    def missing():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(build, "nvcc_path", missing)
    with pytest.raises(RuntimeError, match="user_ref_gaussian.*nvcc not found"):
        user.prepare(model, torch.device("cpu"))
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: value_grad is not defined'\nexit 1\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(fake))
    with pytest.raises(RuntimeError, match="(?s)user_ref_gaussian.*nvcc failed.*not defined"):
        user.prepare(model, torch.device("cpu"))
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())
    # The generated sources were written beside the libraries they name.
    units = sorted(p.name for p in (tmp_path / "build").iterdir() if p.suffix == ".cu")
    assert len(units) == len(user.KERNELS) and all("user_ref_gaussian" in u for u in units)


# ---- The plain versions on UserRefGaussian against the Pallas kernels ----

def _ref_func_grad(d):
    """UserRefGaussian as a JAX ``func_grad(x [D], beta)``."""
    c0 = float(np.float32(d) * chip_smoke.HALF_LOG_2PI_F32)

    def fg(x, beta):
        ll = -0.5 * jnp.sum(x * x) - c0
        lp = jnp.where(jnp.all(jnp.abs(x) < 10.0), 0.0, -jnp.inf)
        return beta * ll + lp, beta * (-x)

    return fg


def _setup(seed, d=10):
    """Positions around the posterior (one chain outside the box), a
    well-conditioned mass-matrix factor, two rungs."""
    model = chip_smoke.UserRefGaussian(ndim=d)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, d, C)).astype(np.float32)
    x[0, 0, 3] = -10.5
    a = rng.normal(size=(d, d)) / d
    chol = np.linalg.cholesky(0.5 * np.eye(d) + 0.5 * a @ a.T).astype(np.float32)
    chol_inv = np.linalg.inv(chol).astype(np.float32)
    betas = np.array([1.0, 0.3], np.float32)
    return model, rng, x, chol, chol_inv, betas


def _rows(a):  # [T, K, C] -> [T*C, K]
    return jnp.asarray(np.moveaxis(a, 1, 2).reshape(-1, a.shape[1]))


def _tdc(a):  # [T*C, K] -> [T, K, C]
    return np.moveaxis(np.asarray(a).reshape(T, C, -1), 2, 1)


def test_chees_step_plain_matches_pallas_interpreted():
    model, rng, x, chol, chol_inv, betas = _setup(0)
    d, max_steps = model.ndim, 8
    r0 = rng.normal(size=(T, d, C)).astype(np.float32)
    u = rng.uniform(1e-3, 1.0, (T, C)).astype(np.float32)
    eps = np.repeat(np.array([[0.1], [0.2]], np.float32), C, axis=1)
    tlen = np.full((T, C), 0.6, np.float32)
    x1, q0, z1, r1, qxy, alpha = (a.numpy() for a in chees_step_plain(
        torch.tensor(x), torch.tensor(r0), torch.tensor(u), torch.tensor(betas),
        torch.tensor(eps), torch.tensor(tlen), 0.1, max_steps, torch.tensor(chol),
        torch.tensor(chol_inv), model))
    nsteps = np.clip(np.ceil(u * tlen / eps), 1, max_steps).astype(np.int32)
    jq0 = np.einsum("ki,tkc->tic", chol_inv, x).astype(np.float32)
    jz, jr, jl = fused_chees_trajectories(
        _rows(jq0), _rows(r0), jnp.asarray(np.repeat(betas, C)), jnp.asarray(eps.reshape(-1)),
        jnp.asarray(nsteps.reshape(-1)), jnp.asarray(chol), func_grad=_ref_func_grad(d),
        ndim=d, max_steps=max_steps, interpret=True)
    jz, jr, jl = _tdc(jz), _tdc(jr), np.asarray(jl).reshape(T, C)
    np.testing.assert_allclose(q0, jq0, rtol=Q_TOL, atol=Q_TOL)
    np.testing.assert_allclose(z1, jz, rtol=Q_TOL, atol=Q_TOL)
    np.testing.assert_allclose(r1, jr, rtol=Q_TOL, atol=Q_TOL)
    np.testing.assert_allclose(x1, np.einsum("ki,tkc->tic", chol, jz), rtol=Q_TOL, atol=Q_TOL)
    k0, k1 = 0.5 * np.sum(r0 * r0, axis=1), 0.5 * np.sum(jr * jr, axis=1)
    np.testing.assert_allclose(qxy, k0 - k1, rtol=QXY_TOL, atol=QXY_TOL)
    fg = _ref_func_grad(d)
    logp0 = np.array([[float(fg(jnp.asarray(x[t, :, c]), betas[t])[0]) for c in range(C)]
                      for t in range(T)])
    with np.errstate(invalid="ignore"):
        de = np.nan_to_num((jl - k1) - (logp0 - k0), nan=-np.inf)
    np.testing.assert_allclose(alpha, np.minimum(1.0, np.exp(de)), rtol=QXY_TOL, atol=QXY_TOL)
    assert alpha[0, 3] == 0.0  # the start outside the box: logp0 = -inf ... alpha 0
    assert nsteps.max() > 1


@pytest.mark.parametrize("depth", [3, 4])
def test_nuts_trees_plain_matches_pallas_interpreted(depth):
    model, rng, x, chol, chol_inv, betas = _setup(depth)
    d = model.ndim
    f32 = np.float32
    inp = dict(
        q0=np.einsum("ki,tkc->tic", chol_inv, x).astype(f32),
        r0=rng.normal(size=(T, d, C)).astype(f32), beta=betas,
        eps=(0.2 * 1.5 ** np.arange(T)[:, None] * np.ones((T, C))).astype(f32),
        expo=rng.exponential(size=(T, C)).astype(f32),
        dirs=np.where(rng.random((depth, T, C)) < 0.5, -1.0, 1.0).astype(f32),
        accu=rng.random((depth, T, C)).astype(f32),
        resu=rng.random(((1 << depth) - 1, T, C)).astype(f32), chol=chol,
    )

    def rows_k(a):  # [K, T, C] -> [T*C, K]
        return jnp.asarray(np.moveaxis(a, 0, 2).reshape(T * C, -1))

    jout = fused_nuts_trees(
        _rows(inp["q0"]), _rows(inp["r0"]), jnp.asarray(np.repeat(betas, C)),
        jnp.asarray(inp["eps"].reshape(-1)), jnp.asarray(inp["expo"].reshape(-1)),
        rows_k(inp["dirs"]), rows_k(inp["accu"]), rows_k(inp["resu"]), jnp.asarray(chol),
        func_grad=_ref_func_grad(d), ndim=d, max_depth=depth, interpret=True,
    )
    tout = nuts_trees_plain(*(torch.tensor(inp[k]) for k in (
        "q0", "r0", "beta", "eps", "expo", "dirs", "accu", "resu", "chol")), model)
    jq = _tdc(jout[0])
    jl0, jlp, ja, jn, jalive = (np.asarray(a).reshape(T, C) for a in jout[1:])
    tq, tl0, tlp, ta, tn, talive, teps = (a.numpy() for a in tout)
    np.testing.assert_array_equal(teps, inp["eps"])
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(talive, jalive)
    np.testing.assert_allclose(tq, jq, rtol=Q_TOL, atol=Q_TOL)
    np.testing.assert_array_equal(np.isneginf(tl0), np.isneginf(jl0))
    fin = np.isfinite(jl0)
    np.testing.assert_allclose(tl0[fin], jl0[fin], rtol=LOGP_TOL, atol=LOGP_TOL)
    np.testing.assert_allclose(tlp, jlp, rtol=LOGP_TOL, atol=LOGP_TOL)
    np.testing.assert_allclose(ta, ja, rtol=ALPHA_RTOL, atol=1e-6)
    assert tn.max() > 1 and np.isneginf(tl0[0, 3])


@pytest.mark.parametrize("eps", [0.2, 3.0])
def test_hmc_step_plain_matches_pallas_interpreted(eps):
    model, rng, x, chol, chol_inv, betas = _setup(7)
    d, nmin, nmax = model.ndim, 2, 12
    p0 = rng.normal(size=(T, d, C)).astype(np.float32)
    nsteps = rng.integers(nmin, nmax, size=(T, C)).astype(np.int32)
    x1, qxy = hmc_step_plain(torch.tensor(x), torch.tensor(betas),
                             (torch.tensor(p0), torch.tensor(nsteps)), torch.tensor(chol),
                             torch.tensor(chol_inv), eps, nmin, nmax, model)
    jq0 = np.einsum("ki,tkc->tic", chol_inv, x).astype(np.float32)
    jq, jqxy = fused_hmc_trajectories(
        _rows(jq0), _rows(p0), jnp.asarray(np.repeat(betas, C)),
        jnp.asarray(nsteps.reshape(-1)), jnp.asarray(chol), func_grad=_ref_func_grad(d),
        ndim=d, eps=eps, nmax_steps=nmax - 1, interpret=True)
    jx1 = np.einsum("ki,tkc->tic", chol, _tdc(jq))
    jqxy = np.asarray(jqxy).reshape(T, C)
    np.testing.assert_array_equal(np.isneginf(qxy.numpy()), np.isneginf(jqxy))
    fin = np.isfinite(jqxy)
    np.testing.assert_allclose(qxy.numpy()[fin], jqxy[fin], rtol=QXY_TOL, atol=QXY_TOL)
    np.testing.assert_allclose(x1.numpy(), jx1, rtol=Q_TOL, atol=Q_TOL)
    assert np.isneginf(qxy.numpy()[0, 3])  # the start outside the box is rejected


# ---- PTSampler on the CPU with the user model ----

def _ref_sampler(outdir, niter, resume=False, seed=6, nchains=8, **kw):
    """The reference test_nuts.py scenario (tests/test_gradient_jumps.py
    TestReferenceNutsScenario) through PTSampler with UserRefGaussian."""
    model = chip_smoke.UserRefGaussian()
    s = PTSampler(model.ndim, model.lnlikefn, model.lnpriorfn, np.eye(model.ndim),
                  logl_grad=model.lnlikefn_grad, logp_grad=model.lnpriorfn_grad, ntemps=1,
                  nchains=nchains, outDir=outdir, verbose=False, seed=seed, resume=resume,
                  device="cpu")
    s.sample(np.ones(model.ndim) * 0.1, niter, burn=500, thin=1, covUpdate=500,
             SCAMweight=10, AMweight=10, DEweight=10, NUTSweight=10, HMCweight=10,
             MALAweight=0, HMCsteps=20, HMCstepsize=0.2, **kw)
    return s


def test_reference_scenario_through_the_kernel_route(tmp_path):
    """The kernel route's plain versions on the CPU: NUTS and HMC propose
    and accept, and the cold chains' means pass the bench's z-check against
    N(0, I)."""
    s = _ref_sampler(str(tmp_path / "chains"), 1000)
    assert s.route == "kernel" and s._model.cuda_functor == "user_ref_gaussian"
    names = s.config.jump_names()
    proposed = s.state.counters.jump_proposed[:, 0].sum(-1).numpy()
    accepted = s.state.counters.jump_accepted[:, 0].sum(-1).numpy()
    for jump in ("NUTSJUMP", "HMCJump"):
        assert proposed[names.index(jump)] > 0 and accepted[names.index(jump)] > 0
    ok, max_z, _ = moment_gate(s.chains[:, 300:], np.zeros(10))
    assert ok, max_z


def test_checkpoint_of_a_user_model_resumes(tmp_path):
    """A run of 2N iterations and a run of N resumed to 2N leave the same
    bytes in every chain file: checkpoint and resume know no model."""
    whole, parts = str(tmp_path / "whole"), str(tmp_path / "parts")
    kw = dict(nchains=4, isave=50)
    _ref_sampler(whole, 200, **kw)
    _ref_sampler(parts, 100, **kw)
    s = _ref_sampler(parts, 200, resume=True, **kw)
    assert s._resume_start_iter == 100

    def files(outdir):
        out = {}
        for name in sorted(os.listdir(outdir)):
            if not name.startswith("checkpoint"):
                with open(os.path.join(outdir, name), "rb") as f:
                    out[name] = f.read()
        return out

    a, b = files(whole), files(parts)
    assert sorted(a) == sorted(b) and len(a["chain_1.0.txt"].splitlines()) == 201
    for name in a:
        assert a[name] == b[name], name
