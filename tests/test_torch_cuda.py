"""The port on a CUDA card: each kernel against its plain version, the
wrappers' refusals, the main paths' launches, and ``PTSampler``'s model
routes and refusals; plus the kernel build's cache key, which needs no card.

Tests that need a card carry the ``cuda`` marker and take the ``cuda``
fixture, which skips them where there is none. This file imports no JAX, so
on a machine with a card and without JAX it runs alone with
``python -m pytest --noconftest tests/test_torch_cuda.py``.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from ptmcmcsampler_torch import SamplerConfig, build_default_jumps, build_step, init_state
from ptmcmcsampler_torch.config import KIND_CHEES, KIND_HMC, KIND_NUTS
from ptmcmcsampler_torch.models import (
    CorrelatedGaussian, CurvedLikelihood, HierarchicalGaussian, IntervalTransformedGaussian,
)
from ptmcmcsampler_torch.ops import build, common, user
from ptmcmcsampler_torch.ops.chees import (
    chees_step, chees_step_plain, chees_trajectories, chees_trajectories_plain,
)
from ptmcmcsampler_torch.ops.hmc import (
    hmc_draws, hmc_kernel_draws, hmc_step, hmc_step_plain, hmc_trajectories,
    hmc_trajectories_plain,
)
from ptmcmcsampler_torch.ops.nuts import nuts_trees, nuts_trees_plain, nuts_uniforms

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _inputs(dev, t=2, c=1000, max_nsteps=16, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = 0.3 * torch.randn((t, 2, c), generator=gen, device=dev)
    x[:, 1] -= 1.0
    chol = torch.tensor([[0.7, 0.0], [0.2, 0.9]], device=dev)
    q0 = (torch.linalg.inv(chol).T @ x).contiguous()
    p0 = torch.randn((t, 2, c), generator=gen, device=dev)
    betas = torch.linspace(1.0, 0.25, t, device=dev)
    eps = torch.full((t, c), 0.03, device=dev)
    nsteps = torch.randint(1, max_nsteps + 1, (t, c), generator=gen, device=dev,
                           dtype=torch.int32)
    return q0, p0, betas, eps, nsteps, chol


EPS0 = 0.08


def _step_inputs(dev, t=2, c=1000, max_steps=16, seed=0):
    """The fused step's arguments around the trajectory entry's: rung 0 at
    its first call (eps 0, so EPS0 is used), lengths up to ``max_steps``."""
    q0, r0, betas, eps, _, chol = _inputs(dev, t, c, seed=seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)
    x = (chol.T @ q0).contiguous()
    u = torch.rand((t, c), generator=gen, device=dev) * (1.0 - 1e-3) + 1e-3
    eps[0] = 0.0
    tlen = torch.where(eps > 0, eps, EPS0) * max_steps
    chol_inv = torch.linalg.inv(chol).contiguous()
    return x, r0, u, betas, eps, tlen, chol, chol_inv


def _length_case(dev, case):
    """Both entries' arguments for one case of trajectory lengths, and the
    fused entry's max_steps."""
    t, c, max_steps = (3, 333, 16) if case == "ragged" else (2, 1000, 16)
    traj = list(_inputs(dev, t, c, max_nsteps=max_steps))
    step = list(_step_inputs(dev, t, c, max_steps))
    if case == "all_equal":  # ceil(0.999 * 8) = 8 in every lane
        traj[4] = torch.full_like(traj[4], 8)
        step[2] = torch.full_like(step[2], 0.999)
        step[5] = step[5] / max_steps * 8
    elif case == "one_long":  # one lane at 256 steps, the rest at most 16
        max_steps = 256
        traj[4][1, 5] = max_steps
        step[2] = step[2] * (16 / max_steps)
        step[2][1, 5] = 0.999
        step[5] = step[5] / 16 * max_steps
    return traj, step, max_steps


def _tree_inputs(dev, depth, t=2, c=1000, seed=0):
    """The tree's arguments, the reservoir's Philox key in place of its
    uniforms; some lanes have eps <= 0, which the step-size search sets."""
    q0, r0, betas, _, _, chol = _inputs(dev, t, c, seed=seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    eps = torch.full((t, c), 0.15, device=dev)
    eps[:, ::7] = 0.0
    eps[:, 3::11] = -1.0
    expo = torch.empty((t, c), device=dev).exponential_(generator=gen)
    dirs = torch.where(torch.rand((depth, t, c), generator=gen, device=dev) < 0.5, -1.0, 1.0)
    accu = torch.rand((depth, t, c), generator=gen, device=dev)
    key = torch.randint(0, 2**32, (2,), generator=gen, device=dev, dtype=torch.int64)
    return q0, r0, betas, eps, expo, dirs, accu, key, chol


@pytest.mark.cuda
def test_kernel_matches_plain(cuda):
    args = _inputs(cuda)
    before = chees_trajectories.launches
    q1, p1, lp1 = chees_trajectories(*args, CurvedLikelihood())
    assert chees_trajectories.launches == before + 1
    q1p, p1p, lp1p = chees_trajectories_plain(*args, CurvedLikelihood())
    torch.testing.assert_close(q1, q1p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(p1, p1p, rtol=1e-4, atol=1e-4)
    assert torch.equal(torch.isneginf(lp1), torch.isneginf(lp1p))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "all_equal", "one_long", "ragged"])
def test_chees_entries_bitwise_equal_plain(cuda, case):
    """Both ChEES entries against their plain versions, bit for bit, with
    the block's lanes grouped by length: random lengths, all equal, one
    lane at 256 steps, and a batch that is not a whole number of blocks."""
    traj, step, max_steps = _length_case(cuda, case)
    model = CurvedLikelihood()
    out = chees_trajectories(*traj, model)
    ref = chees_trajectories_plain(*traj, model)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    before = chees_step.launches
    out = chees_step(*step[:6], EPS0, max_steps, *step[6:], model)
    assert chees_step.launches == before + 1
    ref = chees_step_plain(*step[:6], EPS0, max_steps, *step[6:], model)
    for name, a, b in zip(("x1", "q0", "z1", "r1", "qxy", "alpha"), out, ref):
        assert torch.equal(a, b), name
    if case == "one_long":
        assert int(traj[4].max()) == 256


@pytest.mark.cuda
@pytest.mark.parametrize("eps", [0.08, 5.0])
def test_hmc_kernel_matches_plain(cuda, eps):
    q0, p0, betas, _, nsteps, chol = _inputs(cuda, max_nsteps=49)
    before = hmc_trajectories.launches
    q1, qxy = hmc_trajectories(q0, p0, betas, nsteps, chol, eps, CurvedLikelihood())
    assert hmc_trajectories.launches == before + 1
    q1p, qxyp = hmc_trajectories_plain(q0, p0, betas, nsteps, chol, eps, CurvedLikelihood())
    torch.testing.assert_close(q1, q1p, rtol=1e-4, atol=1e-4)
    assert torch.equal(torch.isneginf(qxy), torch.isneginf(qxyp))
    fin = torch.isfinite(qxyp)
    torch.testing.assert_close(qxy[fin], qxyp[fin], rtol=1e-3, atol=1e-3)


HMC_NMIN, HMC_NMAX = 2, 50


def _hmc_step_inputs(dev, c=1000, outside=0.0, seed=0):
    """The fused HMC step's arguments but the step size, lengths and model:
    positions with a share ``outside`` of them outside the prior box (their
    trajectories run their whole length), and a Philox key."""
    q0, _, betas, _, _, chol = _inputs(dev, 2, c, seed=seed)
    x = (chol.T @ q0).contiguous()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 3)
    moved = torch.rand((2, c), generator=gen, device=dev) < outside
    x[:, 0] = torch.where(moved, 12.0, x[:, 0])
    key = torch.randint(0, 2**32, (2,), generator=gen, device=dev, dtype=torch.int64)
    return x, betas, key, chol, torch.linalg.inv(chol).contiguous()


def _ulps(a, b):
    """Distance of two f32 tensors in units in the last place."""
    def ordered(v):
        i = v.view(torch.int32).to(torch.int64)
        return torch.where(i >= 0, i, -(i & 0x7FFFFFFF))
    return (ordered(a) - ordered(b)).abs()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["eps0.08", "eps5", "outside", "ragged", "odd", "one_length"])
def test_hmc_step_matches_plain(cuda, case):
    """The fused step against its plain version under the same key: at the
    path's step size, at a step size where most lanes leave the box, with 2%
    of starts outside the box (whole trajectories), on batches that are not
    a whole number of 256-chain blocks (1002 and 999 chains a rung) and with
    one possible length. The kernel's end points are the trajectory entry's
    from the kernel's own draws, bit for bit."""
    eps = 5.0 if case == "eps5" else 0.08
    c = {"ragged": 1002, "odd": 999}.get(case, 1000)
    nmin, nmax = (7, 8) if case == "one_length" else (HMC_NMIN, HMC_NMAX)
    x, betas, key, chol, chol_inv = _hmc_step_inputs(cuda, c, 0.02 if case == "outside" else 0.0)
    args = (x, betas, key, chol, chol_inv, eps, nmin, nmax, CurvedLikelihood())
    before = hmc_step.launches
    x1, qxy = hmc_step(*args)
    assert hmc_step.launches == before + 1
    x1p, qxyp = hmc_step_plain(*args)
    torch.testing.assert_close(x1, x1p, rtol=1e-4, atol=1e-4)
    assert torch.equal(torch.isneginf(qxy), torch.isneginf(qxyp))
    fin = torch.isfinite(qxyp)
    torch.testing.assert_close(qxy[fin], qxyp[fin], rtol=1e-3, atol=1e-3)

    p0, nsteps = hmc_kernel_draws(key, 2, 2, c, nmin, nmax, CurvedLikelihood())
    q1, qxyk = hmc_trajectories(common.matvec(chol_inv.T, x), p0, betas, nsteps, chol, eps,
                                CurvedLikelihood())
    assert torch.equal(common.matvec(chol.T, q1), x1) and torch.equal(qxyk, qxy)
    if case == "outside":
        moved = x[:, 0] == 12.0
        assert moved.any() and torch.isneginf(qxy[moved]).all()
    if case == "one_length":
        assert (nsteps == nmin).all()


@pytest.mark.cuda
def test_hmc_kernel_draws_match_hmc_draws(cuda):
    """The kernel's draws against the PyTorch ones: lengths equal in every
    lane, momenta within 4 ulp (logf, sinf and cosf round apart between
    math libraries)."""
    key = torch.tensor([0xDEADBEEF, 0x0BADF00D], dtype=torch.int64, device=cuda)
    p0, nsteps = hmc_kernel_draws(key, 8, 2, 4096, HMC_NMIN, HMC_NMAX, CurvedLikelihood())
    p0t, nstepst = hmc_draws(key, 8, 2, 4096, HMC_NMIN, HMC_NMAX)
    assert torch.equal(nsteps, nstepst)
    assert int(_ulps(p0, p0t).max()) <= 4
    assert int(nsteps.min()) == HMC_NMIN and int(nsteps.max()) == HMC_NMAX - 1


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [4, 10])
def test_nuts_kernel_matches_plain(cuda, depth):
    """The kernel drawing its reservoir uniforms from a key against the
    plain version fed those uniforms materialised, in every lane; the lanes
    with eps <= 0 hold the in-kernel step-size search to the plain
    find_reasonable_epsilon."""
    args = _tree_inputs(cuda, depth)
    q0, r0, betas, eps, expo, dirs, accu, key, chol = args
    r_eps = torch.randn(q0.shape, generator=torch.Generator(device=cuda).manual_seed(5),
                        device=cuda)
    before = nuts_trees.launches
    out = nuts_trees(*args, CurvedLikelihood(), r_eps=r_eps)
    assert nuts_trees.launches == before + 1
    resu = nuts_uniforms(key, depth, *eps.shape)
    ref = nuts_trees_plain(q0, r0, betas, eps, expo, dirs, accu, resu, chol, CurvedLikelihood(),
                           r_eps)
    q, l0, lp, alpha, nalpha, alive, eps_used = out
    qp, l0p, lpp, alphap, nalphap, alivep, eps_usedp = ref
    assert torch.equal(eps_used, eps_usedp)
    assert (eps_used > 0).all() and torch.equal(eps_used[eps > 0], eps[eps > 0])
    assert torch.equal(nalpha, nalphap) and torch.equal(alive, alivep)
    torch.testing.assert_close(q, qp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(l0, l0p, rtol=0, atol=0)
    torch.testing.assert_close(lp, lpp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(alpha, alphap, rtol=1e-4, atol=1e-4)
    assert nalpha.max() > 1  # trees of several sizes


@pytest.mark.cuda
def test_nuts_kernel_without_search_leaves_nonpositive_lanes(cuda):
    """Without r_eps the kernel searches no lane: a lane with eps <= 0 runs
    no leaf and proposes its start, as the plain version does, and every
    lane reports the step size it was given."""
    args = _tree_inputs(cuda, 4)
    q0, _, _, eps, _, _, _, key, _ = args
    q, l0, lp, _, nalpha, _, eps_used = nuts_trees(*args, CurvedLikelihood())
    assert torch.equal(eps_used, eps)
    dead = eps <= 0
    assert torch.equal(nalpha[dead], torch.zeros_like(nalpha[dead]))
    assert torch.equal(q.movedim(1, 2)[dead], q0.movedim(1, 2)[dead])
    assert torch.equal(lp[dead], l0[dead]) and (nalpha[~dead] >= 1).all()


@pytest.mark.cuda
def test_wrapper_raises_for_model_without_functor(cuda):
    class NoFunctor(CurvedLikelihood):
        cuda_functor = None

    q0, p0, betas, eps, nsteps, chol = _inputs(cuda)
    with pytest.raises(NotImplementedError, match="NoFunctor"):
        chees_trajectories(q0, p0, betas, eps, nsteps, chol, NoFunctor())
    step = _step_inputs(cuda)
    with pytest.raises(NotImplementedError, match="NoFunctor"):
        chees_step(*step[:6], EPS0, 16, *step[6:], NoFunctor())
    with pytest.raises(NotImplementedError, match="NoFunctor"):
        hmc_trajectories(q0, p0, betas, nsteps, chol, 0.1, NoFunctor())
    with pytest.raises(NotImplementedError, match="NoFunctor"):
        hmc_step(*_hmc_step_inputs(cuda), 0.08, HMC_NMIN, HMC_NMAX, NoFunctor())
    with pytest.raises(NotImplementedError, match="NoFunctor"):
        nuts_trees(*_tree_inputs(cuda, 3), NoFunctor())


@pytest.mark.cuda
def test_wrapper_raises_for_unknown_functor(cuda):
    """A model naming a functor the kernels were not built with raises, on
    every wrapper; it never falls back to the plain version."""
    class NoSuchFunctor(CurvedLikelihood):
        cuda_functor = "nosuch"

    q0, p0, betas, eps, nsteps, chol = _inputs(cuda)
    with pytest.raises(NotImplementedError, match="NoSuchFunctor"):
        chees_trajectories(q0, p0, betas, eps, nsteps, chol, NoSuchFunctor())
    step = _step_inputs(cuda)
    with pytest.raises(NotImplementedError, match="NoSuchFunctor"):
        chees_step(*step[:6], EPS0, 16, *step[6:], NoSuchFunctor())
    with pytest.raises(NotImplementedError, match="NoSuchFunctor"):
        hmc_trajectories(q0, p0, betas, nsteps, chol, 0.1, NoSuchFunctor())
    with pytest.raises(NotImplementedError, match="NoSuchFunctor"):
        hmc_step(*_hmc_step_inputs(cuda), 0.08, HMC_NMIN, HMC_NMAX, NoSuchFunctor())
    with pytest.raises(NotImplementedError, match="NoSuchFunctor"):
        nuts_trees(*_tree_inputs(cuda, 3), NoSuchFunctor())


@pytest.mark.cuda
def test_wrapper_raises_for_functor_of_another_dimension(cuda):
    q0, p0, betas, eps, nsteps, chol = _inputs(cuda)
    q3, p3 = (torch.cat([a, a[:, :1]], dim=1).contiguous() for a in (q0, p0))
    with pytest.raises(ValueError, match="compiled for D=2"):
        chees_trajectories(q3, p3, betas, eps, nsteps, torch.eye(3, device=cuda),
                           CurvedLikelihood())


@pytest.mark.cuda
def test_wrapper_rejects_bad_layout(cuda):
    q0, p0, betas, eps, nsteps, chol = _inputs(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        chees_trajectories(q0, p0, betas, eps, nsteps, chol.T, CurvedLikelihood())
    with pytest.raises(ValueError, match="nsteps"):
        chees_trajectories(q0, p0, betas, eps, nsteps.long(), chol, CurvedLikelihood())
    with pytest.raises(ValueError, match="nsteps"):
        hmc_trajectories(q0, p0, betas, nsteps.long(), chol, 0.1, CurvedLikelihood())
    x, r0, u, betas, eps, tlen, chol, chol_inv = _step_inputs(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        chees_step(x, r0, u, betas, eps, tlen, EPS0, 16, chol, chol_inv.T, CurvedLikelihood())
    with pytest.raises(ValueError, match="u is"):
        chees_step(x, r0, u.double(), betas, eps, tlen, EPS0, 16, chol, chol_inv,
                   CurvedLikelihood())
    with pytest.raises(ValueError, match="x is not contiguous"):
        chees_step(x.movedim(1, 2).contiguous().movedim(2, 1), r0, u, betas, eps, tlen, EPS0, 16, chol, chol_inv,
                   CurvedLikelihood())
    with pytest.raises(ValueError, match="max_steps"):
        chees_step(x, r0, u, betas, eps, tlen, EPS0, 0, chol, chol_inv, CurvedLikelihood())
    with pytest.raises(ValueError, match="contiguous"):
        hmc_trajectories(q0, p0, betas, nsteps, chol.T, 0.1, CurvedLikelihood())
    x, betas, key, chol, chol_inv = _hmc_step_inputs(cuda)
    lengths = (0.08, HMC_NMIN, HMC_NMAX, CurvedLikelihood())
    for bad in (key[:1], key.to(torch.int32), key.cpu()):  # one word, int32, on the host
        with pytest.raises(ValueError, match="key"):
            hmc_step(x, betas, bad, chol, chol_inv, *lengths)
    p0, nsteps = hmc_draws(key, 2, 2, 1000, HMC_NMIN, HMC_NMAX)
    with pytest.raises(ValueError, match="Philox key"):  # no array draws on the card
        hmc_step(x, betas, (p0, nsteps), chol, chol_inv, *lengths)
    with pytest.raises(ValueError, match="contiguous"):
        hmc_step(x, betas, key, chol, chol_inv.T, *lengths)
    with pytest.raises(ValueError, match="lengths"):
        hmc_step(x, betas, key, chol, chol_inv, 0.08, 5, 5, CurvedLikelihood())
    tree = list(_tree_inputs(cuda, 3))
    tree[7] = tree[7][:-1]  # a key of one word
    with pytest.raises(ValueError, match="key"):
        nuts_trees(*tree, CurvedLikelihood())
    tree = list(_tree_inputs(cuda, 3))
    tree[7] = nuts_uniforms(tree[7], 3, 2, 1000)  # the kernel takes the key, not uniforms
    with pytest.raises(ValueError, match="key"):
        nuts_trees(*tree, CurvedLikelihood())
    tree = list(_tree_inputs(cuda, 3))
    tree[3] = tree[3].double()
    with pytest.raises(ValueError, match="eps"):
        nuts_trees(*tree, CurvedLikelihood())


def test_wrapper_rejects_other_devices():
    meta = [torch.empty((2, 2, 4), device="meta")] * 2
    with pytest.raises(ValueError, match="unsupported device"):
        chees_trajectories(*meta, None, None, None, None, CurvedLikelihood())
    with pytest.raises(ValueError, match="unsupported device"):
        hmc_trajectories(*meta, None, None, None, 0.1, CurvedLikelihood())
    with pytest.raises(ValueError, match="unsupported device"):
        chees_step(*meta, None, None, None, None, 0.08, 16, None, None, CurvedLikelihood())
    with pytest.raises(ValueError, match="unsupported device"):
        hmc_step(meta[0], None, None, None, None, 0.08, 2, 50, CurvedLikelihood())
    dirs = torch.empty((3, 2, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        nuts_trees(*meta, None, None, None, dirs, dirs, None, None, CurvedLikelihood())


def test_nuts_wrapper_rejects_depth_beyond_the_kernel():
    """Depth 30 is the general entry's cap (config.NUTS_MAX_DEPTH); the
    wrapper refuses 31 before it reads any draw."""
    t, c = 1, 4
    dirs = torch.ones((31, t, c))
    with pytest.raises(ValueError, match="depth 31"):
        nuts_trees(torch.zeros((t, 2, c)), torch.zeros((t, 2, c)), torch.ones(t),
                   torch.ones((t, c)), torch.ones((t, c)), dirs, dirs,
                   torch.ones((1, t, c)), torch.eye(2), CurvedLikelihood())


@pytest.mark.parametrize("name", build.SOURCES)
def test_build_key_follows_included_header(tmp_path, name):
    """Editing the shared model header renames every library that includes
    it, so a stale build is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    before = build.library_path(name, csrc)
    assert before == build.library_path(name, csrc)
    assert before == build.library_path(name)  # the copy hashes as the original
    header = csrc / "models.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert build.library_path(name, csrc) != before


def test_build_key_follows_philox_header(tmp_path):
    """The Philox header keys the libraries of the kernels that draw from it
    (the HMC step and the NUTS tree) and no other."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    before = {name: build.library_path(name, csrc) for name in build.SOURCES}
    header = csrc / "philox.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: build.library_path(name, csrc) for name in build.SOURCES}
    assert [n for n in build.SOURCES if after[n] != before[n]] == ["hmc_trajectory", "nuts_tree",
                                                                   "nuts_general"]


def _small_config(**jumps):
    jumps = jumps or dict(CHEESweight=20)
    return SamplerConfig(
        ndim=2, ntemps=2, nchains=64, groups=((0, 1),),
        jumps=build_default_jumps(SCAMweight=10, AMweight=10, DEweight=10, burn=20,
                                  have_grads=True, **jumps),
        tskip=5, cov_update=25, burn=20, thin=1, de_size=100, hmc_stepsize=0.08,
        hmc_nmaxsteps=50, nuts_max_depth=10,
    )


def test_build_step_defaults_to_the_card():
    cfg = _small_config()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_step(cfg, CurvedLikelihood())
        return
    step, _ = build_step(cfg, CurvedLikelihood())
    x0 = np.array([-0.1, -0.5])
    state = init_state(cfg, 0, x0, np.eye(2), np.array([1.0, 0.5]), np.zeros((2, 64)),
                       np.zeros((2, 64)))
    assert state.x.is_cuda
    assert step(state).x.is_cuda


def _small_state(cfg, model, dev, seed=1):
    d = cfg.ndim
    x0 = np.array([-0.1, -0.5]) if d == 2 else np.full(d, 0.3)
    xs = torch.tensor(x0, dtype=torch.float32, device=dev)[None, :, None].expand(2, d, 64)
    return init_state(cfg, seed, x0, np.eye(d), np.array([1.0, 0.5]), model.lnlike(xs),
                      model.lnprior(xs), device=dev)


def _run_small(cfg, dev, iters):
    model = CurvedLikelihood()
    _, run_block = build_step(cfg, model, device=dev)
    state, out = run_block(_small_state(cfg, model, dev), iters)
    assert torch.isfinite(out.x).all()
    return state, run_block.stats


def _iterations(cfg, state, kind):
    return int(state.counters.jump_proposed[[s.kind for s in cfg.jumps].index(kind), 0, 0])


def _launches(stats, wrapper):
    """A kernel's device launches, counted through the graphs: its wrapper's
    calls, less those made under capture, plus each graph's recorded calls
    times its replays."""
    return stats.kernel_launches(wrapper.__name__, wrapper.launches)


@pytest.mark.cuda
def test_main_path_launches_kernel_each_chees_iteration(cuda):
    """One fused-step launch a ChEES iteration, counted through the graphs;
    the trajectory entry is not on the path."""
    cfg = _small_config()
    chees_step.launches = chees_trajectories.launches = 0
    state, stats = _run_small(cfg, cuda, 60)
    assert _launches(stats, chees_step) == _iterations(cfg, state, KIND_CHEES) > 0
    assert chees_trajectories.launches == 0
    assert sum(stats.replays.values()) > 0


@pytest.mark.cuda
def test_nuts_path_launches_kernels_each_iteration(cuda):
    """One NUTS tree launch a NUTS iteration and one fused-step launch an
    HMC iteration, counted through the graphs; the HMC trajectory entry is
    not on the path."""
    cfg = _small_config(NUTSweight=10, HMCweight=10)
    nuts_trees.launches = hmc_step.launches = hmc_trajectories.launches = 0
    state, stats = _run_small(cfg, cuda, 80)
    assert _launches(stats, nuts_trees) == _iterations(cfg, state, KIND_NUTS) > 0
    assert _launches(stats, hmc_step) == _iterations(cfg, state, KIND_HMC) > 0
    assert hmc_trajectories.launches == 0
    assert (state.stepsize.epsilon > 0).all()


def _bits(a):
    return a.contiguous().reshape(-1).view(torch.uint8).cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("model_name, jumps", [
    ("curved", dict(CHEESweight=20)),
    ("curved", dict(NUTSweight=10, HMCweight=10)),
    ("hierarchical", dict(CHEESweight=20, MALAweight=10)),
    ("hierarchical", dict(NUTSweight=10, HMCweight=10)),
])
def test_graph_run_block_equals_the_eager_step_loop(cuda, model_name, jumps):
    """``run_block``'s graphs against ``step`` after ``step`` on the same
    seed and kinds, over 80 iterations that cross burn-in (20), swaps (every
    5) and refreshes (every 25): every tensor, the host fields and both
    generators' states equal, bit for bit (the graphs draw at the eager
    loop's Philox offsets)."""
    from ptmcmcsampler_torch.proposals.cycle import draw_kinds
    from ptmcmcsampler_torch.state import state_tensors

    model = CurvedLikelihood() if model_name == "curved" else HierarchicalGaussian()
    cfg = dataclasses.replace(_small_config(**jumps), ndim=model.ndim,
                              groups=(tuple(range(model.ndim)),), nuts_max_depth=6)
    step, run_block = build_step(cfg, model, device=cuda)
    eager, graph = _small_state(cfg, model, cuda), _small_state(cfg, model, cuda)
    kinds = draw_kinds(cfg, 0, 80, eager.host_rng)
    for kind in kinds:
        eager = step(eager, kind)
    graph, _ = run_block(graph, 80, kinds=kinds)
    torch.cuda.synchronize()
    te, tg = state_tensors(eager), state_tensors(graph)
    for path in te:
        assert torch.equal(_bits(te[path]), _bits(tg[path])), path
    assert (eager.it, eager.de.filled, eager.adapt.structure) == (
        graph.it, graph.de.filled, graph.adapt.structure)
    assert torch.equal(eager.rng.get_state(), graph.rng.get_state())
    stats = run_block.stats
    assert stats.captured == len(stats.recorded) > 0 and sum(stats.replays.values()) > 0
    assert stats.iterations == 80 and stats.refreshes == 3


def _sampler(model_kind, outdir, nchains=64, grads=True):
    from ptmcmcsampler_torch import PTSampler

    cl = CurvedLikelihood()
    if model_kind == "lambda":
        fns = (lambda x: cl.lnlikefn(x), lambda x: cl.lnpriorfn(x),
               lambda x: cl.lnlikefn_grad(x), lambda x: cl.lnpriorfn_grad(x))
    else:
        if model_kind == "nosuch":
            class NoSuchFunctor(CurvedLikelihood):
                cuda_functor = "nosuch"
            cl = NoSuchFunctor()
        fns = (cl.lnlikefn, cl.lnpriorfn, cl.lnlikefn_grad, cl.lnpriorfn_grad)
    grad_kw = dict(logl_grad=fns[2], logp_grad=fns[3]) if grads else {}
    return PTSampler(2, fns[0], fns[1], np.eye(2), ntemps=2, nchains=nchains, seed=3,
                     outDir=outdir, verbose=False, **grad_kw)


_SAMPLE = dict(burn=40, Tskip=5, isave=40, covUpdate=40, thin=2, SCAMweight=10, AMweight=10,
               DEweight=10, CHEESweight=10, HMCweight=10, NUTSweight=10, MALAweight=0,
               HMCstepsize=0.08, HMCsteps=50)
_COUNTED = {KIND_CHEES: chees_step, KIND_HMC: hmc_step, KIND_NUTS: nuts_trees}


def _zero_launches():
    for w in (*_COUNTED.values(), chees_trajectories, hmc_trajectories):
        w.launches = 0


@pytest.mark.cuda
def test_sampler_kernel_route_on_the_card(cuda, tmp_path):
    """PTSampler on the card with the bound methods of CurvedLikelihood
    launches each gradient kernel once per iteration of its kind."""
    s = _sampler("bound", str(tmp_path))
    assert s.route == "kernel" and s.device.type == "cuda"
    _zero_launches()
    s.sample([-0.1, -0.5], 120, **_SAMPLE)
    assert s.state.x.is_cuda and torch.isfinite(s.state.x).all()
    for kind, w in _COUNTED.items():
        iters = _iterations(s.config, s.state, kind)
        assert iters > 0
        assert _launches(s.block_stats, w) == iters, kind
    assert chees_trajectories.launches == hmc_trajectories.launches == 0
    assert np.loadtxt(str(tmp_path / "chain_1.0.txt")).shape == (61, 6)


@pytest.mark.cuda
def test_sampler_refuses_gradients_without_functor_on_the_card(cuda, tmp_path):
    """Torch lambdas with gradients have no kernel to run on the card: the
    constructor refuses them, naming the CPU, instead of running plain
    versions there."""
    with pytest.raises(NotImplementedError, match=r'register_functor.*device="cpu"'):
        _sampler("lambda", str(tmp_path))


@pytest.mark.cuda
def test_sampler_without_gradients_on_the_card_launches_nothing(cuda, tmp_path):
    """Torch lambdas without gradients run SCAM/AM/DE on the card, batched
    by vmap: the gradient jumps are dropped and no kernel launches."""
    s = _sampler("lambda", str(tmp_path), grads=False)
    assert s.route == "plain" and s.device.type == "cuda"
    _zero_launches()
    s.sample([-0.1, -0.5], 120, **_SAMPLE)
    assert s.state.x.is_cuda and torch.isfinite(s.state.x).all()
    assert len(s.config.jumps) == 3
    assert all(w.launches == 0 for w in (*_COUNTED.values(), chees_trajectories,
                                         hmc_trajectories))
    assert np.loadtxt(str(tmp_path / "chain_1.0.txt")).shape == (61, 6)


@pytest.mark.cuda
def test_sampler_raises_when_the_functor_kernel_cannot_launch(cuda, tmp_path):
    """A model that takes the kernel route with a functor the kernels do not
    have raises when sample() starts: no plain fallback."""
    s = _sampler("nosuch", str(tmp_path))
    assert s.route == "kernel"
    with pytest.raises(NotImplementedError, match="NoSuchFunctor"):
        s.sample([-0.1, -0.5], 120, **_SAMPLE)


# ---- The wide entries (bench.py's 40-, 50- and 200-D models) ----

WIDE_MODELS = {
    "interval": lambda: IntervalTransformedGaussian(ndim=40),
    "hierarchical": lambda: HierarchicalGaussian(),
    "correlated": lambda: CorrelatedGaussian(ndim=200, seed=1),
}


def _wide_step_inputs(dev, model, t=2, c=300, max_steps=16, seed=0):
    """The fused step's arguments for a wide model: positions around the
    posterior (a few outside the correlated model's box), a random
    well-conditioned chol, rung 0 at its first call."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d = model.ndim
    if isinstance(model, CorrelatedGaussian):
        centre = torch.tensor(model.mu, dtype=torch.float32, device=dev)
    elif isinstance(model, IntervalTransformedGaussian):
        centre = torch.full((d,), -2.5, device=dev)
    else:
        centre = torch.tensor(model.posterior_moments()[0], dtype=torch.float32, device=dev)
    x = centre[None, :, None] + 0.3 * torch.randn((t, d, c), generator=gen, device=dev)
    if isinstance(model, CorrelatedGaussian):
        x[:, 0, ::17] = -0.5  # outside the box [0, 10]
    a = torch.randn((d, d), generator=gen, device=dev) / d
    chol = torch.linalg.cholesky(0.3 * torch.eye(d, device=dev) + a @ a.T).contiguous()
    chol_inv = torch.linalg.inv(chol).contiguous()
    r0 = torch.randn((t, d, c), generator=gen, device=dev)
    u = torch.rand((t, c), generator=gen, device=dev) * (1.0 - 1e-3) + 1e-3
    betas = torch.linspace(1.0, 0.25, t, device=dev)
    eps = torch.full((t, c), 0.02, device=dev)
    eps[0] = 0.0
    tlen = torch.where(eps > 0, eps, 0.02) * max_steps
    return x.contiguous(), r0, u, betas, eps, tlen, 0.02, max_steps, chol, chol_inv


def _same(a, b):
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WIDE_MODELS))
@pytest.mark.parametrize("c", [300, 256])
def test_wide_entries_match_plain_bitwise(cuda, name, c):
    """Both wide entries equal their plain versions bit for bit, on a whole
    number of 256-chain blocks and on a ragged batch."""
    model = WIDE_MODELS[name]()
    args = _wide_step_inputs(cuda, model, c=c)
    before = chees_step.launches
    out = chees_step(*args, model)
    assert chees_step.launches == before + 1
    ref = chees_step_plain(*args, model)
    for name_, a, b in zip(("x1", "q0", "z1", "r1", "qxy", "alpha"), out, ref):
        assert _same(a, b), name_
    x, r0, u, betas, eps, tlen, eps0, max_steps, chol, _ = args
    eps_tc = torch.where(eps > 0, eps, eps0)
    nsteps = torch.clamp(torch.ceil(u * torch.maximum(tlen, eps_tc) / eps_tc), 1,
                         max_steps).to(torch.int32)
    traj = (out[1], r0, betas, eps_tc.contiguous(), nsteps, chol)
    before = chees_trajectories.launches
    got = chees_trajectories(*traj, model)
    assert chees_trajectories.launches == before + 1
    want = chees_trajectories_plain(*traj, model)
    for a, b in zip(got, want):
        assert _same(a, b)
    assert torch.equal(got[0], out[2]) and torch.equal(got[1], out[3])


@pytest.mark.cuda
def test_wide_wrappers_raise(cuda):
    """A wrong D and a missing or wrong constants array raise; the NUTS and
    HMC wrappers launch their wide kernel once a call on a wide model."""
    model = HierarchicalGaussian()
    args = list(_wide_step_inputs(cuda, model))

    class NoConstants(HierarchicalGaussian):
        def cuda_params(self, device):
            return None

    class ShortConstants(HierarchicalGaussian):
        def cuda_params(self, device):
            return super().cuda_params(device)[:-1]

    with pytest.raises(ValueError, match="no constants"):
        chees_step(*args, NoConstants())
    with pytest.raises(ValueError, match="model constants"):
        chees_step(*args, ShortConstants())
    one = [a[:, :1].contiguous() if torch.is_tensor(a) and a.dim() == 3 else a for a in args]
    one[8] = one[9] = torch.ones((1, 1), device=cuda)
    with pytest.raises(ValueError, match="2 <= D <= 1024"):
        chees_step(*one, model)
    wide = IntervalTransformedGaussian(ndim=1025)
    wargs = list(_wide_step_inputs(cuda, wide, c=8))
    with pytest.raises(ValueError, match="got 1025"):
        chees_step(*wargs, wide)
    with pytest.raises(ValueError, match="got 1025"):
        hmc_step(wargs[0], wargs[3], torch.zeros(2, dtype=torch.int64, device=cuda), wargs[8],
                 wargs[9], 0.08, HMC_NMIN, HMC_NMAX, wide)
    with pytest.raises(ValueError, match="no constants"):
        hmc_step(args[0], args[3], torch.zeros(2, dtype=torch.int64, device=cuda), args[8],
                 args[9], 0.08, HMC_NMIN, HMC_NMAX, NoConstants())
    q0, betas, chol = args[0], args[3], args[8]
    before = hmc_trajectories.launches, hmc_step.launches, nuts_trees.launches
    q1, qxy = hmc_trajectories(q0, args[1], betas, torch.ones_like(args[4], dtype=torch.int32),
                               chol, 0.1, model)
    x1, qxy1 = hmc_step(args[0], betas, torch.zeros(2, dtype=torch.int64, device=cuda), chol,
                        args[9], 0.08, HMC_NMIN, HMC_NMAX, model)
    t, d, c = q0.shape
    gen = torch.Generator(device=cuda).manual_seed(1)
    from ptmcmcsampler_torch.proposals.nuts import draw_nuts
    r0, expo, dirs, accu, key, r_eps = draw_nuts(gen, t, d, c, 3, cuda)
    out = nuts_trees(q0, r0, betas, torch.full((t, c), 0.05, device=cuda), expo, dirs, accu,
                     key, chol, model, r_eps=r_eps)
    torch.cuda.synchronize()
    assert (hmc_trajectories.launches, hmc_step.launches, nuts_trees.launches) == tuple(
        b + 1 for b in before)
    assert torch.isfinite(q1).all() and torch.isfinite(x1).all() and torch.isfinite(out[0]).all()


def _wide_tree_inputs(dev, model, c, depth, seed=0):
    """nuts_trees' arguments but the model for a wide model: the fused
    step's positions whitened, NUTS draws, step sizes near 0.05 with some
    lanes at eps <= 0 (they search first)."""
    x, _, _, betas, _, _, _, _, chol, chol_inv = _wide_step_inputs(dev, model, c=c, seed=seed)
    from ptmcmcsampler_torch.proposals.nuts import draw_nuts

    t, d, _ = x.shape
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    r0, expo, dirs, accu, key, r_eps = draw_nuts(gen, t, d, c, depth, dev)
    eps = 0.05 * (1.0 + 0.5 * torch.rand((t, c), generator=gen, device=dev))
    eps[:, ::13] = 0.0
    eps[:, 5::29] = -1.0
    q0 = common.matvec(chol_inv.T, x).contiguous()
    return q0, r0, betas, eps, expo, dirs, accu, key, chol, r_eps


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WIDE_MODELS))
@pytest.mark.parametrize("c", [300, 256])
def test_wide_nuts_matches_plain_bitwise(cuda, name, c):
    """The wide NUTS kernel (reservoir uniforms from the key, the step-size
    search in the kernel) equals its plain version fed the key's uniforms,
    bit for bit, on whole groups and on a ragged batch."""
    model = WIDE_MODELS[name]()
    depth = 4
    q0, r0, betas, eps, expo, dirs, accu, key, chol, r_eps = _wide_tree_inputs(
        cuda, model, c, depth)
    before = nuts_trees.launches
    out = nuts_trees(q0, r0, betas, eps, expo, dirs, accu, key, chol, model, r_eps=r_eps)
    assert nuts_trees.launches == before + 1
    ref = nuts_trees_plain(q0, r0, betas, eps, expo, dirs, accu,
                           nuts_uniforms(key, depth, *eps.shape), chol, model, r_eps)
    for what, a, b in zip(("q_prop", "logp0", "logp_prop", "alpha", "nalpha", "alive", "eps"),
                          out, ref):
        assert _same(a, b), what
    assert (out[6] > 0).all() and out[4].max() > 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WIDE_MODELS))
@pytest.mark.parametrize("c", [300, 256])
def test_wide_hmc_step_matches_plain_bitwise(cuda, name, c):
    """The wide fused HMC step equals its plain version fed the kernel's own
    draws, bit for bit; its draws equal hmc_draws' lengths and momenta
    within 4 ulp; the trajectory entry equals its plain version and the
    step's end points."""
    model = WIDE_MODELS[name]()
    x, _, _, betas, _, _, _, _, chol, chol_inv = _wide_step_inputs(cuda, model, c=c)
    t, d, _ = x.shape
    key = torch.tensor([0x1234567, 0x89ABCDE], dtype=torch.int64, device=cuda)
    for eps in (0.08, 5.0):
        args = (x, betas, key, chol, chol_inv, eps, HMC_NMIN, HMC_NMAX, model)
        before = hmc_step.launches
        x1, qxy = hmc_step(*args)
        assert hmc_step.launches == before + 1
        p0, nsteps = hmc_kernel_draws(key, t, d, c, HMC_NMIN, HMC_NMAX, model)
        p0t, nstepst = hmc_draws(key, t, d, c, HMC_NMIN, HMC_NMAX)
        assert torch.equal(nsteps, nstepst) and int(_ulps(p0, p0t).max()) <= 4
        x1p, qxyp = hmc_step_plain(*args[:2], (p0, nsteps), *args[3:])
        assert _same(x1, x1p) and _same(qxy, qxyp)
        q0 = common.matvec(chol_inv.T, x)
        traj = (q0, p0, betas, nsteps, chol, eps, model)
        q1, qxyk = hmc_trajectories(*traj)
        q1p, qxykp = hmc_trajectories_plain(*traj)
        assert _same(q1, q1p) and _same(qxyk, qxykp)
        assert _same(common.matvec(chol.T, q1), x1) and _same(qxyk, qxy)


def _structured(chol, factor):
    """A factor pair of the kind ``factor`` from a lower ``chol``: its
    diagonal, or itself ("lower"), each with its exact (triangular) inverse."""
    if factor == "diagonal":
        chol = torch.diag(torch.diagonal(chol)).contiguous()
    eye = torch.eye(chol.shape[0], device=chol.device)
    return chol, torch.linalg.solve_triangular(chol, eye, upper=False).contiguous()


def _entries_equal_plain(dev, model, factor):
    """Every wide entry of ``model``'s functor with a factor of the kind
    ``factor`` ("diagonal": tag "diagonal"; "lower": tag "dense") on a
    ragged batch, each held to its plain version bit for bit: the ChEES
    step and trajectory entries, the NUTS tree, the fused HMC step, its
    draws and its trajectory entry. Returns the kernels' outputs and the
    fused step's arguments."""
    c = 300
    args = list(_wide_step_inputs(dev, model, c=c))
    args[8], args[9] = _structured(args[8], factor)
    structure = common.factor_structure(args[8].cpu(), args[9].cpu())
    assert structure == {"diagonal": "diagonal", "lower": "dense"}[factor]
    out = chees_step(*args, model, structure)
    ref = chees_step_plain(*args, model, structure)
    for what, a, b in zip(("x1", "q0", "z1", "r1", "qxy", "alpha"), out, ref):
        assert _same(a, b), what
    x, r0, u, betas, eps, tlen, eps0, max_steps, chol, chol_inv = args
    eps_tc = torch.where(eps > 0, eps, eps0).contiguous()
    nsteps = torch.clamp(torch.ceil(u * torch.maximum(tlen, eps_tc) / eps_tc), 1,
                         max_steps).to(torch.int32)
    traj = (out[1], r0, betas, eps_tc, nsteps, chol, model, structure)
    tout = chees_trajectories(*traj)
    for a, b in zip(tout, chees_trajectories_plain(*traj)):
        assert _same(a, b)
    q0, r0, betas, eps, expo, dirs, accu, key, _, r_eps = _wide_tree_inputs(dev, model, c, 4)
    tree = nuts_trees(q0, r0, betas, eps, expo, dirs, accu, key, chol, model, r_eps=r_eps,
                      structure=structure)
    ref = nuts_trees_plain(q0, r0, betas, eps, expo, dirs, accu,
                           nuts_uniforms(key, 4, *eps.shape), chol, model, r_eps, structure)
    for what, a, b in zip(("q_prop", "logp0", "logp_prop", "alpha", "nalpha", "alive", "eps"),
                          tree, ref):
        assert _same(a, b), what
    t, d, _ = x.shape
    hkey = torch.tensor([0x1234567, 0x89ABCDE], dtype=torch.int64, device=dev)
    hargs = (x, betas, hkey, chol, chol_inv, 0.08, HMC_NMIN, HMC_NMAX, model, structure)
    x1, qxy = hmc_step(*hargs)
    p0, hsteps = hmc_kernel_draws(hkey, t, d, c, HMC_NMIN, HMC_NMAX, model)
    x1p, qxyp = hmc_step_plain(*hargs[:2], (p0, hsteps), *hargs[3:])
    assert _same(x1, x1p) and _same(qxy, qxyp)
    q0 = common.matvec(chol_inv.T, x, structure)
    htraj = (q0, p0, betas, hsteps, chol, 0.08, model, structure)
    q1, qxyk = hmc_trajectories(*htraj)
    q1p, qxykp = hmc_trajectories_plain(*htraj)
    assert _same(q1, q1p) and _same(qxyk, qxykp)
    return (*out, *tout, *tree, x1, qxy, p0, hsteps, q1, qxyk), args


@pytest.mark.cuda
@pytest.mark.parametrize("factor", ["diagonal", "lower"])
@pytest.mark.parametrize("name", sorted(WIDE_MODELS))
def test_wide_entries_with_structured_factors_match_plain_bitwise(cuda, name, factor):
    """Every wide entry with a diagonal factor (tag "diagonal") and a lower
    triangular one (tag "dense") equals its plain version, which keeps the
    same terms, bit for bit, on a ragged batch: the ChEES step and
    trajectory entries, the NUTS tree and the fused HMC step with its
    trajectory entry."""
    model = WIDE_MODELS[name]()
    _, args = _entries_equal_plain(cuda, model, factor)
    with pytest.raises(ValueError, match="structure"):
        chees_step(*args, model, "banded")


# ---- The wide entries past D = 256: groups of 8 (D <= 512) and 4 ----

LARGE_MODELS = {
    **{f"hierarchical{d}": (lambda d=d: HierarchicalGaussian(ngroups=d - 1))
       for d in (270, 512, 513, 1024)},
    **{f"interval{d}": (lambda d=d: IntervalTransformedGaussian(ndim=d))
       for d in (270, 512, 513, 1024)},
    **{f"correlated{d}": (lambda d=d: CorrelatedGaussian(ndim=d, seed=1))
       for d in (300, 513, 1024)},
}


@pytest.mark.cuda
@pytest.mark.parametrize("factor", ["diagonal", "lower"])
@pytest.mark.parametrize("name", sorted(LARGE_MODELS))
def test_wide_entries_past_256_match_plain_bitwise(cuda, name, factor):
    """Every wide entry past D = 256 (groups of 8 to 512, of 4 to 1024, two
    tile stages past 788) equals its plain version bit for bit, with a
    diagonal and a lower triangular factor, on a ragged batch: the ChEES
    step and trajectory entries, the NUTS tree, the fused HMC step, its
    draws and its trajectory entry."""
    model = LARGE_MODELS[name]()
    before = {w: w.launches for w in (chees_step, nuts_trees, hmc_step)}
    _entries_equal_plain(cuda, model, factor)
    assert all(w.launches == n + 1 for w, n in before.items())


@pytest.mark.cuda
def test_kernels_wide_layout_equals_the_python_mirror(cuda):
    """The layout every wide entry computes (models.cuh, read through the
    ``wide_layout`` host entry) equals ops/common.py's at every D to 1024,
    and D = 0 and 1025 are refused."""
    import ctypes

    fn = build.load("chees_trajectory").wide_layout
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int, ctypes.c_void_p]
    out = (ctypes.c_longlong * 3)()
    for d in range(1, common.WIDE_MAX_D + 1):
        assert fn(d, out) == 0
        nb = common.wide_group(d)
        want = (nb, common.wide_stages(d, nb), common.wide_smem_bytes(d, nb))
        assert tuple(out) == want, d
    assert fn(0, out) != 0 and fn(common.WIDE_MAX_D + 1, out) != 0


# ---- A user's functor, registered (ops/user.py) ----

USER_MODELS = {"hierarchy": chip_smoke.UserHierarchy,
               "ref_gaussian": chip_smoke.UserRefGaussian}


@pytest.mark.cuda
@pytest.mark.parametrize("factor", ["diagonal", "lower"])
@pytest.mark.parametrize("name", sorted(USER_MODELS))
def test_user_entries_match_plain_bitwise(cuda, name, factor):
    """Every entry built with a registered user functor (chip_smoke.py's
    two user models) equals its plain version, the model's batched
    value_grad, bit for bit; the user hierarchy's outputs equal the built-in
    hierarchical_gaussian entries' on the same inputs."""
    model = USER_MODELS[name]()
    user.prepare(model, cuda)
    before = {w: w.launches for w in (chees_step, nuts_trees, hmc_step)}
    out, _ = _entries_equal_plain(cuda, model, factor)
    assert all(w.launches == n + 1 for w, n in before.items())
    if name == "hierarchy":
        builtin, _ = _entries_equal_plain(cuda, HierarchicalGaussian(), factor)
        for i, (a, b) in enumerate(zip(out, builtin)):
            assert _same(a, b), i


@pytest.mark.cuda
@pytest.mark.parametrize("factor", ["diagonal", "lower"])
@pytest.mark.parametrize("ngroups", [269, 1023])
def test_user_entries_past_256_match_plain_bitwise(cuda, ngroups, factor):
    """The user hierarchy (registered to D = 1024) at 270-D and 1024-D, where
    8 and 4 of a block's threads run its per-chain loop: every entry equals
    its plain version and the built-in entries, bit for bit."""
    model = chip_smoke.UserHierarchy(ngroups=ngroups)
    user.prepare(model, cuda)
    out, _ = _entries_equal_plain(cuda, model, factor)
    builtin, _ = _entries_equal_plain(cuda, HierarchicalGaussian(ngroups=ngroups), factor)
    for i, (a, b) in enumerate(zip(out, builtin)):
        assert _same(a, b), i


@pytest.mark.cuda
def test_sampler_runs_a_user_functor_on_the_card(cuda, tmp_path):
    """PTSampler takes a user model's bound methods on the card (the kernel
    route, its libraries built at construction): ChEES, NUTS and HMC launch
    the user entries once per iteration of their kind; a D outside the
    functor's dims is refused when sample() starts."""
    from ptmcmcsampler_torch import PTSampler

    m = chip_smoke.UserRefGaussian()
    make = lambda m, out: PTSampler(  # noqa: E731
        m.ndim, m.lnlikefn, m.lnpriorfn, np.eye(m.ndim), logl_grad=m.lnlikefn_grad,
        logp_grad=m.lnpriorfn_grad, ntemps=2, nchains=64, seed=3, outDir=out, verbose=False)
    s = make(m, str(tmp_path / "run"))
    assert s.route == "kernel" and s._model.cuda_functor == "user_ref_gaussian"
    wrappers = {"chees_step": chees_step, "nuts_trees": nuts_trees, "hmc_step": hmc_step}
    for w in wrappers.values():
        w.launches = 0
    s.sample(np.full(m.ndim, 0.1), 60, burn=20, Tskip=5, isave=20, covUpdate=20, thin=1,
             SCAMweight=10, AMweight=10, DEweight=10, CHEESweight=10, NUTSweight=10,
             HMCweight=10, MALAweight=0, HMCstepsize=0.2, HMCsteps=20)
    kinds = [j.kind for j in s.config.jumps]
    for kind, name in ((KIND_CHEES, "chees_step"), (KIND_NUTS, "nuts_trees"),
                       (KIND_HMC, "hmc_step")):
        iters = int(s.state.counters.jump_proposed[kinds.index(kind), 0, 0])
        assert iters > 0
        assert s.block_stats.kernel_launches(name, wrappers[name].launches) == iters
    big = chip_smoke.UserRefGaussian(ndim=100)
    s = make(big, str(tmp_path / "big"))
    with pytest.raises(NotImplementedError, match=r'got 100.*device="cpu"'):
        s.sample(np.zeros(100), 20, burn=10, isave=10, NUTSweight=10)
    assert s.state is None


def _wide_sampler(outdir, nchains=64):
    from ptmcmcsampler_torch import PTSampler

    m = HierarchicalGaussian()
    return PTSampler(m.ndim, m.lnlikefn, m.lnpriorfn, np.eye(m.ndim), logl_grad=m.lnlikefn_grad,
                     logp_grad=m.lnpriorfn_grad, ntemps=2, nchains=nchains, seed=3,
                     outDir=outdir, verbose=False)


@pytest.mark.cuda
@pytest.mark.parametrize("weights", [dict(NUTSweight=20), dict(HMCweight=20)])
def test_sampler_refuses_wide_nuts_and_hmc_on_the_card(cuda, tmp_path, weights):
    """NUTS or HMC on a wide model on the card launches its wide kernel once
    per iteration of its kind; a 1025-D model (beyond the wide layout's
    1024) is refused before any iteration runs, naming the CPU."""
    s = _wide_sampler(str(tmp_path))
    assert s.route == "kernel"
    kw = {**_SAMPLE, "CHEESweight": 0, "NUTSweight": 0, "HMCweight": 0, **weights}
    _zero_launches()
    s.sample(np.zeros(s.ndim), 120, **kw)
    assert torch.isfinite(s.state.x).all()
    for kind, w in _COUNTED.items():
        iters = _iterations(s.config, s.state, kind) if kind in [
            j.kind for j in s.config.jumps] else 0
        assert _launches(s.block_stats, w) == iters, kind
    assert hmc_trajectories.launches == 0 and chees_trajectories.launches == 0
    assert nuts_trees.launches + hmc_step.launches > 0

    from ptmcmcsampler_torch import PTSampler

    m = CorrelatedGaussian(ndim=1025)
    big = PTSampler(m.ndim, m.lnlikefn, m.lnpriorfn, np.eye(m.ndim), logl_grad=m.lnlikefn_grad,
                    logp_grad=m.lnpriorfn_grad, ntemps=2, nchains=16, seed=3,
                    outDir=str(tmp_path / "big"), verbose=False)
    with pytest.raises(NotImplementedError, match="got 1025") as e:
        big.sample(np.full(m.ndim, 5.0), 120, **kw)
    assert 'device="cpu"' in str(e.value) and big.state is None


@pytest.mark.cuda
def test_sampler_wide_chees_on_the_card(cuda, tmp_path):
    """SCAM/AM/DE/ChEES and MALA on a wide model run on the card: one
    chees_step launch a ChEES iteration; MALA launches nothing."""
    s = _wide_sampler(str(tmp_path))
    _zero_launches()
    kw = dict(_SAMPLE, NUTSweight=0, HMCweight=0, MALAweight=10)
    s.sample(np.zeros(s.ndim), 120, **kw)
    assert torch.isfinite(s.state.x).all()
    assert _launches(s.block_stats, chees_step) == _iterations(s.config, s.state, KIND_CHEES) > 0
    assert chees_trajectories.launches == hmc_step.launches == nuts_trees.launches == 0


class _HostReadingLikelihood(CurvedLikelihood):
    """The curved model with a prior that reads the device from the host:
    legal eagerly, impossible inside a CUDA graph."""

    def lnprior(self, x):
        if float(x.abs().max()) > 1e30:
            raise ValueError("unreachable")
        return super().lnprior(x)


@pytest.mark.cuda
def test_a_step_that_reads_the_host_raises_at_capture(cuda):
    """A key's first iteration runs eagerly; its capture, at the key's next
    use, hits the host read and raises naming the jump and the model: the
    runner never falls back to the eager loop."""
    cfg = _small_config()
    model = _HostReadingLikelihood()
    _, run_block = build_step(cfg, model, device=cuda)
    with pytest.raises(RuntimeError, match=r"capturing the \w+ step of model "
                                           r"_HostReadingLikelihood"):
        run_block(_small_state(cfg, model, cuda), 40)
    torch.cuda.synchronize()


# ---- The user's custom, prior-draw and auxiliary jumps in the graphs ----

def _it_gauss_jump(rng, x, it, beta):
    """A symmetric Gaussian step whose size follows the iteration."""
    scale = 0.05 + 0.01 * (it % 7).to(x.dtype)
    return x + scale * torch.randn(x.shape, generator=rng, device=x.device), x.new_zeros(())


def _numpy_it_jump(x, it, beta):
    return x + 0.01 * np.sin(it + np.arange(len(x))), 0.0


def _custom_cycle(model, dev, custom):
    """The 50-D hierarchy's path 1 (SCAM/AM/DE/ChEES) with a custom jump,
    the prior draw and ``chip_smoke.HierarchyReflection`` as the auxiliary
    jump (each reads ``it`` or draws with the generator)."""
    from ptmcmcsampler_torch.config import KIND_CUSTOM, KIND_PRIOR, JumpSpec

    base = _small_config()
    return dataclasses.replace(
        base, ndim=model.ndim, groups=(tuple(range(model.ndim)),),
        jumps=base.jumps + (custom, JumpSpec("DrawFromPrior", KIND_PRIOR, 10,
                                             fn=model.draw_prior)),
        aux_jumps=(JumpSpec("Reflect", KIND_CUSTOM, 1,
                            fn=chip_smoke.HierarchyReflection(model, dev)),))


def _graphs_against_eager(cfg, model, dev, iters=80):
    from ptmcmcsampler_torch.proposals.cycle import draw_kinds
    from ptmcmcsampler_torch.state import state_tensors

    step, run_block = build_step(cfg, model, device=dev)
    eager, graph = _small_state(cfg, model, dev), _small_state(cfg, model, dev)
    kinds = draw_kinds(cfg, 0, iters, eager.host_rng)
    for kind in kinds:
        eager = step(eager, kind)
    chees_step.launches = 0
    graph, _ = run_block(graph, iters, kinds=kinds)
    torch.cuda.synchronize()
    te, tg = state_tensors(eager), state_tensors(graph)
    for path in te:
        assert torch.equal(_bits(te[path]), _bits(tg[path])), path
    assert torch.equal(eager.rng.get_state(), graph.rng.get_state())
    stats = run_block.stats
    assert _launches(stats, chees_step) == _iterations(cfg, graph, KIND_CHEES) > 0
    return graph, stats


@pytest.mark.cuda
def test_custom_jumps_in_graphs_equal_the_eager_step_loop(cuda):
    """A torch-native custom jump that reads ``it``, the prior draw and an
    auxiliary jump that reads ``it``, captured in the step's graphs beside
    the ChEES kernel, equal the eager step loop bit for bit: each replay
    sees the true iteration and draws at the eager loop's offsets."""
    from ptmcmcsampler_torch.config import KIND_CUSTOM, JumpSpec

    model = HierarchicalGaussian()
    cfg = _custom_cycle(model, cuda, JumpSpec("ItGauss", KIND_CUSTOM, 10, fn=_it_gauss_jump))
    graph, stats = _graphs_against_eager(cfg, model, cuda)
    names = cfg.jump_names()
    replayed = {key[0] for key in stats.replays}
    assert {names.index("ItGauss"), names.index("DrawFromPrior")} <= replayed
    assert stats.eager["host jump"] == 0
    assert stats.captured == len(stats.recorded) > 0


@pytest.mark.cuda
def test_numpy_jump_runs_eagerly_only_on_its_own_iterations(cuda):
    from ptmcmcsampler_torch.config import KIND_CUSTOM, JumpSpec

    model = HierarchicalGaussian()
    cfg = _custom_cycle(model, cuda, JumpSpec("NumpyJump", KIND_CUSTOM, 10, fn=_numpy_it_jump,
                                              protocol="host"))
    graph, stats = _graphs_against_eager(cfg, model, cuda)
    own = cfg.jump_names().index("NumpyJump")
    assert stats.eager["host jump"] == int(graph.counters.jump_proposed[own, 0, 0]) > 0
    assert own not in {key[0] for key in stats.replays}
    assert sum(stats.replays.values()) > 0


@pytest.mark.cuda
def test_a_custom_jump_that_reads_the_host_raises_at_capture(cuda):
    """A torch-native jump that reads the device from the host runs in its
    warm-up and raises at its capture, naming the jump: no silent eager
    fallback."""
    from ptmcmcsampler_torch.config import KIND_CUSTOM, JumpSpec

    def host_reading_jump(rng, x, it, beta):
        return x + 0.0 * float(it), x.new_zeros(())

    model = HierarchicalGaussian()
    cfg = _custom_cycle(model, cuda, JumpSpec("HostReading", KIND_CUSTOM, 10,
                                              fn=host_reading_jump))
    _, run_block = build_step(cfg, model, device=cuda)
    with pytest.raises(RuntimeError, match=r"capturing the HostReading step, auxiliary "
                                           r"jump Reflect of model HierarchicalGaussian"):
        run_block(_small_state(cfg, model, cuda), 80)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_sampler_registers_user_jumps_on_the_card(cuda, tmp_path):
    """``PTSampler`` on the card: the kernel route with a torch-native
    custom jump, the prior draw and the auxiliary jump (protocol "torch",
    replayed), and a numpy custom jump and prior draw (protocol "host")."""
    from ptmcmcsampler_torch import PTSampler

    model = HierarchicalGaussian()
    s = PTSampler(model.ndim, model.lnlikefn, model.lnpriorfn, np.eye(model.ndim),
                  logl_grad=model.lnlikefn_grad, logp_grad=model.lnpriorfn_grad, ntemps=2,
                  nchains=64, seed=3, outDir=str(tmp_path), verbose=False)
    s.addProposalToCycle(chip_smoke.small_gauss_jump, 5, name="SmallGauss")
    s.addPriorDrawToCycle(model.draw_prior, 2)
    s.addAuxilaryJump(chip_smoke.HierarchyReflection(model, cuda), name="Reflect")
    s.addProposalToCycle(chip_smoke.numpy_small_gauss_jump, 5, name="NumpyGauss")
    s.addPriorDrawToCycle(chip_smoke.numpy_draw_prior(model), 2, name="NumpyPrior")
    assert [(j.name, j.protocol) for j in s._custom_jumps + s._aux_jumps] == [
        ("SmallGauss", "torch"), ("DrawFromPrior", "torch"), ("NumpyGauss", "host"),
        ("NumpyPrior", "host"), ("Reflect", "torch")]
    _zero_launches()
    s.sample(np.zeros(model.ndim), 200, **dict(_SAMPLE, NUTSweight=0, HMCweight=0))
    assert s.route == "kernel" and torch.isfinite(s.state.x).all()
    names = s.config.jump_names()
    prop = s.state.counters.jump_proposed[:, 0, 0].tolist()
    host = prop[names.index("NumpyGauss")] + prop[names.index("NumpyPrior")]
    assert s.block_stats.eager["host jump"] == host > 0
    assert _launches(s.block_stats, chees_step) == _iterations(s.config, s.state, KIND_CHEES)


# ---- DEO swaps, the adaptive ladder and the DE pair laws in the graphs ----

@pytest.mark.cuda
@pytest.mark.parametrize("de_pair", ["rolled", "iid"])
def test_deo_and_ladder_graphs_equal_the_eager_step_loop(cuda, de_pair):
    """The 50-D hierarchy on 64 rungs x 256 chains, SCAM/AM/DE/ChEES with
    DEO swaps, the adaptive ladder and the rolled (or iid) DE pair law:
    ``run_block``'s graphs against ``step`` after ``step`` over 150
    iterations that cross the ladder's burn (60), bit for bit. Both DEO
    parities, with and without the ladder's update, and the DE iterations
    replay graphs (a shift read back to the host would raise at capture);
    the ladder moves, descending, with both ends kept."""
    from ptmcmcsampler_torch.config import KIND_DE
    from ptmcmcsampler_torch.ladder import ladder_betas, temperature_ladder
    from ptmcmcsampler_torch.proposals.cycle import draw_kinds
    from ptmcmcsampler_torch.state import state_tensors

    model = HierarchicalGaussian()
    d, t, c = model.ndim, 64, 256
    cfg = SamplerConfig(
        ndim=d, ntemps=t, nchains=c, groups=(tuple(range(d)),),
        jumps=build_default_jumps(SCAMweight=10, AMweight=10, DEweight=10, CHEESweight=20,
                                  burn=30, have_grads=True),
        tskip=5, cov_update=50, burn=60, thin=1, de_size=400, hmc_stepsize=0.08,
        swap_mode="deo", de_pair=de_pair, adapt_ladder=True, ladder_adapt_lag=100.0,
        ladder_adapt_time=5.0)
    _, betas = ladder_betas(temperature_ladder(d, t))
    xs = torch.zeros((t, d, c), device=cuda)

    def fresh():
        return init_state(cfg, 4, np.zeros(d), np.eye(d), betas, model.lnlike(xs),
                          model.lnprior(xs), device=cuda)

    step, run_block = build_step(cfg, model, device=cuda)
    eager, graph = fresh(), fresh()
    kinds = draw_kinds(cfg, 0, 150, eager.host_rng)
    for kind in kinds:
        eager = step(eager, kind)
    graph, _ = run_block(graph, 150, kinds=kinds)
    torch.cuda.synchronize()
    te, tg = state_tensors(eager), state_tensors(graph)
    for path in te:
        assert torch.equal(_bits(te[path]), _bits(tg[path])), path
    assert torch.equal(eager.rng.get_state(), graph.rng.get_state())
    stats = run_block.stats
    events = {key[1] for key in stats.replays}
    assert {("deo", 0, "ladder"), ("deo", 1, "ladder"), ("deo", 0), ("deo", 1)} <= events
    de = [j.kind for j in cfg.jumps].index(KIND_DE)
    assert any(key[0] == de for key in stats.replays)
    b0 = fresh().betas
    b = graph.betas
    assert not torch.equal(b, b0) and torch.all(b[1:] < b[:-1])
    assert b[0] == b0[0] and b[-1] == b0[-1]


# ---- The NUTS kernel's general entry (depth to 30, a forced length, the
# capture of lane (T0, C0)) and the entries on the ragged slices of the
# per_chain rotation.

def _general_inputs(dev, model, c, depth, eps_scale=1.0, seed=0):
    """A tree's arguments for the curved or a wide model, with r_eps."""
    if model.ndim == 2:
        args = list(_tree_inputs(dev, depth, c=c, seed=seed))
        r_eps = torch.randn(args[0].shape, generator=torch.Generator(device=dev).manual_seed(5),
                            device=dev)
    else:
        *args, r_eps = _wide_tree_inputs(dev, model, c, depth, seed=seed)
    args[3] = (args[3] * eps_scale).contiguous()
    args[3][0, 0] = args[3][0, 1].abs() + eps_scale * 0.01  # lane (T0, C0) builds a tree
    return args, r_eps


def _check_tree(model, out, ref, label):
    """Bitwise for the wide entries; the curved entry within the default
    curved entry's tolerances (its leaf counts equal)."""
    names = ("q_prop", "logp0", "logp_prop", "alpha", "nalpha", "alive", "eps")
    if model.ndim != 2:
        for what, a, b in zip(names, out, ref):
            assert _same(a, b), f"{label}: {what}"
        return
    for i in (1, 4, 5, 6):
        assert torch.equal(out[i], ref[i]), f"{label}: {names[i]}"
    for i in (0, 2, 3):
        torch.testing.assert_close(out[i], ref[i], rtol=1e-4, atol=1e-4)


_GENERAL_MODELS = {"curved": CurvedLikelihood, **WIDE_MODELS}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["curved", "hierarchical"])
def test_entries_on_a_block_draw_the_unsharded_counters(cuda, name):
    """A sharded run's block (rungs 1.., chains 40..) launched with its
    counter base ``n0`` and the unsharded ``C``: the NUTS default and
    general entries and the fused HMC step equal their block of the
    unsharded call, bit for bit, and their plain versions on the block."""
    from ptmcmcsampler_torch.utils import Block

    model = _GENERAL_MODELS[name]()
    c, depth = (77 if model.ndim > 2 else 1001), 5
    args, r_eps = _general_inputs(cuda, model, c, depth)
    q0, r0, betas, eps, expo, dirs, accu, key, chol = args
    t, d = q0.shape[:2]
    blk = Block(t, c, 1, t, 40, c - 3)
    xd, tc, ltc = ("T", d, "C"), ("T", "C"), (depth, "T", "C")
    bargs = [blk.take(q0, xd), blk.take(r0, xd), blk.take(betas, ("T",)), blk.take(eps, tc),
             blk.take(expo, tc), blk.take(dirs, ltc), blk.take(accu, ltc), key, chol]
    counters = dict(n0=blk.n0, c_total=c)
    for general in (False, True):
        full = nuts_trees(*args, model, r_eps=r_eps, general=general)
        part = nuts_trees(*bargs, model, r_eps=blk.take(r_eps, xd), general=general, **counters)
        for i, (a, b) in enumerate(zip(part, full)):
            assert _same(a, blk.take(b, xd if i == 0 else tc)), (general, i)
    if model.ndim > 2:  # the wide entries equal their plain version bit for bit
        tl, cl = bargs[3].shape
        plain = nuts_trees_plain(*bargs[:7], nuts_uniforms(key, depth, tl, cl, **counters),
                                 chol, model, blk.take(r_eps, xd))
        for a, b in zip(part, plain):
            assert _same(a, b)
    x = (chol.T @ q0).contiguous()
    chol_inv = torch.linalg.inv(chol).contiguous()
    full = hmc_step(x, betas, key, chol, chol_inv, 0.08, HMC_NMIN, HMC_NMAX, model)
    part = hmc_step(blk.take(x, xd), blk.take(betas, ("T",)), key, chol, chol_inv, 0.08,
                    HMC_NMIN, HMC_NMAX, model, **counters)
    for i, (a, b) in enumerate(zip(part, full)):
        assert _same(a, blk.take(b, xd if i == 0 else tc)), i
    tl, cl = t - 1, c - 43
    kernel = hmc_kernel_draws(key, tl, d, cl, HMC_NMIN, HMC_NMAX, model, **counters)
    plain = hmc_draws(key, tl, d, cl, HMC_NMIN, HMC_NMAX, **counters)
    assert torch.equal(kernel[1], plain[1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_GENERAL_MODELS))
def test_general_nuts_entry_equals_the_default_entry(cuda, name):
    """At depth <= 10 the general entry computes the default entry's
    function: every output equal, bit for bit, on a ragged batch."""
    model = _GENERAL_MODELS[name]()
    c = 77 if model.ndim > 2 else 1001
    args, r_eps = _general_inputs(cuda, model, c, 6)
    before = nuts_trees.general_launches
    gen_out = nuts_trees(*args, model, r_eps=r_eps, general=True)
    assert nuts_trees.general_launches == before + 1
    def_out = nuts_trees(*args, model, r_eps=r_eps)
    assert nuts_trees.general_launches == before + 1
    for a, b in zip(gen_out, def_out):
        assert _same(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["curved", "hierarchical"])
@pytest.mark.parametrize("trajlen", [None, 1, 37, 1500])
def test_general_nuts_entry_matches_plain_past_depth_10(cuda, name, trajlen):
    """Depth 12 at a step size small enough that every tree runs to the cap
    (or to the forced length), with the capture, against the plain version
    on the same key: the outputs and the captured lane's buffers."""
    from ptmcmcsampler_torch.config import SamplerConfig as Cfg
    from ptmcmcsampler_torch.trajectory import empty_capture

    model = _GENERAL_MODELS[name]()
    depth, c = 12, (37 if model.ndim > 2 else 200)
    args, _ = _general_inputs(cuda, model, c, depth, eps_scale=1e-4 if name == "curved" else 1e-3)
    cfg = Cfg(ndim=model.ndim, ntemps=1, nchains=1, groups=((0,),),
              jumps=build_default_jumps(), nuts_max_depth=depth)
    cap, cap_ref = empty_capture(cfg, cuda), empty_capture(cfg, cuda)
    out = nuts_trees(*args, model, force_trajlen=trajlen, capture=cap)
    q0, r0, betas, eps, expo, dirs, accu, key, chol = args
    ref = nuts_trees_plain(q0, r0, betas, eps, expo, dirs, accu,
                           nuts_uniforms(key, depth, *eps.shape), chol, model,
                           force_trajlen=trajlen, capture=cap_ref)
    _check_tree(model, out, ref, f"{name} trajlen={trajlen}")
    live = eps > 0
    if trajlen is None:  # nearly every tree past depth 10, some to the cap
        assert float((out[4][live] > 1023).float().mean()) > 0.9
        assert int(out[4][live].max()) == 4095
    else:  # the forced length's leaves, 2**j - 1 + (an even count) past L
        want = {1: 1, 37: 37, 1500: 1501}[trajlen]
        assert torch.equal(out[4][live], torch.full_like(out[4][live], want))
    assert torch.equal(cap.meta, cap_ref.meta) and int(cap.meta[3]) == 1
    assert int(cap.meta[0] + cap.meta[1]) == int(out[4][0, 0]) + 1
    for a, b in zip(cap.tensors()[:4], cap_ref.tensors()[:4]):
        if model.ndim == 2:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        else:
            assert _same(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["curved", "hierarchical"])
def test_entries_on_a_ragged_slice_match_plain(cuda, name):
    """The per_chain rotation runs each kernel on a slice of 3277 chains,
    no multiple of any group: each entry there against its plain version
    (the wide ones bit for bit)."""
    model = _GENERAL_MODELS[name]()
    c = 3277 if model.ndim == 2 else 301
    args, r_eps = _general_inputs(cuda, model, c, 5)
    q0, r0, betas, eps, expo, dirs, accu, key, chol = args
    out = nuts_trees(*args, model, r_eps=r_eps)
    ref = nuts_trees_plain(q0, r0, betas, eps, expo, dirs, accu,
                           nuts_uniforms(key, 5, *eps.shape), chol, model, r_eps)
    _check_tree(model, out, ref, "nuts")
    if model.ndim == 2:
        x, p0, b, e, nsteps, ch = _inputs(cuda, c=c)
        torch.testing.assert_close(chees_trajectories(x, p0, b, e, nsteps, ch, model)[0],
                                   chees_trajectories_plain(x, p0, b, e, nsteps, ch, model)[0],
                                   rtol=1e-4, atol=1e-4)
        return
    sargs = _wide_step_inputs(cuda, model, c=c)
    for a, b in zip(chees_step(*sargs, model), chees_step_plain(*sargs, model)):
        assert _same(a, b)
    x, _, _, betas, _, _, _, _, chol, chol_inv = sargs
    key = torch.tensor([0x1234567, 0x89ABCDE], dtype=torch.int64, device=cuda)
    t, d, _ = x.shape
    hargs = (x, betas, key, chol, chol_inv, 0.08, HMC_NMIN, HMC_NMAX, model)
    draws = hmc_kernel_draws(key, t, d, c, HMC_NMIN, HMC_NMAX, model)
    for a, b in zip(hmc_step(*hargs), hmc_step_plain(x, betas, draws, *hargs[3:])):
        assert _same(a, b)


def _per_chain_case(dev, mode, nchains):
    cfg = dataclasses.replace(
        _small_config(NUTSweight=10, HMCweight=10, CHEESweight=10), nchains=nchains,
        nuts_max_depth=6, jump_select="per_chain", per_chain_mode=mode)
    return cfg, CurvedLikelihood()


@pytest.mark.cuda
@pytest.mark.parametrize("mode, nchains", [("rotation", 1000), ("stacked", 64)])
def test_per_chain_graphs_match_the_eager_loop(cuda, mode, nchains):
    """run_block's graphs under per_chain selection against the eager step
    loop, bit for bit, across DE's activation; every kernel once an
    iteration (on its slice, or on the whole batch)."""
    cfg, model = _per_chain_case(cuda, mode, nchains)
    wrappers = {KIND_CHEES: chees_step, KIND_NUTS: nuts_trees, KIND_HMC: hmc_step}
    result = chip_smoke.per_chain_graphs("NVIDIA H100, 700 W", mode, cfg, model, (-0.1, -0.5),
                                         wrappers, iters=60, block=20)
    assert result["bitwise_equal"] and result["replays"] > 30


@pytest.mark.cuda
def test_per_chain_offset_read_on_the_host_raises_at_capture(cuda, monkeypatch):
    """A rotation offset read to the host (``.item()``, as ``torch.roll``
    would need) cannot be captured: run_block raises, naming the step."""
    from ptmcmcsampler_torch import kernel as t_kernel

    monkeypatch.setattr(t_kernel, "rotation_offset", lambda rng, c, device: torch.tensor(
        int(torch.randint(0, c, (), generator=rng, device=device).item()), device=device))
    cfg, model = _per_chain_case(cuda, "rotation", 256)
    _, run_block = build_step(cfg, model, device=cuda)
    xs = torch.tensor([-0.1, -0.5], device=cuda)[None, :, None].expand(2, 2, 256)
    state = init_state(cfg, 1, np.array([-0.1, -0.5]), np.eye(2), np.array([1.0, 0.5]),
                       model.lnlike(xs), model.lnprior(xs), device=cuda)
    with pytest.raises(RuntimeError, match="capturing the per_chain step"):
        run_block(state, 3)


@pytest.mark.cuda
def test_sampler_trajectory_dir_leaves_the_chain_files_unchanged(cuda, tmp_path):
    """PTSampler with trajectoryDir (the NUTS kernel's general entry, which
    records the trajectory) and without it (the default entry): the same
    chain files, byte for byte, and a file set for each NUTS row."""
    from ptmcmcsampler_torch import PTSampler

    model = HierarchicalGaussian(ngroups=9)
    kw = dict(burn=50, Tskip=5, isave=50, covUpdate=50, thin=5, SCAMweight=10, AMweight=10,
              DEweight=10, CHEESweight=0, NUTSweight=20, HMCweight=10, MALAweight=0)
    for which in ("with", "without"):
        s = PTSampler(model.ndim, model.lnlikefn, model.lnpriorfn, np.eye(model.ndim),
                      logl_grad=model.lnlikefn_grad, logp_grad=model.lnpriorfn_grad, ntemps=2,
                      nchains=64, outDir=str(tmp_path / which), seed=5, verbose=False,
                      device=cuda)
        traj = dict(trajectoryDir=str(tmp_path / "traj"), write_burnin=True) \
            if which == "with" else {}
        before = nuts_trees.general_launches
        s.sample(np.zeros(model.ndim), 200, **kw, **traj)
        assert (nuts_trees.general_launches > before) == (which == "with")
    assert chip_smoke.same_files(str(tmp_path / "with"), str(tmp_path / "without"))
    files = list((tmp_path / "traj").iterdir())
    assert files and len(files) % 3 == 0
