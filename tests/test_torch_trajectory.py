"""NUTS trajectory capture and the trajectoryDir files (the reference's
Trajectory buffer and dumps, nutsjump.py:294-376, :818-835), mirroring
tests/test_trajectory.py on the port, plus its TrajectoryWriter's files
against the JAX package's on the same capture."""

import glob
import os

import numpy as np
import pytest
import torch

from ptmcmcsampler_torch import PTSampler
from ptmcmcsampler_torch.config import KIND_NUTS, KIND_SCAM, JumpSpec, SamplerConfig
from ptmcmcsampler_torch.kernel import build_step
from ptmcmcsampler_torch.models import CurvedLikelihood
from ptmcmcsampler_torch.state import init_state
from ptmcmcsampler_torch.trajectory import (Trajectory, TrajectoryWriter, capture_to_trajectory,
                                            empty_capture)
from ptmcmcsampler_tpu import trajectory as j_trajectory

torch.set_num_threads(2)


class TestTrajectoryBuffer:
    def test_add_and_get(self):
        tr = Trajectory(2, bufsize=4)
        tr.add_sample(np.array([0.0, 0.0]), 0, "plus")
        for i in range(1, 6):
            tr.add_sample(np.array([i, 0.0]), i, "plus")
        tr.add_sample(np.array([-1.0, 0.0]), 6, "minus")
        assert tr.length() == 7
        plus, ip = tr.get_trajectory("plus")
        assert plus.shape == (6, 2) and ip[-1] == 5
        both, _ = tr.get_trajectory("both")
        assert both.shape == (7, 2)
        assert tr.get_used_trajectory(3).shape == (4, 2)  # rows 0..3 on the plus branch
        assert tr.get_used_trajectory(6).shape == (2, 2)  # the start, then the minus path

    def test_used_missing_index_raises(self):
        tr = Trajectory(1)
        tr.add_sample(np.zeros(1), 0, "plus")
        with pytest.raises(ValueError):
            tr.get_used_trajectory(99)


def _config(jumps, **kw):
    return SamplerConfig(ndim=2, ntemps=1, nchains=2, groups=((0, 1),), jumps=jumps,
                         tskip=1000, cov_update=1000, burn=100, thin=1, de_size=16,
                         nuts_max_depth=6, nuts_trajectory=True, **kw)


def _state(cfg, model, seed=3):
    x0 = np.array([0.3, -0.4])
    xs = torch.tensor(x0, dtype=torch.float32)[None, :, None].expand(1, 2, cfg.nchains)
    return init_state(cfg, seed, x0, np.eye(2), np.array([1.0]), model.lnlike(xs),
                      model.lnprior(xs), device="cpu")


class TestKernelCapture:
    def test_capture_matches_sampled_chain(self):
        model = CurvedLikelihood()
        cfg = _config((JumpSpec("NUTSJUMP", KIND_NUTS, 1),))
        step, _ = build_step(cfg, model, device="cpu")
        state = step(_state(cfg, model))
        tr = step.traj.row()
        assert tr["active"]
        lp_, lm_ = int(tr["len_plus"]), int(tr["len_minus"])
        assert lp_ >= 1 and lp_ + lm_ >= 2  # the start and at least one leaf
        assert int(tr["ind_plus"][0]) == 0
        inds = set(tr["ind_plus"][:lp_].tolist()) | set(tr["ind_minus"][:lm_].tolist())
        assert int(tr["used_ind"]) in inds
        used = capture_to_trajectory(tr, 2).get_used_trajectory(int(tr["used_ind"]))
        assert used.ndim == 2 and used.shape[1] == 2 and np.isfinite(used).all()
        # The chosen sample is the chain's proposal: whitened with the
        # identity factor, the chain moved to the used path's end (NUTS
        # always accepts) unless the proposal left the prior.
        if torch.isfinite(state.lnprior[0, 0]):
            np.testing.assert_allclose(used[-1], state.x[0, :, 0].numpy(), rtol=0, atol=0)

    def test_other_jumps_mark_the_capture_inactive(self):
        model = CurvedLikelihood()
        cfg = _config((JumpSpec("NUTSJUMP", KIND_NUTS, 1), JumpSpec("scam", KIND_SCAM, 1)))
        step, run_block = build_step(cfg, model, device="cpu")
        state, out = run_block(_state(cfg, model), 4, kinds=[0, 1, 0, 1])
        assert out.traj.meta[:, 3].tolist() == [1, 0, 1, 0]
        assert out.traj.plus.shape == (4, 64, 2)
        # Rows hold each emitted iteration's capture.
        assert not torch.equal(out.traj.plus[0], out.traj.plus[2])


def _capture_dict(seed, d=3, leaves=16):
    rng = np.random.default_rng(seed)
    lp, lm = 5, 4
    plus = np.zeros((leaves, d), np.float32)
    minus = np.zeros((leaves, d), np.float32)
    plus[:lp] = rng.normal(size=(lp, d))
    minus[:lm] = rng.normal(size=(lm, d))
    order = rng.permutation(np.arange(1, lp + lm))
    ip = np.zeros(leaves, np.int32)
    im = np.zeros(leaves, np.int32)
    ip[1:lp], im[:lm] = order[:lp - 1], order[lp - 1:]
    used = int(im[2]) if seed % 2 else int(ip[3])
    return dict(plus=plus, minus=minus, ind_plus=ip, ind_minus=im, len_plus=np.int32(lp),
                len_minus=np.int32(lm), used_ind=np.int32(used), active=True)


def test_writer_files_equal_the_jax_writers(tmp_path):
    """The port's TrajectoryWriter writes the JAX package's files, byte for
    byte, on the same captures: in burn-in with write_burnin, and after."""
    dirs = {}
    for which, cls in (("port", TrajectoryWriter), ("jax", j_trajectory.TrajectoryWriter)):
        dirs[which] = tmp_path / which
        w = cls(str(dirs[which]), nburn=10, write_burnin=True)
        for it, seed in ((3, 1), (10, 2), (11, 3), (25, 4)):
            w.write(it, _capture_dict(seed))
        w.write(12, dict(_capture_dict(5), active=False))
    names = sorted(os.listdir(dirs["port"]))
    assert names == sorted(os.listdir(dirs["jax"])) and len(names) == 12
    assert "burnin-used-000003.txt" in names and "plus-000015.txt" in names
    for n in names:
        assert (dirs["port"] / n).read_bytes() == (dirs["jax"] / n).read_bytes(), n


def _sampler(outdir):
    cl = CurvedLikelihood()
    return PTSampler(2, cl.lnlikefn, cl.lnpriorfn, np.eye(2), logl_grad=cl.lnlikefn_grad,
                     logp_grad=cl.lnpriorfn_grad, outDir=str(outdir), verbose=False, ntemps=1,
                     nchains=2, seed=11, device="cpu")


def test_e2e_trajectory_dir(tmp_path):
    """PTSampler(trajectoryDir=...): the reference's file names, a file set
    for each NUTS iteration past the burn-in and for each in it with
    write_burnin, and the chain files of the same seeded run without the
    capture, byte for byte (the capture only observes)."""
    kw = dict(burn=10, thin=1, isave=20, covUpdate=50, SCAMweight=1, AMweight=0, DEweight=0,
              NUTSweight=1, HMCweight=0, MALAweight=0)
    trajdir = tmp_path / "traj"
    s = _sampler(tmp_path / "with")
    s.sample(np.zeros(2), 60, trajectoryDir=str(trajdir), write_burnin=True, **kw)
    files = sorted(glob.glob(os.path.join(trajdir, "*.txt")))
    nuts_iters = int(s.state.counters.jump_proposed[s.config.jump_names().index("NUTSJUMP"),
                                                    0, 0])
    assert len(files) == 3 * nuts_iters and nuts_iters > 0
    assert any(os.path.basename(f).startswith("burnin-") for f in files)
    assert any(os.path.basename(f).startswith(("plus-", "minus-", "used-")) for f in files)
    used = [f for f in files if "used" in os.path.basename(f)]
    arr = np.loadtxt(used[-1], ndmin=2)
    assert arr.shape[1] == 2 and np.isfinite(arr).all()
    _sampler(tmp_path / "without").sample(np.zeros(2), 60, **kw)
    for name in sorted(os.listdir(tmp_path / "with")):
        if name.startswith("chain") or name.endswith("_jump.txt") or name == "jumps.txt":
            assert (tmp_path / "with" / name).read_bytes() == \
                (tmp_path / "without" / name).read_bytes(), name


def test_capture_refused_under_per_chain_selection(tmp_path):
    s = _sampler(tmp_path)
    s.jump_select = "per_chain"
    with pytest.raises(ValueError, match="jump_select='shared'"):
        s.sample(np.zeros(2), 20, burn=5, thin=1, isave=10, trajectoryDir=str(tmp_path / "t"))


def test_empty_capture_shapes():
    cfg = _config((JumpSpec("NUTSJUMP", KIND_NUTS, 1),))
    cap = empty_capture(cfg, "cpu", rows=(3,))
    assert cap.plus.shape == (3, 64, 2) and cap.ind_minus.shape == (3, 64)
    assert cap.meta.shape == (3, 4) and not cap.meta.any()
