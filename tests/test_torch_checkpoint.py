"""The port's checkpoints: the DE fill count's int32 bound (C1), the file
format the JAX package reads, its generator states, the JAX loader's
layout migrations, and exact continuation of a resumed ``PTSampler`` run.

Tolerances: arrays that cross between the packages are compared for
equality (the format stores them as they are).
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from ptmcmcsampler_torch import PTSampler, SamplerConfig, build_default_jumps, init_state
from ptmcmcsampler_torch.adaptation import de_buffer_push, de_valid_rows
from ptmcmcsampler_torch.io.checkpoint import load_checkpoint, save_checkpoint
from ptmcmcsampler_torch.models import CurvedLikelihood
from ptmcmcsampler_torch.state import state_from_numpy, state_to_numpy
from ptmcmcsampler_tpu.config import SamplerConfig as JConfig
from ptmcmcsampler_tpu.config import build_default_jumps as j_jumps
from ptmcmcsampler_tpu.io.checkpoint import _path_name
from ptmcmcsampler_tpu.io.checkpoint import load_checkpoint as j_load_checkpoint
from ptmcmcsampler_tpu.state import init_state as j_init_state

torch.set_num_threads(2)

B = 1000  # DE ring columns of the small config
C1_FILL = 131072 * 16384  # 131072 iterations at 16384 chains: 2**31


def _config(nchains=8):
    return SamplerConfig(
        ndim=2, ntemps=2, nchains=nchains, groups=((0, 1),),
        jumps=build_default_jumps(SCAMweight=10, AMweight=10, DEweight=10, burn=B),
        burn=B, de_size=B,
    )


def _state(cfg, seed=0):
    t, c = cfg.ntemps, cfg.nchains
    return init_state(cfg, seed, np.array([0.1, -0.4]), np.eye(2), np.array([1.0, 0.5]),
                      np.zeros((t, c)), np.zeros((t, c)), device="cpu")


def _ring_after_push(filled, xs, buf):
    """The ring after one push under the law before the repair: column
    ``(filled % B + i) % B`` takes ``xs[:, i]``."""
    buf = buf.clone()
    for i in range(xs.shape[1]):
        buf[:, (filled % B + i) % B] = xs[:, i]
    return buf


def test_c1_export_and_reload_at_2_31_columns():
    """At 131072 iterations of 16384 chains the fill count reaches 2**31:
    the export raised OverflowError before the repair. It now exports and
    reloads as a full ring with the same start, and the next push writes
    the columns the unbounded count would."""
    cfg = _config()
    state = _state(cfg)
    state.de.buf.copy_(torch.arange(2 * B, dtype=torch.float32).view(2, B))
    state.de.filled = C1_FILL
    arrays = state_to_numpy(state)
    assert arrays["de/filled"].dtype == np.int32
    back = state_from_numpy(arrays, cfg, "cpu")
    assert back.de.filled % B == C1_FILL % B
    assert B <= back.de.filled < 2 * B and de_valid_rows(back.de) == B
    xs = -1.0 - torch.arange(2 * 8, dtype=torch.float32).view(2, 8)
    expected = _ring_after_push(C1_FILL, xs, state.de.buf)
    pushed = de_buffer_push(back.de, xs)
    assert torch.equal(pushed.buf, expected)
    assert pushed.filled % B == (C1_FILL + 8) % B and de_valid_rows(pushed) == B


def test_c1_fill_count_stays_bounded():
    """Pushes keep the count below 2 B with the start of the unbounded
    count, from empty through many wraps."""
    de = _state(_config(nchains=300)).de
    total = 0
    for k in range(40):
        xs = torch.full((2, 300), float(k))
        expected = _ring_after_push(total, xs, de.buf)
        de = de_buffer_push(de, xs)
        total += 300
        assert torch.equal(de.buf, expected)
        assert de.filled < 2 * B and de.filled % B == total % B
        assert de_valid_rows(de) == min(total, B)


def test_c1_negative_jax_fill_count_loads_as_full_ring():
    """The JAX package's int32 count wraps negative past 2**31 pushes; such a
    checkpoint loads as a full ring at that count plus 2**32."""
    cfg = _config()
    arrays = state_to_numpy(_state(cfg))
    arrays["de/filled"] = np.asarray(-7, np.int32)
    back = state_from_numpy(arrays, cfg, "cpu")
    assert de_valid_rows(back.de) == B and B <= back.de.filled < 2 * B
    assert back.de.filled % B == (2**32 - 7) % B


def test_save_load_round_trip_restores_generators(tmp_path):
    cfg = _config()
    state = _state(cfg, seed=3)
    torch.rand(5, generator=state.rng)  # move both streams off their seeds
    torch.rand(7, generator=state.host_rng)
    state.counters.naccepted += 4
    path = str(tmp_path / "checkpoint.npz")
    save_checkpoint(path, state, meta={"iter": 12}, key=[5, 6])
    assert sorted(os.listdir(tmp_path)) == ["checkpoint.npz", "checkpoint.npz.json"]
    with np.load(path) as data:
        assert str(data["__format__"]) == "ptmcmc-ckpt-v2-pathkeys"
        np.testing.assert_array_equal(data["key"], np.array([5, 6], np.uint32))
        assert data["key"].dtype == np.uint32 and str(data["torch/device"]) == "cpu"
    back, meta, restored = load_checkpoint(path, cfg, "cpu", seed=99)
    assert restored and meta == {"iter": 12}
    for name, a in state_to_numpy(state).items():
        np.testing.assert_array_equal(state_to_numpy(back)[name], a, err_msg=name)
    assert torch.equal(torch.rand(4, generator=back.rng), torch.rand(4, generator=state.rng))
    assert torch.equal(torch.rand(4, generator=back.host_rng),
                       torch.rand(4, generator=state.host_rng))


def test_generators_from_another_device_are_seeded(tmp_path):
    """Generator states saved for another device type are not restored: the
    loaded state's generators are seeded from ``seed``."""
    cfg = _config()
    path = str(tmp_path / "checkpoint.npz")
    save_checkpoint(path, _state(cfg, seed=3))
    data = dict(np.load(path))
    data["torch/device"] = np.asarray("cuda")
    np.savez(path, **data)
    back, meta, restored = load_checkpoint(path, cfg, "cpu", seed=11)
    fresh = _state(cfg, seed=11)
    assert not restored and meta is None
    assert torch.equal(torch.rand(4, generator=back.rng), torch.rand(4, generator=fresh.rng))


@pytest.mark.parametrize("fault", ["format", "missing", "shape"])
def test_load_refuses_what_it_cannot_place(tmp_path, fault):
    cfg = _config()
    path = str(tmp_path / "checkpoint.npz")
    save_checkpoint(path, _state(cfg))
    data = dict(np.load(path))
    if fault == "format":
        data["__format__"] = np.asarray("ptmcmc-ckpt-v1")
    elif fault == "missing":
        del data["adapt/cov"]
    else:
        data["lnlike"] = data["lnlike"][:, :-1]
    np.savez(path, **data)
    with pytest.raises(ValueError):
        load_checkpoint(path, cfg, "cpu")


def _run(outdir, niter=200, resume=False, **kw):
    """The JAX package's ``tests/test_resume_fixes.py`` run, on the port."""
    s = PTSampler(
        2, lambda x: -0.5 * torch.sum(x**2),
        lambda x: torch.where(torch.all(torch.abs(x) < 10.0), 0.0, float("-inf")),
        np.eye(2), outDir=outdir, ntemps=3, nchains=4, seed=2, resume=resume,
        device="cpu", verbose=False, **kw,
    )
    s.sample(np.zeros(2), niter, burn=50, thin=1, isave=100, Tskip=10,
             SCAMweight=20, AMweight=20, DEweight=20)
    return s


def test_lad_counter_leaves_backfill_from_cumulative(tmp_path):
    out = str(tmp_path / "chains")
    s = _run(out)
    path = os.path.join(out, "checkpoint.npz")
    data = dict(np.load(path))
    dropped = {k: v for k, v in data.items() if not k.endswith("_lad")}
    np.savez(path, **dropped)
    loaded, _, _ = load_checkpoint(path, s.config, "cpu")
    ctr = loaded.counters
    assert torch.equal(ctr.swaps_proposed_lad, ctr.swaps_proposed)
    assert torch.equal(ctr.swaps_accepted_lad, ctr.swaps_accepted)
    assert torch.equal(loaded.adapt.cov, s.state.adapt.cov)


def test_old_layout_checkpoint_transposes_on_load(tmp_path):
    """x stored as [T, C, D] and the DE ring as [B, D] load transposed."""
    out = str(tmp_path / "chains")
    s = _run(out)
    path = os.path.join(out, "checkpoint.npz")
    data = dict(np.load(path))
    data["x"] = np.moveaxis(data["x"], 1, 2)
    data["de/buf"] = data["de/buf"].T
    np.savez(path, **data)
    loaded, _, _ = load_checkpoint(path, s.config, "cpu")
    assert torch.equal(loaded.x, s.state.x)
    assert torch.equal(loaded.de.buf, s.state.de.buf)


def test_swap_mode_persisted_in_meta_and_reused(tmp_path):
    """A resumed run keeps the swap mode its checkpoint meta records."""
    out = str(tmp_path / "chains")
    _run(out)
    meta_path = os.path.join(out, "checkpoint.npz.json")
    meta = json.load(open(meta_path))
    assert meta["swap_mode"] == "sweep"
    meta["swap_mode"] = "deo"
    json.dump(meta, open(meta_path, "w"))
    s2 = PTSampler(2, lambda x: -0.5 * torch.sum(x**2), lambda x: torch.zeros(()), np.eye(2),
                   outDir=out, ntemps=3, nchains=4, seed=2, resume=True, device="cpu",
                   verbose=False)
    assert s2._resolved_swap_mode() == "deo"


def test_port_checkpoint_loads_through_the_jax_loader(tmp_path):
    """A port checkpoint loads into a JAX template of the same config: every
    leaf equal to the port's array, and the key leaf the port wrote."""
    out = str(tmp_path / "chains")
    s = _run(out)
    path = os.path.join(out, "checkpoint.npz")
    jcfg = JConfig(
        ndim=2, ntemps=3, nchains=4, groups=((0, 1),),
        jumps=j_jumps(SCAMweight=20, AMweight=20, DEweight=20, NUTSweight=0, MALAweight=0,
                      HMCweight=0, burn=50),
        tskip=10, cov_update=1000, burn=50, thin=1, de_size=50,
    )
    template = j_init_state(jcfg, jax.random.key(0), np.zeros(2), np.eye(2),
                            np.ones(3), np.zeros((3, 4)), np.zeros((3, 4)))
    loaded, meta = j_load_checkpoint(path, template)
    assert meta["iter"] == 200
    ours = state_to_numpy(s.state)
    names = set()
    for leaf_path, leaf in jax.tree_util.tree_flatten_with_path(loaded)[0]:
        name = _path_name(leaf_path)
        names.add(name)
        if name == "key":
            np.testing.assert_array_equal(jax.random.key_data(leaf), s._key_words)
            continue
        np.testing.assert_array_equal(np.asarray(leaf), ours[name], err_msg=name)
    assert names == set(ours) | {"key"}


def _files(outdir):
    out = {}
    for name in sorted(os.listdir(outdir)):
        if not name.startswith("checkpoint"):
            with open(os.path.join(outdir, name), "rb") as f:
                out[name] = f.read()
    return out


def _curved_run(outdir, niter, resume, weights):
    cl = CurvedLikelihood()
    s = PTSampler(2, cl.lnlikefn, cl.lnpriorfn, np.eye(2), logl_grad=cl.lnlikefn_grad,
                  logp_grad=cl.lnpriorfn_grad, ntemps=2, nchains=16, seed=7, outDir=outdir,
                  resume=resume, device="cpu", verbose=False)
    s.sample([-0.1, -0.5], niter, burn=100, Tskip=5, isave=100, covUpdate=100, thin=2,
             HMCstepsize=0.08, HMCsteps=20, NUTSmaxdepth=5, **weights)
    return s


@pytest.mark.parametrize("cycle", ["chees", "nuts_hmc_mala"])
def test_resumed_run_continues_byte_for_byte(tmp_path, cycle):
    """A run of 2N iterations and a run of N resumed to 2N leave the same
    bytes in every chain file: the checkpoint restores the generators."""
    zero = dict(SCAMweight=10, AMweight=10, DEweight=10, NUTSweight=0, HMCweight=0,
                MALAweight=0, CHEESweight=0)
    if cycle == "chees":
        weights, n = dict(zero, CHEESweight=20), 200
    else:
        weights, n = dict(zero, NUTSweight=10, HMCweight=10, MALAweight=10), 100
    whole, parts = str(tmp_path / "whole"), str(tmp_path / "parts")
    _curved_run(whole, 2 * n, False, weights)
    _curved_run(parts, n, False, weights)
    s = _curved_run(parts, 2 * n, True, weights)
    assert s._resume_start_iter == n
    a, b = _files(whole), _files(parts)
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name] == b[name], name
    assert len(a["chain_1.0.txt"].splitlines()) == 1 + 2 * n // 2


def test_jax_style_resume_without_generators_reseeds(tmp_path, capsys):
    """A checkpoint without torch generator state (as the JAX package
    writes) resumes, with a NOTE, from generators seeded afresh."""
    weights = dict(SCAMweight=10, AMweight=10, DEweight=10, NUTSweight=0, HMCweight=0,
                   MALAweight=0, CHEESweight=20)
    out = str(tmp_path / "run")
    _curved_run(out, 100, False, weights)
    path = os.path.join(out, "checkpoint.npz")
    data = {k: v for k, v in np.load(path).items() if not k.startswith("torch/")}
    np.savez(path, **data)
    shutil.copy(path, path + ".bak")
    cl = CurvedLikelihood()
    s = PTSampler(2, cl.lnlikefn, cl.lnpriorfn, np.eye(2), logl_grad=cl.lnlikefn_grad,
                  logp_grad=cl.lnpriorfn_grad, ntemps=2, nchains=16, seed=7, outDir=out,
                  resume=True, device="cpu")
    s.sample([-0.1, -0.5], 200, burn=100, Tskip=5, isave=100, covUpdate=100, thin=2,
             HMCstepsize=0.08, **weights)
    text = capsys.readouterr().out
    assert "Resuming from checkpoint at iteration 100" in text
    assert "holds no torch generator state" in text
    assert np.loadtxt(os.path.join(out, "chain_1.0.txt")).shape == (101, 6)
