"""The port's multi-process runs against its one-process run, on the CPU.

The port's counterpart of ``tests/test_distributed.py``: real OS processes
(this file, run as a script: ``python tests/test_torch_distributed.py
--worker ...``) join a ``gloo`` process group over ``tcp://localhost``,
each holds its block of the state on a ``parallel.PTMesh``, and the results
must equal the one-process run of the same seed bit for bit:

* ``run_block`` on the meshes 2 x 1 (rungs split: DEO by neighbour sends,
  the sweep by a gather), 1 x 2 (chains split: the NUTS and HMC counters
  from ``n0 != 0``) and 2 x 2 (four ranks), on path 1 (SCAM/AM/DE/ChEES,
  DEO, the adaptive ladder on) and path 2 (SCAM/AM/DE/NUTS/HMC, the
  sweep): positions, likelihoods, priors, counters, the adaptation, the DE
  ring, the step sizes, the betas and the generators.
* ``PTSampler.sample`` and its resume, chains split: the chain file, the
  jump files and the merged part sidecars equal the one-process run's (the
  parts, as the JAX package's, start after the seed row); the checkpoint
  loads in one process.
* ``PTSampler`` with the rungs split: only rank 0 owns the cold chain and
  votes on the ``neff`` stop, and swaps cross the ranks' boundary.

Each launch has a timeout; a rank that fails makes the launch fail, and the
other ranks are killed. The group's timeout is 60 s.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TIMEOUT = 240  # seconds a launch may take

# run_block cases: (path, swap_mode); the meshes are the launches'.
RUN_CASES = (("chees", "deo"), ("nuts", "sweep"))
T, C, D = 4, 64, 2
BURN, ROWS, THIN = 24, (18, 12), 2


def _config(path, swap_mode):
    from ptmcmcsampler_torch import SamplerConfig, build_default_jumps

    weights = (dict(SCAMweight=10, AMweight=10, DEweight=10, CHEESweight=20) if path == "chees"
               else dict(SCAMweight=10, AMweight=10, DEweight=10, NUTSweight=10, HMCweight=10))
    return SamplerConfig(
        ndim=D, ntemps=T, nchains=C, groups=(tuple(range(D)),),
        jumps=build_default_jumps(burn=8, have_grads=True, **weights),
        tskip=3, cov_update=20, burn=BURN, thin=THIN, de_size=96, chees_max_steps=16,
        nuts_max_depth=4, hmc_nmaxsteps=8, hmc_stepsize=0.08, swap_mode=swap_mode,
        adapt_ladder=path == "chees", ladder_adapt_lag=50.0, ladder_adapt_time=2.0)


def _fresh(cfg, model):
    import torch

    from ptmcmcsampler_torch import init_state
    from ptmcmcsampler_torch.ladder import ladder_betas, temperature_ladder

    _, betas = ladder_betas(temperature_ladder(D, T, tmax=50.0))
    x0 = np.random.default_rng(3).normal(-0.2, 0.4, size=(T, C, D))
    xs = torch.tensor(np.moveaxis(x0, 2, 1), dtype=torch.float32)
    return init_state(cfg, 11, x0, np.eye(D) * 0.5, betas, model.lnlike(xs),
                      model.lnprior(xs), device="cpu")


def run_blocks(path, swap_mode, mesh=None):
    """The case's state after ``ROWS`` blocks, the whole state (gathered
    on a mesh), as ``{path: numpy array}`` with the generators' states."""
    from ptmcmcsampler_torch.kernel import build_step
    from ptmcmcsampler_torch.models import CurvedLikelihood
    from ptmcmcsampler_torch.parallel.mesh import shard_state, unshard_state
    from ptmcmcsampler_torch.state import state_to_numpy

    cfg, model = _config(path, swap_mode), CurvedLikelihood()
    step, run_block = build_step(cfg, model, device="cpu", mesh=mesh)
    state = _fresh(cfg, model)
    if mesh is not None:
        state = shard_state(state, mesh)
    for n in ROWS:
        state, _ = run_block(state, n)
    whole = unshard_state(state, run_block.block)
    out = state_to_numpy(whole)
    out["torch/rng"] = whole.rng.get_state().numpy()
    out["torch/host_rng"] = whole.host_rng.get_state().numpy()
    out["stats/eager"] = np.asarray(run_block.stats.eager["no capture"])
    return out


# Sampler cases: the curved target through PTSampler at ST x SC chains.
ST, SC = 4, 64
SAMPLE_KW = dict(burn=20, thin=2, isave=20, Tskip=3, covUpdate=20, SCAMweight=10, AMweight=10,
                 DEweight=10, CHEESweight=20, NUTSweight=0, HMCweight=0, MALAweight=0,
                 HMCstepsize=0.08)


def sample_run(outdir, mesh_shape=None, resume_to=None, neff=None, swap_mode=None,
               niter=80):
    """``PTSampler.sample`` of ``niter`` iterations into ``outdir``, then,
    with ``resume_to``, a resumed run to that count; on the mesh
    ``mesh_shape`` (None: one process). Returns the sampler."""
    from ptmcmcsampler_torch import PTSampler
    from ptmcmcsampler_torch.models import CurvedLikelihood
    from ptmcmcsampler_torch.parallel import make_pt_mesh

    def make(resume):
        cl = CurvedLikelihood()
        mesh = None if mesh_shape is None else make_pt_mesh(*mesh_shape)
        return PTSampler(2, cl.lnlikefn, cl.lnpriorfn, np.eye(2) * 0.5,
                         logl_grad=cl.lnlikefn_grad, logp_grad=cl.lnpriorfn_grad,
                         ntemps=ST, nchains=SC, outDir=str(outdir), verbose=False, seed=7,
                         resume=resume, mesh=mesh, swap_mode=swap_mode, device="cpu")

    s = make(False)
    s.sample(np.array([-0.1, -0.5]), niter, neff=neff, **SAMPLE_KW)
    if resume_to is not None:
        s = make(True)
        s.sample(np.array([-0.1, -0.5]), resume_to, neff=neff, **SAMPLE_KW)
    return s


# ---- the workers (this file run as a script) ---------------------------------

def _join(rank, world, port):
    from ptmcmcsampler_torch.parallel import initialize_distributed

    initialize_distributed(f"tcp://localhost:{port}", world, rank, backend="gloo", timeout=60)


def _worker_run_block(rank, world, port, mesh_shape, outdir):
    import torch

    from ptmcmcsampler_torch.parallel import make_pt_mesh

    torch.set_num_threads(1)
    _join(rank, world, port)
    mesh = make_pt_mesh(*mesh_shape)
    for path, swap_mode in RUN_CASES:
        out = run_blocks(path, swap_mode, mesh)
        if rank == 0:
            np.savez(os.path.join(outdir, f"{path}-{swap_mode}.npz"), **out)
    print("OK", rank, flush=True)


def _worker_sampler(rank, world, port, mesh_shape, outdir):
    """Chains split: a sample and its resume. Rungs split (``mesh_shape``
    None: the sampler's own mesh): a run with a ``neff`` stop it never
    reaches, so every block votes; prints what each rank owns."""
    import torch

    torch.set_num_threads(1)
    _join(rank, world, port)
    if mesh_shape is not None:
        s = sample_run(outdir, mesh_shape, resume_to=160)
    else:
        s = sample_run(outdir, neff=10**9)
        assert s.config.swap_mode == "deo", s.config.swap_mode
        assert (s.mesh.ntemp, s.mesh.nchain) == (world, 1)
    print("OWNS", rank, int(s._owns_cold), s.state.it, flush=True)


def main(argv):
    import torch.distributed as dist

    kind, rank, world, port = argv[0], int(argv[1]), int(argv[2]), int(argv[3])
    if kind == "run_block":
        _worker_run_block(rank, world, port, tuple(json.loads(argv[4])), argv[5])
    elif kind == "sampler":
        _worker_sampler(rank, world, port, json.loads(argv[4]), argv[5])
    else:
        raise SystemExit(f"unknown worker {kind}")
    # Leave the group together: a process that exits with gloo's threads
    # still up may abort.
    dist.barrier()
    dist.destroy_process_group()


# ---- the tests ---------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(kind, world, *args):
    """Run ``world`` workers of ``kind``; every one must exit 0. Returns
    their outputs. A worker that fails or outlives ``TIMEOUT`` fails the
    launch, and the others are killed."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", kind,
                               str(r), str(world), str(port), *map(str, args)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"worker failed ({p.returncode}):\n{out}\n{err}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def _assert_states_equal(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, (what, k)
        assert got[k].tobytes() == want[k].tobytes(), (what, k)


@pytest.fixture(autouse=True)
def one_thread():
    """The one-process runs on one thread, as the workers (BLAS and the
    eigendecomposition round by their threads' split on the CPU)."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _reference(cache={}):  # noqa: B006 (one one-process run a case per test process)
    if not cache:
        for case in RUN_CASES:
            cache[case] = run_blocks(*case)
    return cache


def _check_mesh(tmp_path, mesh_shape):
    world = mesh_shape[0] * mesh_shape[1]
    launch("run_block", world, json.dumps(list(mesh_shape)), tmp_path)
    for (path, swap_mode), want in _reference().items():
        with np.load(tmp_path / f"{path}-{swap_mode}.npz") as f:
            got = {k: f[k] for k in f.files}
        _assert_states_equal(got, want, (mesh_shape, path, swap_mode))


def test_run_block_temperatures_split(tmp_path):
    _check_mesh(tmp_path, (2, 1))


def test_run_block_chains_split(tmp_path):
    _check_mesh(tmp_path, (1, 2))


def test_run_block_two_by_two(tmp_path):
    _check_mesh(tmp_path, (2, 2))


def _files(outdir):
    """``{name: bytes}`` of the chain and jump files and ``cov.npy``."""
    names = sorted(f for f in os.listdir(outdir)
                   if f.endswith(".txt") or f == "cov.npy")
    return {f: open(os.path.join(outdir, f), "rb").read() for f in names}


def _merged_sidecar(outdir, temp):
    from ptmcmcsampler_torch.io.chainfile import ChainWriter

    return ChainWriter(str(outdir), np.array([temp]), resume=True).load_all(0)


def _checkpoint(outdir):
    with np.load(os.path.join(outdir, "checkpoint.npz")) as f:
        return {k: f[k] for k in f.files}


def test_sampler_chains_split_sample_and_resume(tmp_path):
    from ptmcmcsampler_torch.io.checkpoint import load_checkpoint

    ref_dir, got_dir = tmp_path / "one", tmp_path / "two"
    ref = sample_run(ref_dir, resume_to=160)
    outs = launch("sampler", 2, json.dumps([1, 2]), got_dir)
    owns = sorted(tuple(line.split()[1:]) for o in outs for line in o.splitlines()
                  if line.startswith("OWNS"))
    assert owns == [("0", "1", "160"), ("1", "0", "160")], owns
    assert _files(got_dir) == _files(ref_dir)
    # Each rank's part of the all-chain rows, merged: the one-process
    # sidecar's rows after its seed row (the parts start after it).
    parts = sorted(f for f in os.listdir(got_dir) if f.startswith("chain_all_1.0.c"))
    assert parts == ["chain_all_1.0.c0.bin", "chain_all_1.0.c0.json",
                     "chain_all_1.0.c32.bin", "chain_all_1.0.c32.json"], parts
    merged, whole = _merged_sidecar(got_dir, 1.0), _merged_sidecar(ref_dir, 1.0)
    assert merged.shape == (80, SC, 2) and merged.tobytes() == whole[1:].tobytes()
    got, want = _checkpoint(got_dir), _checkpoint(ref_dir)
    _assert_states_equal(got, want, "checkpoint")
    state, meta, restored = load_checkpoint(str(got_dir / "checkpoint.npz"), ref.config, "cpu")
    assert restored and meta["iter"] == 160 and state.it == 160


def test_sampler_temperatures_split_owner_votes(tmp_path):
    ref_dir, got_dir = tmp_path / "one", tmp_path / "two"
    ref = sample_run(ref_dir, neff=10**9, swap_mode="deo")
    outs = launch("sampler", 2, "null", got_dir)
    owns = sorted(tuple(line.split()[1:]) for o in outs for line in o.splitlines()
                  if line.startswith("OWNS"))
    # Only rank 0 holds the cold chain 0, so only it votes on the stop.
    assert owns == [("0", "1", "80"), ("1", "0", "80")], owns
    assert _files(got_dir) == _files(ref_dir)
    got = _checkpoint(got_dir)
    _assert_states_equal(got, _checkpoint(ref_dir), "checkpoint")
    # Swaps crossed the ranks' boundary (pair (1, 2) between rungs 1 and 2).
    assert got["counters/swaps_accepted"][1].sum() > 0
    assert ref.config.swap_mode == "deo"


if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "--worker":
    main(sys.argv[2:])
