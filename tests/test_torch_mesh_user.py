"""``jump_select="per_chain"`` and the user's jumps on a sharded mesh, against
the port's one-process run, on the CPU.

Real OS processes (this file run as a script: ``python
tests/test_torch_mesh_user.py --worker RANK WORLD PORT MESH DIR``) join a
``gloo`` process group over ``tcp://localhost`` as
``tests/test_torch_distributed.py``'s do, on the meshes 2 x 1 (rungs split),
1 x 2 (chains split: a rotation slice's chains straddle the ranks, in one
run of slice positions or two) and 2 x 2, and must equal the one-process run
of the same seed bit for bit:

* ``run_block`` through ``build_step(mesh=)`` on the curved target: the
  rotation with SCAM/AM/DE/ChEES/NUTS/HMC, a torch-native custom jump, a
  torch prior draw and a torch auxiliary jump; the stacked mode with
  SCAM/AM/DE/ChEES/NUTS, the torch custom jump and prior draw and a host
  (numpy) auxiliary jump that is deterministic in ``(x, q, it, beta)``;
  shared selection with the torch jumps, a deterministic host custom jump
  and a host prior draw (seeded by the port's seeds). Every field of the
  state and the generators' states.
* ``PTSampler`` with ``addProposalToCycle``, ``addPriorDrawToCycle``,
  ``addAuxilaryJump`` and ``jump_select="per_chain"`` (rotation): a sample
  and its resume; the chain files, the jump files (the user's names, with
  counts gathered over the ranks), ``cov.npy``, the merged all-chain rows
  and the checkpoint.

The one-process runs and the workers run one thread (see
``test_torch_distributed.py``). ``refuse_on_mesh`` still refuses the NUTS
trajectory capture.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from test_torch_distributed import (  # noqa: E402
    _assert_states_equal,
    _files,
    _free_port,
    _merged_sidecar,
)

ROOT = os.path.dirname(HERE)
TIMEOUT = 240  # seconds a launch may take
T, C, D = 4, 32, 2
ROWS, THIN = (12, 8), 2
CENTER = np.array([-0.5, 0.5])


# ---- the user's jumps ----------------------------------------------------------

def gauss_jump(rng, x, it, beta):
    """Torch-native custom jump: a Gaussian step whose size reads ``it``."""
    import torch

    step = 0.2 + 0.05 * (it % 3)
    return x + step * torch.randn(x.shape, generator=rng, device=x.device), x.new_zeros(())


def box_draw(rng):
    """Torch-native prior draw: uniform on the curved target's box."""
    import torch

    return 20.0 * torch.rand((D,), generator=rng, device=rng.device) - 10.0


def jitter_aux(rng, x, q, it, beta):
    """Torch-native auxiliary jump: a small symmetric jitter of ``q``."""
    import torch

    return q + 0.01 * torch.randn(q.shape, generator=rng, device=q.device), q.new_zeros(())


def reflect_host(x, it, beta):
    """Host custom jump, deterministic: the reflection about ``CENTER``."""
    return 2.0 * CENTER - x, 0.01 * beta


def shift_aux_host(x, q, it, beta):
    """Host auxiliary jump, deterministic in ``(x, q, it, beta)``."""
    return q + 1e-3 * (it % 2) * np.sign(x), 0.0


def draw_host(np_rng):
    """Host prior draw from the generator the port seeds."""
    return np_rng.uniform(-10.0, 10.0, D)


def _weights(case):
    w = dict(SCAMweight=10, AMweight=10, DEweight=10, CHEESweight=10)
    if case == "rotation":  # ChEES's slice over half the chains: a rank's part in two runs
        w.update(CHEESweight=100, NUTSweight=10, HMCweight=10)
    elif case == "stacked":
        w.update(NUTSweight=10)
    return w


def _config(case):
    from ptmcmcsampler_torch import SamplerConfig, build_default_jumps
    from ptmcmcsampler_torch.config import KIND_CUSTOM, KIND_PRIOR, JumpSpec

    user = [JumpSpec("Gauss", KIND_CUSTOM, 10, fn=gauss_jump),
            JumpSpec("Box", KIND_PRIOR, 5, fn=box_draw)]
    aux = [JumpSpec("Jitter", KIND_CUSTOM, 1, fn=jitter_aux)]
    select = dict(jump_select="per_chain", per_chain_mode=case)
    if case == "stacked":
        aux = [JumpSpec("ShiftHost", KIND_CUSTOM, 1, fn=shift_aux_host, protocol="host")]
    elif case == "shared":
        user += [JumpSpec("ReflectHost", KIND_CUSTOM, 5, fn=reflect_host, protocol="host"),
                 JumpSpec("BoxHost", KIND_PRIOR, 5, fn=draw_host, protocol="host")]
        select = {}
    return SamplerConfig(
        ndim=D, ntemps=T, nchains=C, groups=(tuple(range(D)),),
        jumps=build_default_jumps(burn=8, have_grads=True, **_weights(case)) + tuple(user),
        aux_jumps=tuple(aux), tskip=3, cov_update=20, burn=24, thin=THIN, de_size=96,
        chees_max_steps=16, nuts_max_depth=4, hmc_nmaxsteps=8, hmc_stepsize=0.08,
        swap_mode="deo" if case == "rotation" else "sweep", **select)


CASES = ("rotation", "stacked", "shared")


def _fresh(cfg, model):
    import torch

    from ptmcmcsampler_torch import init_state
    from ptmcmcsampler_torch.ladder import ladder_betas, temperature_ladder

    _, betas = ladder_betas(temperature_ladder(D, T, tmax=50.0))
    x0 = np.random.default_rng(3).normal(-0.2, 0.4, size=(T, C, D))
    xs = torch.tensor(np.moveaxis(x0, 2, 1), dtype=torch.float32)
    return init_state(cfg, 11, x0, np.eye(D) * 0.5, betas, model.lnlike(xs),
                      model.lnprior(xs), device="cpu")


def run_blocks(case, mesh=None):
    """The case's whole state after ``ROWS`` blocks (gathered on a mesh),
    as ``{path: numpy array}`` with the generators' states."""
    from ptmcmcsampler_torch.kernel import build_step
    from ptmcmcsampler_torch.models import CurvedLikelihood
    from ptmcmcsampler_torch.parallel.mesh import shard_state, unshard_state
    from ptmcmcsampler_torch.state import state_to_numpy

    cfg, model = _config(case), CurvedLikelihood()
    _, run_block = build_step(cfg, model, device="cpu", mesh=mesh)
    state = _fresh(cfg, model)
    if mesh is not None:
        state = shard_state(state, mesh)
    for n in ROWS:
        state, _ = run_block(state, n)
    whole = unshard_state(state, run_block.block)
    out = state_to_numpy(whole)
    out["torch/rng"] = whole.rng.get_state().numpy()
    out["torch/host_rng"] = whole.host_rng.get_state().numpy()
    return out


SAMPLE_KW = dict(burn=20, thin=2, isave=20, Tskip=3, covUpdate=20, SCAMweight=10, AMweight=10,
                 DEweight=10, CHEESweight=20, NUTSweight=0, HMCweight=0, MALAweight=0,
                 HMCstepsize=0.08)


def sample_run(outdir, mesh_shape=None, niter=60, resume_to=100):
    """``PTSampler.sample`` with the user's jumps and ``per_chain``
    (rotation) selection into ``outdir``, then a resumed run to
    ``resume_to``; on the mesh ``mesh_shape`` (None: one process)."""
    from ptmcmcsampler_torch import PTSampler
    from ptmcmcsampler_torch.models import CurvedLikelihood
    from ptmcmcsampler_torch.parallel import make_pt_mesh

    def make(resume):
        cl = CurvedLikelihood()
        mesh = None if mesh_shape is None else make_pt_mesh(*mesh_shape)
        s = PTSampler(D, cl.lnlikefn, cl.lnpriorfn, np.eye(D) * 0.5,
                      logl_grad=cl.lnlikefn_grad, logp_grad=cl.lnpriorfn_grad,
                      ntemps=T, nchains=C, outDir=str(outdir), verbose=False, seed=7,
                      resume=resume, mesh=mesh, swap_mode="deo", jump_select="per_chain",
                      per_chain_mode="rotation", device="cpu")
        s.addProposalToCycle(gauss_jump, 10, name="Gauss")
        s.addPriorDrawToCycle(box_draw, 5, name="Box")
        s.addAuxilaryJump(shift_aux_host, name="ShiftHost")
        return s

    s = make(False)
    s.sample(np.array([-0.1, -0.5]), niter, **SAMPLE_KW)
    s = make(True)
    s.sample(np.array([-0.1, -0.5]), resume_to, **SAMPLE_KW)
    return s


# ---- the workers (this file run as a script) ---------------------------------

def main(argv):
    import torch
    import torch.distributed as dist

    from ptmcmcsampler_torch.parallel import initialize_distributed, make_pt_mesh
    from ptmcmcsampler_torch.utils import Block

    rank, world, port = int(argv[0]), int(argv[1]), int(argv[2])
    mesh_shape, outdir = tuple(json.loads(argv[3])), argv[4]
    torch.set_num_threads(1)
    initialize_distributed(f"tcp://localhost:{port}", world, rank, backend="gloo", timeout=60)
    mesh = make_pt_mesh(*mesh_shape)
    # How often a rank's part of a rotation slice was two runs, or none.
    runs = {1: 0, 2: 0, 0: 0}
    pieces = Block.slice_pieces

    def counting(self, start, n):
        out = pieces(self, start, n)
        runs[len(out)] += 1
        return out

    Block.slice_pieces = counting
    for case in CASES:
        out = run_blocks(case, mesh)
        if rank == 0:
            np.savez(os.path.join(outdir, f"{case}.npz"), **out)
    Block.slice_pieces = pieces
    print("RUNS", rank, runs[0], runs[1], runs[2], flush=True)
    s = sample_run(os.path.join(outdir, "chains"), mesh_shape)
    assert {j.name: j.protocol for j in s.config.jumps + s.config.aux_jumps}.items() >= {
        "Gauss": "torch", "Box": "torch", "ShiftHost": "host"}.items()
    print("OK", rank, s.state.it, flush=True)
    # Leave the group together: a process that exits with gloo's threads
    # still up may abort.
    dist.barrier()
    dist.destroy_process_group()


# ---- the tests ---------------------------------------------------------------

def launch(world, *args):
    """Run ``world`` workers; every one must exit 0. Returns their outputs."""
    import subprocess

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker",
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


@pytest.fixture(autouse=True)
def one_thread():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _reference(tmp_path_factory, cache={}):  # noqa: B006 (one one-process run a test process)
    if not cache:
        cache["states"] = {case: run_blocks(case) for case in CASES}
        cache["dir"] = tmp_path_factory.mktemp("one") / "chains"
        sample_run(cache["dir"])
    return cache


def _checkpoint(outdir):
    with np.load(os.path.join(outdir, "checkpoint.npz")) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("mesh_shape", [(2, 1), (1, 2), (2, 2)],
                         ids=["temperatures", "chains", "two_by_two"])
def test_user_jumps_and_per_chain_on_a_mesh_equal_one_process(tmp_path, tmp_path_factory,
                                                              mesh_shape):
    ref = _reference(tmp_path_factory)
    world = mesh_shape[0] * mesh_shape[1]
    outs = launch(world, json.dumps(list(mesh_shape)), tmp_path)
    lines = [line.split() for o in outs for line in o.splitlines()]
    assert sorted(w[1:] for w in lines if w[0] == "OK") == [[str(r), "100"] for r in range(world)]
    if mesh_shape[1] > 1:  # the chains split: slices in none, one and two runs of a rank
        counts = np.array([[int(v) for v in w[2:]] for w in lines if w[0] == "RUNS"])
        assert (counts > 0).all(), counts
    for case in CASES:
        with np.load(tmp_path / f"{case}.npz") as f:
            got = {k: f[k] for k in f.files}
        _assert_states_equal(got, ref["states"][case], (mesh_shape, case))
    got_dir, ref_dir = tmp_path / "chains", ref["dir"]
    files = _files(got_dir)
    assert {"Gauss_jump.txt", "Box_jump.txt", "jumps.txt"} <= set(files)
    assert files == _files(ref_dir)
    # A multi-process run's all-chain rows start after the seed row.
    merged, whole = _merged_sidecar(got_dir, 1.0), _merged_sidecar(ref_dir, 1.0)
    assert merged.shape == (50, C, D) and merged.tobytes() == whole[1:].tobytes()
    _assert_states_equal(_checkpoint(got_dir), _checkpoint(ref_dir), (mesh_shape, "checkpoint"))


def test_one_process_jump_counts_hold_every_user_jump(tmp_path_factory):
    """The one-process reference ran each of its jumps: the case proves
    the equality above covers the user's jumps and every per_chain kind."""
    ref = _reference(tmp_path_factory)
    for case in CASES:
        proposed = ref["states"][case]["counters/jump_proposed"].sum(axis=(1, 2))
        assert (proposed > 0).all(), (case, proposed)
    counts = _checkpoint(ref["dir"])["counters/jump_proposed"].sum(axis=(1, 2))
    assert (counts > 0).all(), counts


def test_refuse_on_mesh_refuses_only_the_trajectory_capture():
    import dataclasses

    from ptmcmcsampler_torch.kernel import build_step, refuse_on_mesh
    from ptmcmcsampler_torch.models import CurvedLikelihood
    from ptmcmcsampler_torch.parallel import PTMesh

    for case in CASES:
        assert refuse_on_mesh(_config(case)) is None
    cfg = dataclasses.replace(_config("shared"), jump_select="shared", nuts_trajectory=True,
                              jumps=_config("stacked").jumps[:5])
    assert "trajectory capture" in refuse_on_mesh(cfg)
    with pytest.raises(NotImplementedError, match="trajectory capture"):
        build_step(cfg, CurvedLikelihood(), device="cpu", mesh=PTMesh(2, 1, rank=0))


if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "--worker":
    main(sys.argv[2:])
