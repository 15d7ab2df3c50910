"""Joining a process group and laying a (temperature x chain) grid of
processes over it.

The reference distributes with ``mpirun -np N`` over mpi4py (README.md:40-46,
PTMCMCSampler.py:9-13); the JAX package forms one SPMD program over a
multi-host device mesh (``ptmcmcsampler_tpu/parallel/distributed.py``). The
port runs one process a device, as ``torchrun --nproc_per_node=N`` starts
them: ``initialize_distributed`` joins the group, and
:func:`make_pt_mesh` gives each rank a block of rungs and chains
(:class:`~ptmcmcsampler_torch.parallel.mesh.PTMesh`). Between the ranks'
device work the step runs ``torch.distributed`` collectives (the cold rows,
the cross-chain statistics, the DEO neighbours' rows).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .mesh import PTMesh

_initialized = False


def process_count() -> int:
    """The ranks of the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def default_backend(local_world):
    """``"nccl"`` where every rank of this host has a card of its own,
    ``"gloo"`` otherwise: on the CPU, and for ranks that share a card (NCCL
    refuses two ranks on one GPU). With ``gloo`` the port stages the rows it
    exchanges through host memory."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return "nccl" if cards >= max(int(local_world), 1) else "gloo"


def initialize_distributed(init_method=None, world_size=None, rank=None, backend=None,
                           timeout=None):
    """Join the process group (idempotent).

    With no arguments it reads ``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR``
    / ``MASTER_PORT`` from the environment, as ``torchrun`` sets them; with
    nothing to join (no ``WORLD_SIZE``, or one process) it is a no-op, the
    reference's ``nompi4py.MPIDummy`` serial fallback. ``init_method`` (for
    example ``"tcp://localhost:29500"``), ``world_size`` and ``rank`` name the
    group where no launcher set the environment. ``backend`` is the caller's
    choice; by default :func:`default_backend`. ``timeout`` (seconds) bounds
    every collective, so a rank that died leaves the others an error, not a
    wait forever.
    """
    global _initialized
    if _initialized or (dist.is_available() and dist.is_initialized()):
        _initialized = True
        return
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if int(world_size) <= 1:
        _initialized = True  # single process: nothing to join
        return
    if rank is None:
        rank = int(os.environ["RANK"])
    if init_method is None:
        init_method = "env://"
    if backend is None:
        backend = default_backend(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(backend, init_method=init_method, world_size=int(world_size),
                            rank=int(rank), **kw)
    _initialized = True


def make_pt_mesh(ntemp_devices=None, nchain_devices=1, temp_axis="temp", chain_axis="chain"):
    """The 2-D (temp, chain) grid of the process group's ranks, one rank a
    shard: rank ``r`` holds grid cell ``divmod(r, nchain_devices)``.

    ``temp`` is the replica-exchange axis (adjacent rungs exchange rows every
    ``tskip`` iterations, DEO by a neighbour send); ``chain`` is
    embarrassingly parallel (only the adaptation's cross-chain statistics
    cross it). ``ntemp_devices`` defaults to the ranks over
    ``nchain_devices``. The grid must tile the ranks, one process a device.
    """
    n = process_count()
    if ntemp_devices is None:
        ntemp_devices = n // nchain_devices
    if ntemp_devices * nchain_devices > n:
        raise ValueError(f"mesh {ntemp_devices}x{nchain_devices} needs more than {n} devices")
    if ntemp_devices * nchain_devices != n:
        raise ValueError(
            f"mesh {ntemp_devices}x{nchain_devices}: nchain_devices={nchain_devices} times "
            f"ntemp_devices={ntemp_devices} must be a multiple of the process count {n} and no "
            "more (one process a shard), so the grid tiles the processes")
    return PTMesh(ntemp_devices, nchain_devices, rank=process_index(), temp_axis=temp_axis,
                  chain_axis=chain_axis)


def process_local_block(sampler_state):
    """This process's block of the positions (``[Tl, D, Cl]``): what an MPI
    rank holds of the reference's chains, for host-side I/O. A list of one
    tensor, as the JAX package's list of addressable shards."""
    return [sampler_state.x]


def rank_device(device):
    """A bare ``"cuda"`` as this rank's card, ``cuda:{LOCAL_RANK % cards}``
    (the rank where no launcher set ``LOCAL_RANK``), made current; any other
    device as given. Ranks that outnumber the cards share them."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None or not torch.cuda.is_available():
        return device
    local = int(os.environ.get("LOCAL_RANK", process_index()))
    device = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(device)
    return device
