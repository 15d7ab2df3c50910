"""The (temperature x chain) grid of ranks, the placement of the sampler
state on it, and the collectives a sharded step runs.

The port of ``ptmcmcsampler_tpu/parallel/mesh.py``. The JAX package shards
one SPMD program over a device mesh and lets GSPMD insert the collectives;
here each process drives one device and holds one block of the state
(rungs ``[t0, t1)``, chains ``[c0, c1)``: ``utils.Block``), and the step
calls the collectives itself, between its device work:

  * the swap: DEO sends each shard's boundary rows to its temperature
    neighbours (``swaps.make_sharded_deo``); the sweep gathers the rows;
  * adaptation: the Welford moments, the DE ring and the factors are
    replicated, and every rank derives them alike from the cold rows it
    gathers (the JAX package's "every device derives identical adaptation
    state"); so are ChEES's and the ladder's cross-chain statistics.

Every statistic that reads rows another rank owns gathers those rows and
runs the unchanged unsharded function on them (:func:`gather`), so a
sharded run equals the unsharded one bit for bit, and every rank holds the
identical result. With the ``gloo`` backend the tensors on a card are staged
through pinned host memory (the one backend-specific step).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..utils import Block


class PTMesh:
    """A grid of ``ntemp x nchain`` ranks, one process a shard: rank ``r``
    holds the cell ``divmod(r, nchain)``. ``shape`` maps each axis name to its
    extent, as a JAX mesh's; a mesh of one rank is the unsharded run."""

    def __init__(self, ntemp=1, nchain=1, rank=0, temp_axis="temp", chain_axis="chain",
                 axis_names=None):
        self.ntemp, self.nchain = int(ntemp), int(nchain)
        self.size = self.ntemp * self.nchain
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside the {self.ntemp}x{self.nchain} mesh")
        self.rank = int(rank)
        self.ti, self.ci = divmod(self.rank, self.nchain)
        self.temp_axis, self.chain_axis = temp_axis, chain_axis
        self.axis_names = tuple(axis_names or (temp_axis, chain_axis))
        extent = {temp_axis: self.ntemp, chain_axis: self.nchain}
        self.shape = {a: extent[a] for a in self.axis_names}

    def __repr__(self):
        return f"PTMesh({self.ntemp}x{self.nchain}, rank {self.rank})"

    def rank_of(self, ti, ci):
        return ti * self.nchain + ci

    def bounds(self, rank, ntemps, nchains):
        """Rank ``rank``'s rungs and chains, ``(t0, t1, c0, c1)``."""
        ti, ci = divmod(rank, self.nchain)
        tl, cl = ntemps // self.ntemp, nchains // self.nchain
        return ti * tl, (ti + 1) * tl, ci * cl, (ci + 1) * cl

    def block(self, ntemps, nchains) -> Block:
        """This rank's block of a ``[ntemps, nchains]`` batch; raises the
        JAX package's errors where the grid does not tile it."""
        if ntemps % self.ntemp != 0:
            raise ValueError(f"ntemps={ntemps} must be a multiple of mesh axis "
                             f"{self.temp_axis!r} size {self.ntemp}")
        if nchains % self.nchain != 0:
            raise ValueError(f"nchains={nchains} must be a multiple of mesh axis "
                             f"{self.chain_axis!r} size {self.nchain}")
        t0, t1, c0, c1 = self.bounds(self.rank, ntemps, nchains)
        return Block(ntemps, nchains, t0, t1, c0, c1, mesh=self)


def make_temp_mesh(n_devices=None, axis="temp"):
    """The 1-D mesh over the temperature axis (or, with ``axis`` another
    name, over the chains), one rank a shard: ``n_devices`` defaults to the
    process group's size and must equal it."""
    from .distributed import process_count, process_index

    n = process_count()
    n_devices = n if n_devices is None else int(n_devices)
    if n_devices != n:
        raise ValueError(f"a mesh of {n_devices} shards needs {n_devices} processes, not {n} "
                         "(one process a shard)")
    if axis == "temp":
        return PTMesh(n, 1, process_index(), axis_names=("temp",))
    return PTMesh(1, n, process_index(), chain_axis=axis, axis_names=(axis,))


# ---- placement ---------------------------------------------------------------

#: Fields whose arrays are split, by the axes of their dims (the JAX
#: package's state_sharding, ptmcmcsampler_tpu/parallel/mesh.py:40-69).
_SPLIT = {
    "x": ("T", "D", "C"),
    "lnlike": ("T", "C"), "lnprior": ("T", "C"),
    "counters/naccepted": ("T", "C"), "counters/swaps_accepted": ("T", "C"),
    "counters/swaps_accepted_lad": ("T", "C"),
    "betas": ("T",),
    "counters/jump_proposed": ("J", "T", "C"), "counters/jump_accepted": ("J", "T", "C"),
}


def field_dims(path):
    """The dims of a state path that is split (``"T"`` rungs, ``"C"``
    chains), or None for one that every rank holds whole: the adaptation,
    the DE ring, the swap counters ``swaps_proposed(_lad)`` and scalars."""
    if path.startswith("stepsize/"):
        return ("T", "C")
    return _SPLIT.get(path)


def state_sharding(state, mesh, axis="temp", chain_axis=None):
    """``{path: spec}`` of every tensor of ``state``: a tuple of the mesh
    axis each dimension is split along (None: not split), ``()`` for a
    replicated one, as the JAX package's ``PartitionSpec``s."""
    from ..state import state_tensors

    name = {"T": axis, "C": chain_axis}
    out = {}
    for path in state_tensors(state):
        dims = field_dims(path)
        out[path] = () if dims is None else tuple(name.get(d) for d in dims)
    return out


def shard_state(state, block):
    """This rank's block of a whole ``state`` (every rank holds the
    identical whole state, made from the same seed): the split fields
    sliced (``field_dims``), the rest shared; the generators stay the
    state's. A ``PTMesh`` is taken for the block of the state's batch."""
    from ..state import SamplerState, map_state, state_tensors

    if isinstance(block, PTMesh):
        block = block.block(state.x.shape[0], state.x.shape[2])
    if not block.sharded:
        return state
    dims = {id(t): field_dims(p) for p, t in state_tensors(state).items()}

    def take(a):
        d = dims.get(id(a))
        return a if d is None else block.take(a, d)

    out = map_state(state, take)
    assert isinstance(out, SamplerState)
    return out


#: The JAX package's name for placing host-identical state on a mesh that
#: spans processes: here every placement is that.
shard_state_global = shard_state


def unshard_state(state, block):
    """The whole state from every rank's block (a collective: every rank
    calls it, each gets the whole state), for the checkpoint."""
    from ..state import map_state, state_tensors

    if not block.sharded:
        return state
    dims = {id(t): field_dims(p) for p, t in state_tensors(state).items()}

    def whole(a):
        d = dims.get(id(a))
        return a if d is None else gather(block, a, d)

    return map_state(state, whole)


def host_local_block(arr, block, dims):
    """``(numpy block, index)`` of this rank's ``arr``: ``index`` a global
    index array a dimension, as the JAX package's ``host_local_block``."""
    index = []
    for d, n in zip(dims, arr.shape):
        lo = block.t0 if d == "T" else block.c0 if d == "C" else 0
        index.append(np.arange(lo, lo + n, dtype=np.int64))
    return arr.detach().cpu().numpy(), index


# ---- collectives -------------------------------------------------------------

def _staged(a):
    """``(tensor to communicate, back)``: a host copy of a tensor on the card
    under ``gloo`` (which sends only host tensors), in pinned memory, and
    the function that returns a received one to ``a``'s device and dtype."""
    dev, dtype = a.device, a.dtype
    b = a.to(torch.uint8) if dtype == torch.bool else a
    if a.is_cuda and dist.get_backend() == "gloo":
        b = torch.empty(b.shape, dtype=b.dtype, pin_memory=True).copy_(b)
    return b.contiguous(), lambda r: r.to(device=dev).to(dtype)


def all_gather(a):
    """Every rank's ``a`` (one shape on all of them), by rank."""
    b, back = _staged(a)
    parts = [torch.empty_like(b) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, b)
    return [back(p) for p in parts]


def gather(block, a, dims):
    """The unsharded array of this rank's ``a`` (axes ``dims``: ``"T"``,
    ``"C"`` or any other name, the block's extent), from every rank's block:
    a collective every rank of the mesh calls, each with its own block. An
    array without a ``"T"`` (``"C"``) axis is taken from the ranks of the
    first temperature (chain) shard, so ``gather(block, x[0], (D, "C"))`` is
    the cold rung. ``a`` itself when the block is the whole batch."""
    return gather_many(block, [(a, dims)])[0]


def gather_many(block, arrays):
    """:func:`gather` of each ``(a, dims)`` of ``arrays`` (one dtype), by one
    ``all_gather`` of them packed end to end: one exchange's latency for
    all of them."""
    if not block.sharded:
        return [a for a, _ in arrays]
    mesh = block.mesh
    parts = all_gather(torch.cat([a.reshape(-1) for a, _ in arrays]))
    outs = []
    offset = 0
    for a, dims in arrays:
        shape = [block.ntemps if d == "T" else block.nchains if d == "C" else n
                 for d, n in zip(dims, a.shape)]
        out = torch.empty(shape, dtype=a.dtype, device=a.device)
        for r, part in enumerate(parts):
            ti, ci = divmod(r, mesh.nchain)
            if ("T" not in dims and ti) or ("C" not in dims and ci):
                continue
            t0, t1, c0, c1 = mesh.bounds(r, block.ntemps, block.nchains)
            index = tuple(slice(t0, t1) if d == "T" else slice(c0, c1) if d == "C"
                          else slice(None) for d in dims)
            out[index] = part[offset:offset + a.numel()].view(a.shape)
        offset += a.numel()
        outs.append(out)
    return outs


def gather_slice(block, arrays, start, n):
    """The unsharded ``[T, ..., n]`` arrays of a ``per_chain`` rotation
    slice (position ``k`` holds chain ``(start + k) % C``) from every rank's
    part of it: each ``(a, dims)`` of ``arrays`` (one dtype; ``dims`` has
    ``"T"`` first and ``"C"`` last) holds this rank's rungs and the slice
    positions of its ``Block.slice_pieces``, in their order. A collective
    every rank calls, with its part (possibly of no chains): one
    ``all_gather`` of the parts packed end to end, padded to the largest."""
    mesh = block.mesh
    parts = []  # by rank: (t0, t1, runs)
    for r in range(mesh.size):
        t0, t1, c0, c1 = mesh.bounds(r, block.ntemps, block.nchains)
        blk = Block(block.ntemps, block.nchains, t0, t1, c0, c1)
        parts.append((t0, t1, blk.slice_pieces(start, n)))

    def numel(a, r):
        t0, t1, runs = parts[r]
        return int(np.prod(a.shape[1:-1])) * (t1 - t0) * sum(k1 - k0 for k0, k1 in runs)

    sizes = [sum(numel(a, r) for a, _ in arrays) for r in range(mesh.size)]
    flat = torch.cat([a.reshape(-1) for a, _ in arrays])
    flat = torch.cat([flat, flat.new_zeros(max(sizes) - flat.numel())])
    got = all_gather(flat)
    outs = [torch.empty((block.ntemps,) + tuple(a.shape[1:-1]) + (n,), dtype=a.dtype,
                        device=a.device) for a, _ in arrays]
    for r, part in enumerate(got):
        t0, t1, runs = parts[r]
        width = sum(k1 - k0 for k0, k1 in runs)
        offset = 0
        for (a, _), out in zip(arrays, outs):
            m = numel(a, r)
            piece = part[offset:offset + m].view((t1 - t0,) + tuple(a.shape[1:-1]) + (width,))
            offset += m
            k = 0
            for k0, k1 in runs:
                out[t0:t1, ..., k0:k1] = piece[..., k:k + k1 - k0]
                k += k1 - k0
    return outs


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` holds on any rank (the reference's ``comm.bcast`` of
    the stop flag): a collective every rank calls."""
    t = torch.tensor([1 if flag else 0], dtype=torch.int64)
    if dist.get_backend() == "nccl":
        t = t.cuda()
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def barrier():
    """A barrier over the default group, where there is one."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def neighbour_exchange(block, send, to, like, frm):
    """Send ``send`` to the rank of temperature shard ``to`` and receive a
    tensor like ``like`` from the rank of temperature shard ``frm``, both in
    this rank's chain column (either may be None: no such neighbour).
    Returns the received tensor or None."""
    mesh = block.mesh
    ops, out, back = [], None, None
    if send is not None and to is not None:
        s, _ = _staged(send)
        ops.append(dist.P2POp(dist.isend, s, mesh.rank_of(to, mesh.ci)))
    if frm is not None:
        recv, back = _staged(torch.empty_like(like))
        ops.append(dist.P2POp(dist.irecv, recv, mesh.rank_of(frm, mesh.ci)))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if frm is not None:
        out = back(recv)
    return out
