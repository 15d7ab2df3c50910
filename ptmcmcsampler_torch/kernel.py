"""The per-iteration sampler step and the block runner.

One step, for the whole ``[ntemps, nchains]`` batch at once:

  proposal -> prior/likelihood -> tempered MH accept -> (every tskip) swap
  event and, in burn-in, the adaptive ladder -> Welford, DE-ring and
  (every cov_update) factor updates

as in the JAX package's ``kernel.build_step``. Every cadence and the jump
kind are host integers (the kinds are drawn a block at a time), so a step
never reads a value back from the device. The one exception is
``torch.linalg.eigh`` in the factor refresh, which synchronises on CUDA once
every ``cov_update`` iterations.

The JAX package's ``run_block`` is one compiled ``lax.scan``, so a block
reaches the TPU as one program. Here, on the card, ``run_block`` replays
CUDA graphs of the step: every host-side decision of an iteration
(:func:`step_key`) keys one graph, captured on the runner's static state (a
holder whose tensors keep their addresses, ``state.copy_into``). A key's
first iteration runs eagerly on a side stream (PyTorch's warm-up rule, which
also builds any kernel library outside a capture); its next use captures the
graph, and every later one replays it. The factor refresh and the thinned
rows run eagerly between replays. On the CPU, and for models whose callables
run on the host, ``run_block`` runs the same body eagerly; so do the
iterations of a user's jump that runs on the host (a numpy custom jump or
prior draw: its own iterations; a numpy auxiliary jump: every iteration),
while every other key keeps its graph. The user's custom and auxiliary jumps
and the adaptive ladder's decay read the iteration number from a 0-d tensor
on the device that the runner writes before each iteration, outside the
graphs; the ladder's betas and window counters change on the device too.

With ``jump_select="per_chain"`` (:func:`make_per_chain`) every chain takes
its own kind each iteration, drawn on the device: the rotation's offset or
the stacked mode's kinds are draws from ``state.rng``, never host values, so
one graph serves every iteration of an activation phase. With
``nuts_trajectory`` the NUTS branch records the trajectory of chain (T0, C0)
into the step's capture buffers (``trajectory.TrajCapture``) inside the
graphs, and ``run_block`` copies them into each thinned row.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from . import adaptation, swaps, utils
from .config import KIND_CHEES, KIND_CUSTOM, KIND_DE, KIND_NUTS, SamplerConfig
from .ladder import adapt_ladder_betas
from .ops import chees as ops_chees, hmc as ops_hmc, nuts as ops_nuts, user
from .parallel.mesh import gather, gather_many, gather_slice
from .proposals.base import ProposalContext
from .proposals.custom import make_aux_chain
from .proposals.cycle import (activation_phase, activation_thresholds, build_jump_branches,
                              draw_kinds, jump_probabilities, phase_partitions)
from .state import SS_FIELDS, SamplerState, copy_into, map_state
from .trajectory import TrajCapture, empty_capture


class BlockOutput(NamedTuple):
    """Thinned rows emitted by one block. The per-chain scalars are emitted
    for chain 0 only, the column chain files consume. A sharded run's block
    holds its rank's rungs and chains (``[rows, Tl, D, Cl]``, the scalars of
    its first chain); ``run_block.block`` (``utils.Block``) says where they
    lie in the unsharded batch (the JAX package's ``host_local_block``
    indices)."""

    x: torch.Tensor  # [rows, T, D, C]
    lnlike: torch.Tensor  # [rows, T]
    lnprob: torch.Tensor  # [rows, T]
    it: torch.Tensor  # [rows] iteration number of each row
    naccepted: torch.Tensor  # [rows, T]
    swaps_accepted: torch.Tensor  # [rows, T]
    swaps_proposed: torch.Tensor  # [rows, T]
    # With config.nuts_trajectory: the capture at each row (TrajCapture of
    # [rows, ...] tensors), as the JAX package's BlockOutput.traj.
    traj: TrajCapture = None


def make_context(state: SamplerState, iteration=None, block=None) -> ProposalContext:
    return ProposalContext(
        group_u=state.adapt.group_u,
        group_s=state.adapt.group_s,
        chol=state.adapt.chol,
        chol_inv=state.adapt.chol_inv,
        structure=state.adapt.structure,
        de_buf=state.de.buf,
        de_valid=adaptation.de_valid_rows(state.de),
        iteration=iteration,
        block=block,
    )


def ladder_window_rates(ctr):
    """Per-pair swap acceptance rates over the window since the ladder's
    last update (the deltas against the ``*_lad`` snapshots), as the JAX
    package's ``kernel.ladder_window_rates``: Vousden, Farr & Mandel (2016)
    adapt on the acceptance since the previous geometry update. Returns
    ``(rates [T] f32, pair_valid [T] bool)``; a pair with no proposal in
    the window is not valid, so no fabricated 0 rate drives an update."""
    d_prop = ctr.swaps_proposed - ctr.swaps_proposed_lad
    d_acc = ctr.swaps_accepted - ctr.swaps_accepted_lad
    # The mean over chains as XLA compiles the JAX package's: the sum (exact
    # in f32) times the f32 reciprocal of the count.
    n = torch.full((), d_acc.shape[1], dtype=torch.float32, device=d_acc.device)
    rates = d_acc.to(torch.float32).sum(1) * torch.reciprocal(n)
    return rates / torch.clamp(d_prop, min=1).to(torch.float32), d_prop > 0


def _accept_logratio(new_ll, new_lp, old_ll, old_lp, qxy, betas):
    """MH log-ratio with the reference's -inf semantics (PTMCMCSampler.py:605-616)."""
    new = utils.tempered_lnprob(new_ll, new_lp, betas)
    old = utils.tempered_lnprob(old_ll, old_lp, betas)
    raw = qxy + new - old
    raw = torch.where(torch.isneginf(new), float("-inf"), raw)  # never accept into -inf
    raw = torch.where(torch.isneginf(old) & ~torch.isneginf(new), float("inf"), raw)
    return torch.where(torch.isnan(raw), float("-inf"), raw)


def history_push(config: SamplerConfig, state: SamplerState, block=None) -> SamplerState:
    """Welford moments and the DE ring, every iteration. On a sharded
    ``block`` (``utils.Block``) every rank gathers the rows they read (the
    cold rung, or with ``adapt_from="all"`` every rung) and updates its
    replicated copy as the unsharded run does."""
    d = config.ndim
    block = block or utils.Block(config.ntemps, config.nchains)
    if config.adapt_from == "all":
        x = gather(block, state.x, ("T", d, "C"))
        cold, xs = x[0], x.movedim(1, 0).reshape(d, -1)
    else:
        cold = xs = gather(block, state.x[0], (d, "C"))  # cold-temperature chains [D, C]
    adapt = adaptation.welford_batch_update(state.adapt, xs)
    de = adaptation.de_buffer_push(state.de, cold)
    return dataclasses.replace(state, adapt=adapt, de=de)


def refresh_due(config: SamplerConfig, it) -> bool:
    return it % config.cov_update == 0 and it > 0


def refresh(config: SamplerConfig, state: SamplerState, it) -> SamplerState:
    """The factor refresh at the end of every ``cov_update``-th iteration,
    which consumes the same samples as the reference's refresh at the top
    of the next (PTMCMCSampler.py:545-546)."""
    if not refresh_due(config, it):
        return state
    return dataclasses.replace(state, adapt=adaptation.refresh_factors(config, state.adapt))


def history_updates(config: SamplerConfig, state: SamplerState, it) -> SamplerState:
    """:func:`history_push`, then :func:`refresh`."""
    return refresh(config, history_push(config, state), it)


def swap_event(config: SamplerConfig, it):
    """The swap event iteration ``it`` runs, decided on the host: None (no
    swap), ``"sweep"``, or ``("deo", parity)`` with the parity ``(it //
    tskip) % 2``; with the adaptive ladder, and ``it <= burn``, the event
    also updates the ladder (``+ ("ladder",)``)."""
    if config.ntemps <= 1 or it % config.tskip != 0:
        return None
    event = ("deo", (it // config.tskip) % 2) if config.swap_mode == "deo" else ("sweep",)
    return event + ("ladder",) if config.adapt_ladder and it <= config.burn else event


def step_key(config: SamplerConfig, state: SamplerState, it, kind) -> tuple:
    """Every host-side decision iteration ``it`` of jump ``kind`` makes from
    ``state`` (its host fields before the iteration): the jump (with
    ``per_chain`` selection, ``("per_chain", mode, phase)``: the kinds are
    device draws, and only the activation phase is decided on the host),
    the swap event (:func:`swap_event`: none, the sweep, or DEO's parity,
    each with the ladder update where it runs), whether adaptation runs
    (ChEES and NUTS read ``it <= burn``), the DE ring's valid rows (DE's
    draw range) and the factors' structure tag (a launch argument of the
    wide kernels). Two iterations with one key run the same device work, so
    one CUDA graph serves both. The factor refresh is not part of it: it
    runs outside every graph."""
    if config.jump_select == "per_chain":
        mode = "rotation" if config.per_chain_rotation else "stacked"
        phase = activation_phase(config, it)
        active = np.flatnonzero(jump_probabilities(config, it) > 0)
        jumps = {config.jumps[j].kind for j in active}
        kind = ("per_chain", mode, phase)
    else:
        jumps = {config.jumps[kind].kind}
    return (
        kind,
        swap_event(config, it),
        it <= config.burn if jumps & {KIND_CHEES, KIND_NUTS} else None,
        adaptation.de_valid_rows(state.de) if KIND_DE in jumps else None,
        state.adapt.structure,
    )


def rotation_offset(rng, c, device):
    """The rotation's offset, uniform on ``[0, c)``: a 0-d draw on the
    device, never read to the host, so one graph serves every iteration."""
    return torch.randint(0, c, (), generator=rng, device=device)


def make_per_chain(config: SamplerConfig, branches, device, block=None):
    """``propose(rng, x, betas, it, ctx, ss) -> (q, qxy, kinds [T, C] long,
    ss)`` for ``jump_select="per_chain"``, each chain with its own kind.

    Rotation (the JAX package's kernel.py:163-264): the phase's static
    layout gives jump j a contiguous run of ``rotation_partition`` slots;
    one offset ``r`` an iteration, uniform on ``[0, C)`` and shared by all
    temperatures, puts chain c in slot ``(c + r) % C``. Each branch runs once
    on its slice (gathered with ``index_select``: ``torch.roll`` would take
    ``r`` to the host), and the results are gathered back to chain order.
    The ChEES jump's per-temperature ``chees_*`` fields take its slice's
    update row-wide. Stacked (:296-321): each chain draws its kind from the
    active probabilities by inverse CDF (``searchsorted`` on one uniform a
    chain), every active branch runs on the whole batch and each chain takes
    its kind's results; ``chees_*`` take the ChEES update in every row where
    a chain ran ChEES.

    On a sharded ``block`` (``utils.Block``, a rank's rungs and chains; the
    step then runs eagerly) every draw is the unsharded run's. Stacked: the
    kinds' uniforms are the rank's block of the unsharded draw, and the
    ChEES rows' "any chain ran ChEES" is taken over the gathered kinds.
    Rotation (:func:`_sharded_rotation`): the offset is read on the host,
    and each branch runs on the rank's part of its slice, one or two runs of
    slice positions (``Block.slice_pieces``), each a ``Block.piece`` of the
    slice; a slice's draws are repeated for a second run from the
    generator's state before the first (so both keep the slice's unsharded
    draws, and the generator ends where one call leaves it), and a rank
    holding none of a slice runs its branch on no chains, for the draws.
    ChEES's per-rung update gathers the slice's trajectories from every
    rank (``parallel.mesh.gather_slice``).
    """
    t, c = config.ntemps, config.nchains
    block = block or utils.Block(t, c)
    nphase = len(activation_thresholds(config)) + 1
    chees = [j for j, spec in enumerate(config.jumps) if spec.kind == KIND_CHEES]
    chees_fields = [f for f in SS_FIELDS if f.startswith("chees_")]
    chains = torch.arange(c, device=device)

    def rows_of(v):  # the ChEES update of a rung, from its first chain: [T, n] -> [T, C]
        return v[:, :1].expand(t, c).contiguous()

    if config.per_chain_rotation:
        layouts = []
        for counts in phase_partitions(config):
            offs = np.concatenate([[0], np.cumsum(counts)]).tolist()
            slot_kind = torch.as_tensor(np.repeat(np.arange(len(counts)), counts), device=device)
            layouts.append(([int(n) for n in counts], offs, slot_kind))

        def rotation(rng, x, betas, it, ctx, ss):
            counts, offs, slot_kind = layouts[activation_phase(config, it)]
            r = rotation_offset(rng, c, x.device)
            chain_at = (chains - r) % c  # the chain in each slot
            slot_of = (chains + r) % c  # each chain's slot
            qs, qxys, outs, changed, ches = [], [], [], set(), None
            for j, n in enumerate(counts):
                if n == 0:
                    continue
                idx = chain_at[offs[j]:offs[j] + n]
                ss_j = {f: v.index_select(1, idx) for f, v in ss.items()}
                q_j, qxy_j, new_j = branches[j](rng, x.index_select(2, idx), betas, it, ctx, ss_j)
                qs.append(q_j)
                qxys.append(qxy_j)
                outs.append(new_j)
                changed |= {f for f in ss if new_j[f] is not ss_j[f]}
                if j in chees:
                    ches = new_j
            new_ss = dict(ss)
            for f in (f for f in ss if f in changed):  # in a fixed order
                new_ss[f] = torch.cat([o[f] for o in outs], 1).index_select(1, slot_of)
            if ches is not None:
                new_ss.update({f: rows_of(ches[f]) for f in chees_fields})
            q = torch.cat(qs, 2).index_select(2, slot_of)
            qxy = torch.cat(qxys, 1).index_select(1, slot_of)
            return q, qxy, slot_kind.index_select(0, slot_of).expand(t, c), new_ss

        if block.sharded:
            return _sharded_rotation(config, branches, block, layouts, chees, chees_fields)
        return rotation

    thresholds = activation_thresholds(config)
    phases = []  # (active jumps, the CDF whose searchsorted draws a kind) by phase
    for p in range(nphase):
        probs = jump_probabilities(config, thresholds[p - 1] + 1 if p else 0).astype(np.float64)
        active = np.flatnonzero(probs > 0).tolist()
        cdf = np.cumsum(probs)
        cdf[active[-1]:] = 2.0  # past every uniform: rounding never picks an inactive jump
        phases.append((active, torch.as_tensor(cdf, dtype=torch.float32, device=device)))

    def stacked(rng, x, betas, it, ctx, ss):
        active, cdf = phases[activation_phase(config, it)]
        u = block.draw(torch.rand, rng, ("T", "C"), x.device)
        kinds = torch.searchsorted(cdf, u.reshape(-1), right=True).view(u.shape)
        q = qxy = None
        new_ss = dict(ss)
        for j in active:
            q_j, qxy_j, new_j = branches[j](rng, x, betas, it, ctx, ss)
            sel = kinds == j
            q = q_j if q is None else torch.where(sel[:, None, :], q_j, q)
            qxy = qxy_j if qxy is None else torch.where(sel, qxy_j, qxy)
            if j in chees and block.sharded:  # a ChEES chain in the row on any rank
                rows = block.take(gather(block, sel, ("T", "C")).any(1, keepdim=True),
                                  ("T", 1))
            else:
                rows = sel.any(1, keepdim=True)
            for f in ss:
                if new_j[f] is not ss[f]:
                    new_ss[f] = torch.where(rows if f in chees_fields else sel, new_j[f],
                                            new_ss[f])
        return q, qxy, kinds, new_ss

    return stacked


def _sharded_rotation(config, branches, block, layouts, chees, chees_fields):
    """The rotation of :func:`make_per_chain` on a rank's ``block`` of a
    sharded run."""
    c = config.nchains
    tl, cl = block.t1 - block.t0, block.c1 - block.c0
    chains = torch.arange(block.c0, block.c1)

    def rotation(rng, x, betas, it, ctx, ss):
        counts, offs, slot_kind = layouts[activation_phase(config, it)]
        # A sharded step runs eagerly, so the offset may be read on the host.
        r = int(rotation_offset(rng, c, x.device))
        q, qxy = torch.empty_like(x), x.new_empty((tl, cl))
        new_ss, ches = dict(ss), None
        for j, n in enumerate(counts):
            if n == 0:
                continue
            start = (offs[j] - r) % c  # the chain in the slice's first slot
            runs = block.slice_pieces(start, n) or [(0, 0)]
            before = rng.get_state() if len(runs) > 1 else None
            stats, changed = [], {}
            for i, (k0, k1) in enumerate(runs):
                if i:
                    rng.set_state(before)
                local = ((start + torch.arange(k0, k1)) % c - block.c0).to(x.device)
                ctx_p = dataclasses.replace(ctx, block=block.piece(n, k0, k1))
                ss_p = {f: v.index_select(1, local) for f, v in ss.items()}
                x_p = x.index_select(2, local)
                if j in chees:
                    q_p, qxy_p, st = branches[j].local(rng, x_p, betas, ctx_p, ss_p)
                    stats.append((ss_p, st))
                    new_p = ss_p
                else:
                    q_p, qxy_p, new_p = branches[j](rng, x_p, betas, it, ctx_p, ss_p)
                q.index_copy_(2, local, q_p)
                qxy.index_copy_(1, local, qxy_p)
                for f in ss:
                    if new_p[f] is not ss_p[f]:
                        changed.setdefault(f, []).append((local, new_p[f]))
            for f, parts in changed.items():
                new_ss[f] = new_ss[f].clone()
                for local, v in parts:
                    new_ss[f].index_copy_(1, local, v)
            if j in chees:
                ches = _chees_slice_update(branches[j], block, it, stats, start, n, chees_fields)
        if ches is not None:
            new_ss.update({f: block.take(ches[f][:, :1], ("T", 1)).expand(tl, cl).contiguous()
                           for f in chees_fields})
        kinds = slot_kind.index_select(0, (chains.to(x.device) + r) % c).expand(tl, cl)
        return q, qxy, kinds, new_ss

    return rotation


def _chees_slice_update(branch, block, it, stats, start, n, fields):
    """ChEES's per-rung update of a rotation slice on a sharded ``block``:
    the slice's step-size fields and trajectories gathered from every rank's
    runs of it (``stats``, a run's ``(ss, (q0, z1, r1, alpha, u))`` each; a
    rank with none of the slice gives a run of no chains), the unsharded
    update on them. Returns the update's ``{field: [T, n]}``."""
    cat = [torch.cat(a, -1) for a in zip(*(st for _, st in stats))]
    taken = [torch.cat([ss[f] for ss, _ in stats], 1) for f in fields]
    tc = ("T", "C")
    xd = ("T", cat[0].shape[1], "C")
    got = gather_slice(block, [(a, tc) for a in taken] + [(a, xd) for a in cat[:3]]
                       + [(a, tc) for a in cat[3:]], start, n)
    whole = dict(zip(fields, got))
    new = branch.adapt(it, whole, *got[len(fields):])
    return {f: new[f] for f in fields}


def _wrapper_calls():
    """The calls each kernel wrapper has counted (its ``launches``), by name."""
    wrappers = (ops_chees.chees_step, ops_chees.chees_trajectories, ops_hmc.hmc_step,
                ops_hmc.hmc_trajectories, ops_nuts.nuts_trees)
    calls = {w.__name__: w.launches for w in wrappers}
    calls[GENERAL_NUTS] = ops_nuts.nuts_trees.general_launches
    return calls


#: The name BlockStats counts the NUTS kernel's general entry under.
GENERAL_NUTS = "nuts_trees (general)"


def _graphs_on(device) -> bool:
    """Whether ``run_block`` captures graphs on ``device``: on the card."""
    return device.type == "cuda"


class _CudaGraphs:
    """A runner's warm-ups and captures on the card.

    Both run on one side stream of the runner's, so the state a step makes
    lazily for each stream it runs on (a cuBLAS workspace, 32 MiB on an
    H100, which PyTorch keeps for the process) is made once a runner and not
    once a warm-up. The graphs share one memory pool: no tensor made under
    capture outlives it (the body's results are copied into the holder),
    and the graphs replay one at a time on one stream, so the pool holds one
    iteration's intermediates.
    """

    def __init__(self, device):
        self.side = torch.cuda.Stream(device)
        self.pool = None

    def warm_up(self, fn):
        """Run ``fn()`` eagerly on the side stream, ordered after and before
        the current stream's work: a key's first iteration."""
        current = torch.cuda.current_stream(self.side.device)
        self.side.wait_stream(current)
        with torch.cuda.stream(self.side):
            fn()
        current.wait_stream(self.side)

    def capture(self, fn, static):
        """A CUDA graph of ``fn()``, a step on the holder ``static``, with the
        generator ``static.rng`` registered: each replay draws at its current
        Philox offset and advances it as an eager run of ``fn`` does."""
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(static.rng)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.side):
            fn()
        return graph


class BlockStats:
    """What ``run_block`` did since it was built or last ``reset()``.

    A wrapper counts one call when it launches its kernel; under capture
    that call only records the launch, which each replay then makes. So a
    kernel's device launches are its wrapper's calls, less the calls made
    under capture, plus for each graph the calls it recorded times its
    replays (:meth:`kernel_launches`).
    """

    def __init__(self, capture=True):
        self.capture = capture  # whether the runner captures graphs at all
        self.recorded = {}  # graph key -> {wrapper: calls recorded at capture}
        self.reset()

    def reset(self):
        self.captured = 0  # graphs captured
        self.capture_sec = 0.0
        self.captured_calls = {}  # wrapper -> calls made under capture
        self.replays = {}  # graph key -> replays
        # Eager iterations by reason: a key's first use, no graphs (the CPU,
        # a model on the host), a user's jump on the host.
        self.eager = {"warm-up": 0, "no capture": 0, "host jump": 0}
        self.refreshes = 0  # factor refreshes, run eagerly after their iteration

    @property
    def iterations(self):
        return sum(self.replays.values()) + sum(self.eager.values())

    def kernel_launches(self, name, calls):
        """Device launches of wrapper ``name``'s kernel, from its ``calls``
        counted over the same span."""
        replayed = sum(rec.get(name, 0) * self.replays.get(key, 0)
                       for key, rec in self.recorded.items())
        return calls - self.captured_calls.get(name, 0) + replayed

    def summary(self):
        n = self.iterations
        return {
            "capture": self.capture,
            "graphs": len(self.recorded),
            "captured": self.captured,
            "capture_sec": self.capture_sec,
            "iterations": n,
            "replays": sum(self.replays.values()),
            "replayed_share": sum(self.replays.values()) / n if n else None,
            "eager": dict(self.eager),
            "refreshes": self.refreshes,
        }


def refuse_on_mesh(config: SamplerConfig):
    """Why a sharded run cannot run ``config``, or None: the NUTS trajectory
    capture, which the JAX package's ``PTSampler`` refuses in a
    multi-process run too."""
    if config.nuts_trajectory:
        return "the NUTS trajectory capture (trajectoryDir)"
    return None


def build_step(config: SamplerConfig, model, device="cuda", capture=True, mesh=None):
    """Build ``step(state, kind=None) -> state`` and ``run_block(state,
    nrows, kinds=None, on_dispatched=None) -> (state, BlockOutput)``;
    ``step.traj`` is the NUTS trajectory capture with ``nuts_trajectory``.

    ``mesh``: a ``parallel.PTMesh`` whose rank runs its block of the batch
    (``parallel.shard_state`` places a state on it). The collectives run
    between the step's device work (the cold rows and the cross-chain
    statistics gathered, DEO's neighbour rows sent), so a sharded step runs
    eagerly, never under a CUDA graph (ROADMAP A12c). A mesh of one rank is
    the unsharded run.

    ``model`` gives batched ``lnlike(x[..., D, C])``, ``lnprior`` and, for
    the gradient jumps, ``value_grad(x, beta)`` and a ``cuda_functor`` (a
    registered user functor's libraries are built here on the card).
    ``device`` is where the step runs, the card unless the caller asks for
    the CPU; the state must live there. ``capture=False`` runs ``run_block``
    eagerly on the card too: for models whose callables run on the host,
    which a graph cannot hold.
    """
    device = utils.resolve_device(device, "build_step")
    if device.type == "cuda":  # a user functor's libraries, before any capture
        user.prepare(model, device)
    t, c = config.ntemps, config.nchains
    block = utils.Block(t, c) if mesh is None else mesh.block(t, c)
    if block.sharded:
        why = refuse_on_mesh(config)
        if why is not None:
            raise NotImplementedError(f"{why} is not supported on a sharded mesh; capture "
                                      "trajectories in a single-process run")
    temp_sharded = block.sharded and block.mesh.ntemp > 1
    deo_sharded = swaps.make_sharded_deo(block) if temp_sharded else None
    # The NUTS trajectory capture of chain (T0, C0): fixed buffers the NUTS
    # branch overwrites inside the graphs; any other jump marks it inactive.
    traj_cap = None
    if config.nuts_trajectory and any(j.kind == KIND_NUTS for j in config.jumps):
        traj_cap = empty_capture(config, device)
    branches = build_jump_branches(config, model, device, traj_cap)
    per_chain = None
    if config.jump_select == "per_chain":
        per_chain = make_per_chain(config, branches, device, block)
        jump_index = torch.arange(config.njumps, device=device)[:, None, None]
    aux_chain = make_aux_chain(config)
    # The iteration number on the device (ctx.iteration) where a user's
    # custom or auxiliary jump or the ladder's decay reads it: written before
    # every iteration, outside the graphs, so that a replay reads the true one.
    iteration = None
    if (config.aux_jumps or config.adapt_ladder
            or any(j.kind == KIND_CUSTOM for j in config.jumps)):
        iteration = torch.zeros((), dtype=torch.int64, device=device)
    # The rungs the ladder adapts: all but a beta = 0 hot chain at the top.
    ladder_rungs = t - (1 if config.ladder_adapt_skip_top else 0)
    # The jumps that run on the host (their iterations run eagerly; all of
    # them for an auxiliary jump on the host).
    host_kinds = {i for i, j in enumerate(config.jumps) if j.protocol == "host"}
    host_aux = any(j.protocol == "host" for j in config.aux_jumps)

    def set_iteration(it):
        if iteration is not None:
            iteration.fill_(it)

    def mh_step(state: SamplerState, it, kind):
        """The proposal and its MH accept; ``kind`` is the jump index, or
        None under ``per_chain`` selection (each chain's kind is drawn)."""
        ss = {f: getattr(state.stepsize, f) for f in SS_FIELDS}
        ctx = make_context(state, iteration, block if block.sharded else None)
        if per_chain is not None:
            q, qxy, kinds, new_ss = per_chain(state.rng, state.x, state.betas, it, ctx, ss)
        else:
            q, qxy, new_ss = branches[kind](state.rng, state.x, state.betas, it, ctx, ss)
            if traj_cap is not None and config.jumps[kind].kind != KIND_NUTS:
                traj_cap.meta[3].zero_()  # no trajectory this iteration
        if aux_chain is not None:
            q, qxy = aux_chain(state.rng, state.x, q, qxy, state.betas, it, ctx)

        # Prior first; the likelihood is evaluated on a prior-feasible
        # surrogate so -inf-prior proposals never feed it NaNs.
        new_lp = model.lnprior(q)
        feasible = ~torch.isneginf(new_lp)
        q_safe = torch.where(feasible[:, None, :], q, state.x)
        new_ll = torch.where(feasible, model.lnlike(q_safe), float("-inf"))

        logr = _accept_logratio(
            new_ll, new_lp, state.lnlike, state.lnprior, qxy, state.betas[:, None]
        )
        u = block.draw(torch.rand, state.rng, ("T", "C"), state.x.device)
        accept = logr > torch.log(torch.clamp(u, min=1e-37))
        acc_i = accept.to(torch.int32)

        ctr = state.counters
        if per_chain is not None:  # each chain counts its own kind
            chosen = (kinds[None] == jump_index).to(torch.int32)  # [J, T, C]
            jump_proposed = ctr.jump_proposed + chosen
            jump_accepted = ctr.jump_accepted + chosen * acc_i
        else:
            jump_proposed = ctr.jump_proposed.clone()
            jump_proposed[kind] += 1
            jump_accepted = ctr.jump_accepted.clone()
            jump_accepted[kind] += acc_i
        return dataclasses.replace(
            state,
            x=torch.where(accept[:, None, :], q, state.x),
            lnlike=torch.where(accept, new_ll, state.lnlike),
            lnprior=torch.where(accept, new_lp, state.lnprior),
            stepsize=dataclasses.replace(state.stepsize, **new_ss),
            counters=dataclasses.replace(
                ctr,
                naccepted=ctr.naccepted + acc_i,
                jump_proposed=jump_proposed,
                jump_accepted=jump_accepted,
            ),
        )

    def adapt_ladder(betas, ctr):
        """The ladder's update from the window since its last one, applied
        where every pair it compares had proposals in the window (under DEO
        adjacent pairs have opposite parities, so a one-event window never
        has them all); the window's snapshots advance only where it
        applied. Every decision here stays on the device. A sharded run
        gathers the window's counters and the betas and takes its rungs of
        the unsharded update."""
        whole, win = betas, ctr
        if block.sharded:
            tc = ("T", "C")
            whole = gather(block, betas, ("T",))
            acc, lad = gather_many(block, [(ctr.swaps_accepted, tc),
                                           (ctr.swaps_accepted_lad, tc)])
            win = dataclasses.replace(ctr, swaps_accepted=acc, swaps_accepted_lad=lad)
        rates, pair_valid = ladder_window_rates(win)
        new_betas = adapt_ladder_betas(
            whole, rates, iteration, lag=config.ladder_adapt_lag,
            time=config.ladder_adapt_time, skip_top=config.ladder_adapt_skip_top,
            pair_valid=pair_valid)
        applied = torch.all(pair_valid[: ladder_rungs - 1])
        new_betas = block.take(torch.where(applied, new_betas, whole), ("T",))
        return new_betas, dataclasses.replace(
            ctr,
            swaps_proposed_lad=torch.where(applied, ctr.swaps_proposed, ctr.swaps_proposed_lad),
            swaps_accepted_lad=torch.where(applied, ctr.swaps_accepted, ctr.swaps_accepted_lad),
        )

    def pt_swap(state: SamplerState, it):
        """The swap event of iteration ``it`` (:func:`swap_event`)."""
        event = swap_event(config, it)
        if event is None:
            return state
        rows = (state.x, state.lnlike, state.lnprior, state.betas)
        if event[0] == "deo":
            us = swaps.block_uniforms(
                swaps.draw_pair_uniforms(state.rng, t, c, state.x.device), block)
            apply = deo_sharded if temp_sharded else swaps.deo_swap_apply
            x, ll, lp, accepted, proposed = apply(us, *rows, event[1])
        else:
            us = swaps.draw_swap_uniforms(state.rng, t, c, state.x.device)
            if temp_sharded:
                x, ll, lp, accepted, proposed = swaps.sweep_swap_gathered(block, us, *rows)
            else:  # every rung here: each chain's sweep is its own
                x, ll, lp, accepted, proposed = swaps.sweep_swap_apply(
                    block.take(us, ("T", "C")), *rows)
        ctr = state.counters
        ctr = dataclasses.replace(
            ctr,
            swaps_proposed=ctr.swaps_proposed + proposed.to(torch.int32),
            swaps_accepted=ctr.swaps_accepted + accepted.to(torch.int32),
        )
        betas = state.betas
        if event[-1] == "ladder" and ladder_rungs >= 3:
            betas, ctr = adapt_ladder(betas, ctr)
        return dataclasses.replace(state, x=x, lnlike=ll, lnprior=lp, betas=betas,
                                   counters=ctr)

    def advance(state: SamplerState, it, kind) -> SamplerState:
        """Iteration ``it`` of jump ``kind`` but for the factor refresh: the
        device work a graph holds."""
        state = mh_step(dataclasses.replace(state, it=it), it, kind)
        return history_push(config, pt_swap(state, it), block)

    def check_device(state):
        if state.x.device != device:
            raise ValueError(f"state is on {state.x.device}, the step was built for {device}")

    def step(state: SamplerState, kind=None) -> SamplerState:
        """One eager iteration; ``kind`` is the jump index, drawn here if not
        given (and None under ``per_chain`` selection). The graphs of
        ``run_block`` are held against it."""
        check_device(state)
        it = state.it + 1
        if kind is None and per_chain is None:
            kind = draw_kinds(config, state.it, 1, state.host_rng)[0]
        set_iteration(it)
        return refresh(config, advance(state, it, kind), it)

    on_card = capture and _graphs_on(device) and not block.sharded
    stats = BlockStats(on_card)
    graphs = {}  # step key -> its CUDA graph
    warmed = set()  # keys whose first iteration ran eagerly
    held = {}  # "static": the holder; "card": the _CudaGraphs, made at first use

    def body(static, it, kind):
        copy_into(static, advance(static, it, kind))

    def capture_graph(static, it, kind, key):
        before = _wrapper_calls()
        t0 = time.perf_counter()
        try:
            graph = held["card"].capture(lambda: body(static, it, kind), static)
        except RuntimeError as e:
            aux = "".join(f", auxiliary jump {j.name}" for j in config.aux_jumps)
            jump = "per_chain" if kind is None else config.jumps[kind].name
            raise RuntimeError(
                f"run_block: capturing the {jump} step{aux} of model "
                f"{type(model).__name__} (iteration {it}, key {key}) failed: {e}. A step on "
                "the card must not read the device from the host (a user's jump that has "
                "to is written as a numpy callable, which runs eagerly)") from e
        stats.capture_sec += time.perf_counter() - t0
        stats.captured += 1
        calls = {n: k - before[n] for n, k in _wrapper_calls().items() if k != before[n]}
        stats.recorded[key] = calls
        for n, k in calls.items():
            stats.captured_calls[n] = stats.captured_calls.get(n, 0) + k
        return graph

    def iterate(static, it, kind):
        """Iteration ``it``: replay its key's graph, or run it eagerly."""
        key = step_key(config, static, it, kind)
        filled = adaptation.de_filled_after(static.de, c)
        set_iteration(it)  # read by the graphs at their replay
        if on_card and (host_aux or kind in host_kinds):
            body(static, it, kind)
            stats.eager["host jump"] += 1
        elif key in graphs or (on_card and key in warmed):
            if key not in graphs:
                graphs[key] = capture_graph(static, it, kind, key)
            graphs[key].replay()
            stats.replays[key] = stats.replays.get(key, 0) + 1
        elif on_card:
            if "card" not in held:
                held["card"] = _CudaGraphs(device)
            held["card"].warm_up(lambda: body(static, it, kind))
            warmed.add(key)
            stats.eager["warm-up"] += 1
        else:
            body(static, it, kind)
            stats.eager["no capture"] += 1
        static.it, static.de.filled = it, filled  # the host fields a replay leaves

    def run_block(state: SamplerState, nrows: int, kinds=None, on_dispatched=None):
        """Run ``nrows * thin`` iterations, returning the thinned rows.

        The returned state is the runner's static state, which the next call
        advances in place; a state it is given that is not that one is
        written into it first (``copy_into``), which covers a loaded
        checkpoint and a resume. ``kinds``: the iterations' jump indices,
        drawn from ``state.host_rng`` when not given (all None under
        ``per_chain`` selection, which draws none on the host).
        ``on_dispatched()``,
        if given, is called once, before the block's first synchronising
        step (a factor refresh) or at its end: with graphs the block's
        iterations up to there are then enqueued, and the device runs them
        while the caller works.
        """
        check_device(state)
        static = held.get("static")
        if static is None:  # the holder: the first state's values at addresses of its own
            static = held["static"] = map_state(
                state, lambda a: a.clone(memory_format=torch.contiguous_format))
        copy_into(static, state)
        dev = static.x.device
        thin = config.thin
        if kinds is None:
            kinds = ([None] * (nrows * thin) if per_chain is not None
                     else draw_kinds(config, static.it, nrows * thin, static.host_rng))
        elif len(kinds) != nrows * thin:
            raise ValueError(f"run_block: {len(kinds)} kinds for {nrows * thin} iterations")
        tl = static.x.shape[0]  # the block's rungs (t unsharded)
        x = torch.empty((nrows,) + tuple(static.x.shape), dtype=static.x.dtype, device=dev)
        lnlike = torch.empty((nrows, tl), dtype=static.x.dtype, device=dev)
        lnprob = torch.empty_like(lnlike)
        nacc = torch.empty((nrows, tl), dtype=torch.int32, device=dev)
        sacc = torch.empty_like(nacc)
        sprop = torch.empty((nrows, t), dtype=torch.int32, device=dev)  # every pair's
        traj = None if traj_cap is None else empty_capture(config, dev, rows=(nrows,))
        for r in range(nrows):
            for k in range(thin):
                it = static.it + 1
                iterate(static, it, kinds[r * thin + k])
                if refresh_due(config, it):
                    if on_dispatched is not None:
                        on_dispatched()
                        on_dispatched = None
                    copy_into(static, refresh(config, static, it))
                    stats.refreshes += 1
            x[r] = static.x
            lnlike[r] = static.lnlike[:, 0]
            lnprob[r] = utils.tempered_lnprob(
                static.lnlike[:, 0], static.lnprior[:, 0], static.betas
            )
            nacc[r] = static.counters.naccepted[:, 0]
            sacc[r] = static.counters.swaps_accepted[:, 0]
            sprop[r] = static.counters.swaps_proposed
            if traj is not None:
                for row, buf in zip(traj.tensors(), traj_cap.tensors()):
                    row[r] = buf
        if on_dispatched is not None:
            on_dispatched()
        its = torch.arange(1, nrows + 1, device=dev) * thin + (static.it - nrows * thin)
        return static, BlockOutput(x, lnlike, lnprob, its, nacc, sacc, sprop, traj)

    run_block.stats = stats
    run_block.block = step.block = block
    # The trajectory capture's buffers (None without nuts_trajectory): the
    # last NUTS iteration's trajectory, marked inactive after any other jump.
    step.traj = run_block.traj = traj_cap
    return step, run_block
