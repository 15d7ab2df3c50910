"""The per-iteration sampler step and the block runner.

One step, for the whole ``[ntemps, nchains]`` batch at once:

  proposal -> prior/likelihood -> tempered MH accept -> (every tskip) sweep
  swap -> Welford, DE-ring and (every cov_update) factor updates

as in the JAX package's ``kernel.build_step``. Every cadence and the jump
kind are host integers (the kinds are drawn a block at a time), so a step
never reads a value back from the device; ``run_block`` does not either.
The one exception is ``torch.linalg.eigh`` in the factor refresh, which
synchronises on CUDA once every ``cov_update`` iterations.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from . import adaptation, swaps, utils
from .config import SamplerConfig
from .proposals.base import ProposalContext
from .proposals.cycle import build_jump_branches, draw_kinds
from .state import SS_FIELDS, SamplerState


class BlockOutput(NamedTuple):
    """Thinned rows emitted by one block. The per-chain scalars are emitted
    for chain 0 only, the column chain files consume."""

    x: torch.Tensor  # [rows, T, D, C]
    lnlike: torch.Tensor  # [rows, T]
    lnprob: torch.Tensor  # [rows, T]
    it: torch.Tensor  # [rows] iteration number of each row
    naccepted: torch.Tensor  # [rows, T]
    swaps_accepted: torch.Tensor  # [rows, T]
    swaps_proposed: torch.Tensor  # [rows, T]


def make_context(state: SamplerState) -> ProposalContext:
    return ProposalContext(
        group_u=state.adapt.group_u,
        group_s=state.adapt.group_s,
        chol=state.adapt.chol,
        chol_inv=state.adapt.chol_inv,
        structure=state.adapt.structure,
        de_buf=state.de.buf,
        de_valid=adaptation.de_valid_rows(state.de),
    )


def _accept_logratio(new_ll, new_lp, old_ll, old_lp, qxy, betas):
    """MH log-ratio with the reference's -inf semantics (PTMCMCSampler.py:605-616)."""
    new = utils.tempered_lnprob(new_ll, new_lp, betas)
    old = utils.tempered_lnprob(old_ll, old_lp, betas)
    raw = qxy + new - old
    raw = torch.where(torch.isneginf(new), float("-inf"), raw)  # never accept into -inf
    raw = torch.where(torch.isneginf(old) & ~torch.isneginf(new), float("inf"), raw)
    return torch.where(torch.isnan(raw), float("-inf"), raw)


def history_updates(config: SamplerConfig, state: SamplerState, it) -> SamplerState:
    """Welford moments and the DE ring every iteration; the factor refresh at
    the end of every ``cov_update``-th iteration, which consumes the same
    samples as the reference's refresh at the top of the next
    (PTMCMCSampler.py:545-546)."""
    if config.adapt_from == "all":
        xs = state.x.movedim(1, 0).reshape(config.ndim, -1)
    else:
        xs = state.x[0]  # cold-temperature chains [D, C]
    adapt = adaptation.welford_batch_update(state.adapt, xs)
    de = adaptation.de_buffer_push(state.de, state.x[0])
    if it % config.cov_update == 0 and it > 0:
        adapt = adaptation.refresh_factors(config, adapt)
    return dataclasses.replace(state, adapt=adapt, de=de)


def build_step(config: SamplerConfig, model, device="cuda"):
    """Build ``step(state, kind=None) -> state`` and
    ``run_block(state, nrows) -> (state, BlockOutput)``.

    ``model`` gives batched ``lnlike(x[..., D, C])``, ``lnprior`` and, for
    the gradient jumps, ``value_grad(x, beta)`` and a ``cuda_functor``.
    ``device`` is where the step runs, the card unless the caller asks for
    the CPU; the state must live there.
    """
    device = utils.resolve_device(device, "build_step")
    t, c = config.ntemps, config.nchains
    branches = build_jump_branches(config, model, device)

    def mh_step(state: SamplerState, it, kind):
        ss = {f: getattr(state.stepsize, f) for f in SS_FIELDS}
        q, qxy, new_ss = branches[kind](state.rng, state.x, state.betas, it, make_context(state), ss)

        # Prior first; the likelihood is evaluated on a prior-feasible
        # surrogate so -inf-prior proposals never feed it NaNs.
        new_lp = model.lnprior(q)
        feasible = ~torch.isneginf(new_lp)
        q_safe = torch.where(feasible[:, None, :], q, state.x)
        new_ll = torch.where(feasible, model.lnlike(q_safe), float("-inf"))

        logr = _accept_logratio(
            new_ll, new_lp, state.lnlike, state.lnprior, qxy, state.betas[:, None]
        )
        u = torch.rand((t, c), generator=state.rng, device=state.x.device)
        accept = logr > torch.log(torch.clamp(u, min=1e-37))
        acc_i = accept.to(torch.int32)

        ctr = state.counters
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

    def pt_swap(state: SamplerState, it):
        """Sweep replica exchange every ``tskip`` iterations."""
        if t <= 1 or it % config.tskip != 0:
            return state
        us = swaps.draw_swap_uniforms(state.rng, t, c, state.x.device)
        x, ll, lp, accepted, proposed = swaps.sweep_swap_apply(
            us, state.x, state.lnlike, state.lnprior, state.betas
        )
        ctr = state.counters
        return dataclasses.replace(
            state, x=x, lnlike=ll, lnprior=lp,
            counters=dataclasses.replace(
                ctr,
                swaps_proposed=ctr.swaps_proposed + proposed.to(torch.int32),
                swaps_accepted=ctr.swaps_accepted + accepted.to(torch.int32),
            ),
        )

    def step(state: SamplerState, kind=None) -> SamplerState:
        """One iteration; ``kind`` is the jump index, drawn here if not given."""
        if state.x.device != device:
            raise ValueError(f"state is on {state.x.device}, the step was built for {device}")
        it = state.it + 1
        if kind is None:
            kind = draw_kinds(config, state.it, 1, state.host_rng)[0]
        state = mh_step(dataclasses.replace(state, it=it), it, kind)
        state = pt_swap(state, it)
        return history_updates(config, state, it)

    def run_block(state: SamplerState, nrows: int):
        """Run ``nrows * thin`` iterations, returning the thinned rows."""
        dev = state.x.device
        thin = config.thin
        kinds = draw_kinds(config, state.it, nrows * thin, state.host_rng)
        x = torch.empty((nrows,) + tuple(state.x.shape), dtype=state.x.dtype, device=dev)
        lnlike = torch.empty((nrows, t), dtype=state.x.dtype, device=dev)
        lnprob = torch.empty_like(lnlike)
        nacc = torch.empty((nrows, t), dtype=torch.int32, device=dev)
        sacc = torch.empty_like(nacc)
        sprop = torch.empty_like(nacc)
        for r in range(nrows):
            for k in range(thin):
                state = step(state, kinds[r * thin + k])
            x[r] = state.x
            lnlike[r] = state.lnlike[:, 0]
            lnprob[r] = utils.tempered_lnprob(
                state.lnlike[:, 0], state.lnprior[:, 0], state.betas
            )
            nacc[r] = state.counters.naccepted[:, 0]
            sacc[r] = state.counters.swaps_accepted[:, 0]
            sprop[r] = state.counters.swaps_proposed
        its = torch.arange(1, nrows + 1, device=dev) * thin + (state.it - nrows * thin)
        return state, BlockOutput(x, lnlike, lnprob, its, nacc, sacc, sprop)

    return step, run_block
