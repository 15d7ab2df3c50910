"""Shared proposal helpers, batched over the whole ``[T, D, C]`` block.

A proposal branch has the signature

    branch(rng, x[T, D, C], betas[T], it, ctx, ss) -> (q[T, D, C], qxy[T, C], ss)

where ``rng`` is the state's device generator, ``it`` the host iteration
number (``ctx.iteration`` holds it on the device where a user's jump reads
it) and ``ss`` the dict of step-size tensors. Each branch draws its
randomness with ``rng`` and hands it to a deterministic core, so tests can
feed the JAX package's own draws to the core.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class ProposalContext:
    """Adaptation inputs a proposal may read (shared by all chains)."""

    group_u: tuple  # per-group eigenvectors
    group_s: tuple  # per-group eigenvalues
    chol: torch.Tensor  # [D, D] lower Cholesky factor of the mass-matrix inverse
    chol_inv: torch.Tensor  # [D, D]
    de_buf: torch.Tensor  # [D, B]
    de_valid: int  # valid DE columns (host-known)
    # The factors' structure tag (state.AdaptState.structure); "dense", which
    # every factor satisfies, where a caller builds a context by hand.
    structure: str = "dense"
    # The iteration number, a 0-d int64 tensor on the device, for the user's
    # custom and auxiliary jumps (written before every iteration, so a CUDA
    # graph replays with the true one); None where no such jump reads it.
    iteration: torch.Tensor = None
    # Where the batch lies in a sharded run's (utils.Block): every draw is of
    # the unsharded shape and the branch keeps this block of it. None: the
    # branch's batch is the whole one.
    block: object = None


def safe_temperature(beta):
    """T = 1/beta with the beta -> 0 hot chain clamped to a finite huge value."""
    return torch.where(beta > 0, 1.0 / torch.clamp(beta, min=1e-30), 1e30)


def draw_am_scale(prob, beta):
    """The reference's occasional jump-size modulation from a uniform ``prob``.

    PTMCMCSampler.py:843-862: with prob 0.03 a "large" 10x jump, with prob
    0.07 a "small" 0.2x jump, else 1.0; scaled by sqrt(T) for T <= 100.
    ``prob [T, C]``, ``beta [T, 1]``.
    """
    scale = torch.where(prob > 0.97, 10.0, torch.where(prob > 0.9, 0.2, 1.0)).to(prob.dtype)
    temp = safe_temperature(beta)
    return torch.where(temp <= 100.0, scale * torch.sqrt(temp), scale)


class GroupEmbed:
    """Gather/scatter of one parameter group along the D axis of ``[..., D, C]``.

    The JAX package writes these as matmuls with one-hot selection rows
    (fast on a TPU); here they are index operations with the same values.
    """

    def __init__(self, g, ndim, device):
        g = np.asarray(g)
        self.identity = bool(np.array_equal(g, np.arange(ndim)))
        self.index = torch.as_tensor(g, dtype=torch.long, device=device)

    def take(self, x):
        """``x[..., g, :]``."""
        return x if self.identity else x.index_select(-2, self.index)

    def add_at(self, x, step):
        """``x`` with ``step`` added on the group's rows."""
        if self.identity:
            return x + step
        return x.index_copy(-2, self.index, x.index_select(-2, self.index) + step)

    def set_at(self, x, vals):
        """``x`` with the group's rows set to ``vals``."""
        if self.identity:
            return vals
        return x.index_copy(-2, self.index, vals)


def random_group(rng, ngroups, shape, device, block=None):
    """Uniform per-chain group choice (PTMCMCSampler.py:839, :897, :955),
    ``shape`` ``[T, C]``; with a ``block`` (``utils.Block``) its block of the
    unsharded draw."""
    if ngroups == 1:
        return torch.zeros(shape, dtype=torch.long, device=device)
    if block is not None:
        return block.draw(torch.randint, rng, ("T", "C"), device, 0, ngroups)
    return torch.randint(0, ngroups, shape, generator=rng, device=device)


def select_group(gidx, ngroups, results):
    """Per-chain pick among the groups' results (``[T, D, C]`` each)."""
    q = results[0]
    for gi in range(1, ngroups):
        q = torch.where((gidx == gi)[:, None, :], results[gi], q)
    return q
