"""Adaptive-Metropolis family: SCAM and AM jumps, over the whole batch.

* SCAM (PTMCMCSampler.py:820-876): jump along one random eigenvector of a
  random group's covariance, step
  ``randn() * (2.4/sqrt(2)) * scale * sqrt(S[ind]) * U[:, ind]``.
* AM (PTMCMCSampler.py:879-933): perturb every eigen-component with
  ``randn(sg) * (2.4/sqrt(2*sg)) * scale * sqrt(S)``.

Both are symmetric (qxy = 0). Each chain draws its own group, scale and
noise, as the vmapped JAX kernels do.
"""

from __future__ import annotations

import math

import torch

from ..utils import block_of
from .base import GroupEmbed, draw_am_scale, random_group, select_group


def _groups(config, device):
    groups = [tuple(int(i) for i in g) for g in config.groups]
    return groups, [GroupEmbed(g, config.ndim, device) for g in groups]


def make_scam(config, device):
    groups, embeds = _groups(config, device)
    sizes = [len(g) for g in groups]
    size_of = torch.as_tensor(sizes, device=device)
    cd = 2.4 / math.sqrt(2.0)

    def core(x, betas, ctx, gidx, prob, ind, z):
        """``gidx, ind`` long ``[T, C]`` (``ind`` < the chosen group's size);
        ``prob`` uniform and ``z`` standard normal, ``[T, C]``."""
        scale = draw_am_scale(prob, betas[:, None])
        results = []
        for gi, emb in enumerate(embeds):
            u, s = ctx.group_u[gi], ctx.group_s[gi]
            ig = torch.clamp(ind, max=sizes[gi] - 1)
            sval = torch.sqrt(torch.clamp(s, min=0.0))[ig]  # [T, C]
            vec = u[:, ig].movedim(0, 1)  # [T, sg, C]
            step = (z * cd * scale * sval)[:, None, :] * vec
            results.append(emb.add_at(x, step))
        return select_group(gidx, len(groups), results)

    def scam(rng, x, betas, it, ctx, ss):
        t, _, c = x.shape
        blk = block_of(ctx, x)
        gidx = random_group(rng, len(groups), (t, c), x.device, blk)
        prob = blk.draw(torch.rand, rng, ("T", "C"), x.device)
        size = size_of[gidx] if len(groups) > 1 else sizes[0]
        ind = (blk.draw(torch.rand, rng, ("T", "C"), x.device) * size).long()
        z = blk.draw(torch.randn, rng, ("T", "C"), x.device)
        return core(x, betas, ctx, gidx, prob, ind, z), torch.zeros_like(x[:, 0]), ss

    scam.core = core
    return scam


def make_am(config, device):
    groups, embeds = _groups(config, device)
    sizes = [len(g) for g in groups]

    def core(x, betas, ctx, gidx, prob, z):
        """``gidx`` long ``[T, C]``; ``prob`` uniform ``[T, C]``; ``z``
        standard normal ``[T, max group size, C]``."""
        scale = draw_am_scale(prob, betas[:, None])
        results = []
        for gi, emb in enumerate(embeds):
            sg = sizes[gi]
            u, s = ctx.group_u[gi], ctx.group_s[gi]
            y = u.T @ emb.take(x)  # [T, sg, C]
            cd = 2.4 / math.sqrt(2.0 * sg) * scale  # [T, C]
            y = y + z[:, :sg] * cd[:, None, :] * torch.sqrt(torch.clamp(s, min=0.0))[:, None]
            results.append(emb.set_at(x, u @ y))
        return select_group(gidx, len(groups), results)

    def am(rng, x, betas, it, ctx, ss):
        t, _, c = x.shape
        blk = block_of(ctx, x)
        gidx = random_group(rng, len(groups), (t, c), x.device, blk)
        prob = blk.draw(torch.rand, rng, ("T", "C"), x.device)
        z = blk.draw(torch.randn, rng, ("T", max(sizes), "C"), x.device)
        return core(x, betas, ctx, gidx, prob, z), torch.zeros_like(x[:, 0]), ss

    am.core = core
    return am
