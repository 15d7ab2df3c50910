"""Differential-evolution jump from the device-resident history ring buffer.

Parity target: ``DEJump`` (PTMCMCSampler.py:936-985): take two distinct
rows of the history, jump along their difference restricted to a random
parameter group; with prob 0.5 a "mode jump" (scale 1.0), else
``uniform() * 2.4/sqrt(2*sg) * sqrt(1/beta)``. Symmetric (qxy = 0).

Only the "blocked" pair law is ported: one independent ordered-distinct row
pair per group of ``de_block`` chains, shared within the group. Each chain's
marginal pair law is the reference's uniform ordered-distinct draw.
"""

from __future__ import annotations

import math

import torch

from .base import GroupEmbed, random_group, safe_temperature, select_group


def de_scale_and_apply(embeds, sizes, gidx, prob, uu, temp, sigma_full, x):
    """Group-restricted application of the difference vectors ``sigma_full``
    (``[T, D, C]``); ``prob, uu`` uniform ``[T, C]``, ``temp [T, 1]``."""
    results = []
    for emb, sg in zip(embeds, sizes):
        base = 2.4 / math.sqrt(2.0 * sg)
        scale = torch.where(prob > 0.5, 1.0, (uu * base) * torch.sqrt(temp))
        results.append(emb.add_at(x, scale[:, None, :] * emb.take(sigma_full)))
    return select_group(gidx, len(embeds), results)


def make_de_blocked(config, device):
    groups = [tuple(int(i) for i in g) for g in config.groups]
    embeds = [GroupEmbed(g, config.ndim, device) for g in groups]
    sizes = [len(g) for g in groups]
    gsize = config.de_block

    def core(x, betas, ctx, mm, nn, gidx, prob, uu):
        """``mm [T, G]`` uniform on ``[0, nvalid)`` and ``nn [T, G]`` uniform
        on ``[0, nvalid - 1)`` (long, ``G = ceil(C / de_block)``); the core
        shifts ``nn`` past ``mm``, which makes the pair uniform over ordered
        distinct pairs. ``gidx`` long, ``prob, uu`` uniform, ``[T, C]``."""
        c = x.shape[2]
        nn = nn + (nn >= mm).long()
        sig = ctx.de_buf[:, mm] - ctx.de_buf[:, nn]  # [D, T, G]
        sig_c = sig.repeat_interleave(gsize, dim=2)[:, :, :c].movedim(0, 1)  # [T, D, C]
        temps = torch.clamp(safe_temperature(betas), max=1e30)[:, None]
        return de_scale_and_apply(embeds, sizes, gidx, prob, uu, temps, sig_c, x)

    def de_blocked(rng, x, betas, it, ctx, ss):
        t, _, c = x.shape
        ng = -(-c // gsize)
        nvalid = max(ctx.de_valid, 2)
        mm = torch.randint(0, nvalid, (t, ng), generator=rng, device=x.device)
        nn = torch.randint(0, nvalid - 1, (t, ng), generator=rng, device=x.device)
        gidx = random_group(rng, len(groups), (t, c), x.device)
        prob = torch.rand((t, c), generator=rng, device=x.device)
        uu = torch.rand((t, c), generator=rng, device=x.device)
        q = core(x, betas, ctx, mm, nn, gidx, prob, uu)
        return q, torch.zeros_like(x[:, 0]), ss

    de_blocked.core = core
    return de_blocked
