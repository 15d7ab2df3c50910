"""Differential-evolution jump from the device-resident history ring buffer.

Parity target: ``DEJump`` (PTMCMCSampler.py:936-985): take two distinct
rows of the history, jump along their difference restricted to a random
parameter group; with prob 0.5 a "mode jump" (scale 1.0), else
``uniform() * 2.4/sqrt(2*sg) * sqrt(1/beta)``. Symmetric (qxy = 0).

The three pair laws of the JAX package (``SamplerConfig.de_pair``):

* ``"blocked"`` (default): one independent ordered-distinct row pair per
  group of ``de_block`` chains, shared within the group.
* ``"iid"``: one independent ordered-distinct pair per chain, the
  reference's law: the blocked law with groups of one chain, which is how
  it runs here.
* ``"rolled"``: one pair of shifts ``(s1, s2)`` per iteration; chain ``c``
  takes rows ``((c + s1) % n, (s2 - c) % n)`` of the ``n`` valid ones, the
  same difference at every temperature. Each chain's pair is uniform over
  ordered pairs; where the two rows coincide (one chain in ``n``) the move
  is the identity. Only the joint law across chains is correlated, which
  synchronises mode jumps on a multimodal target such as the curved one
  (the JAX package's ``proposals/de.py`` warning): use it on unimodal ones.

Each chain's marginal pair law is the reference's under all three. Every
law's draws are inputs of a deterministic ``core``, so tests feed the JAX
package's draws to it.
"""

from __future__ import annotations

import math

import torch

from ..utils import block_of
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


def _groups(config, device):
    groups = [tuple(int(i) for i in g) for g in config.groups]
    return groups, [GroupEmbed(g, config.ndim, device) for g in groups], [len(g) for g in groups]


def _scale_draws(rng, ngroups, blk, t, c, device):
    """Each chain's group, mode-jump uniform and scale uniform, ``[T, C]``
    (the block ``blk`` of the unsharded draws)."""
    gidx = random_group(rng, ngroups, (t, c), device, blk)
    prob = blk.draw(torch.rand, rng, ("T", "C"), device)
    uu = blk.draw(torch.rand, rng, ("T", "C"), device)
    return gidx, prob, uu


def make_de(config, device):
    """The DE branch of ``config.de_pair``'s law."""
    if config.de_pair == "rolled":
        return make_de_rolled(config, device)
    return make_de_blocked(config, device, 1 if config.de_pair == "iid" else config.de_block)


def make_de_blocked(config, device, block=None):
    """Pairs shared by groups of ``block`` chains (``config.de_block`` by
    default; 1 is the "iid" law)."""
    groups, embeds, sizes = _groups(config, device)
    gsize = config.de_block if block is None else block

    def core(x, betas, ctx, mm, nn, gidx, prob, uu, offset=0):
        """``mm [T, G]`` uniform on ``[0, nvalid)`` and ``nn [T, G]`` uniform
        on ``[0, nvalid - 1)`` (long, ``G = ceil(C / block)``); the core
        shifts ``nn`` past ``mm``, which makes the pair uniform over ordered
        distinct pairs. ``gidx`` long, ``prob, uu`` uniform, ``[T, C]``.
        ``offset``: the batch's first chain in its first group (a shard's
        chains start mid-group)."""
        c = x.shape[2]
        nn = nn + (nn >= mm).long()
        sig = ctx.de_buf[:, mm] - ctx.de_buf[:, nn]  # [D, T, G]
        sig_c = sig.repeat_interleave(gsize, dim=2)[:, :, offset:offset + c].movedim(0, 1)
        temps = torch.clamp(safe_temperature(betas), max=1e30)[:, None]
        return de_scale_and_apply(embeds, sizes, gidx, prob, uu, temps, sig_c, x)

    def de_blocked(rng, x, betas, it, ctx, ss):
        t, _, c = x.shape
        blk = block_of(ctx, x)
        ng = -(-blk.nchains // gsize)
        nvalid = max(ctx.de_valid, 2)
        # The groups of the block's chains, of the unsharded draws.
        g0, g1 = blk.c0 // gsize, -(-blk.c1 // gsize)
        mm, nn = (blk.draw(torch.randint, rng, ("T", ng), x.device, 0, hi)[:, g0:g1]
                  for hi in (nvalid, nvalid - 1))
        q = core(x, betas, ctx, mm, nn, *_scale_draws(rng, len(groups), blk, t, c, x.device),
                 offset=blk.c0 - g0 * gsize)
        return q, torch.zeros_like(x[:, 0]), ss

    de_blocked.core = core
    return de_blocked


def make_de_rolled(config, device):
    """Counter-rotating shifts, one pair an iteration (the "rolled" law)."""
    groups, embeds, sizes = _groups(config, device)

    def core(x, betas, ctx, s1, s2, gidx, prob, uu, c0=0):
        """``s1, s2`` 0-d long tensors uniform on ``[0, nvalid)``; ``gidx``,
        ``prob, uu`` as the blocked core's. The rows are index arithmetic on
        the device (no shift is read back to the host), which covers the
        full ring and a part-full one alike, and more chains than ring rows
        (the pattern repeats every ``nvalid`` chains). ``c0``: the index of
        the batch's first chain (a shard's)."""
        c = x.shape[2]
        nvalid = max(ctx.de_valid, 2)
        chains = torch.arange(c0, c0 + c, device=x.device)
        sig = ctx.de_buf[:, (chains + s1) % nvalid] - ctx.de_buf[:, (s2 - chains) % nvalid]
        collide = ((2 * chains + s1 - s2) % nvalid) == 0  # the same row twice: no move
        sig = torch.where(collide, 0.0, sig)  # [D, C], every temperature's
        temps = torch.clamp(safe_temperature(betas), max=1e30)[:, None]
        sig_t = sig.expand(x.shape[0], -1, -1)
        return de_scale_and_apply(embeds, sizes, gidx, prob, uu, temps, sig_t, x)

    def de_rolled(rng, x, betas, it, ctx, ss):
        t, _, c = x.shape
        blk = block_of(ctx, x)
        nvalid = max(ctx.de_valid, 2)
        s1 = torch.randint(0, nvalid, (), generator=rng, device=x.device)
        s2 = torch.randint(0, nvalid, (), generator=rng, device=x.device)
        q = core(x, betas, ctx, s1, s2, *_scale_draws(rng, len(groups), blk, t, c, x.device),
                 c0=blk.c0)
        return q, torch.zeros_like(x[:, 0]), ss

    de_rolled.core = core
    return de_rolled
