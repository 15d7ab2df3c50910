"""Replica-exchange swaps: the reference's hottest-first sweep, on device.

The reference gathers all chains to rank 0 and runs a serial sweep from the
hottest adjacent pair down, with the acceptance rule
``log_acc = (1/T_i - 1/T_{i+1}) * (L[m[i+1]] - L[m[i]])``
(PTMCMCSampler.py:631-697). Here the ladder is the leading array axis and
the sweep, vectorised over chains, carries the permuted rows directly, so
positions, log-likelihoods and log-priors all move with the exchanges.
"""

from __future__ import annotations

import torch


def _sweep_rows(us, lnlike, betas, payload_rows=()):
    """Hottest-first serial sweep over row lists.

    ``us [T-1, C]`` are the swap uniforms (row ``i`` for pair ``(i, i+1)``).
    Each of ``payload_rows`` is a list of T tensors whose last axis is the
    chain axis; they are exchanged with the likelihood rows.
    Returns ``(acc_rows, ll_rows, payload_rows)``.
    """
    t, c = lnlike.shape
    log_us = torch.log(torch.clamp(us, min=1e-37))
    ll_rows = [lnlike[i] for i in range(t)]
    acc_rows = [torch.zeros(c, dtype=torch.bool, device=lnlike.device) for _ in range(t)]
    payload_rows = [list(rows) for rows in payload_rows]
    for i in range(t - 2, -1, -1):  # hottest pair first
        li, li1 = ll_rows[i], ll_rows[i + 1]
        dll = torch.where(torch.isneginf(li1) & torch.isneginf(li), 0.0, li1 - li)
        log_acc = (betas[i] - betas[i + 1]) * dll
        log_acc = torch.where(torch.isnan(log_acc), float("-inf"), log_acc)
        take = log_us[i] <= log_acc
        ll_rows[i] = torch.where(take, li1, li)
        ll_rows[i + 1] = torch.where(take, li, li1)
        for rows in payload_rows:
            ri, ri1 = rows[i], rows[i + 1]
            rows[i] = torch.where(take, ri1, ri)
            rows[i + 1] = torch.where(take, ri, ri1)
        acc_rows[i] = take
    return acc_rows, ll_rows, payload_rows


def sweep_swap_apply(us, x, lnlike, lnprior, betas):
    """Apply one sweep to ``x [T, D, C]``, ``lnlike``/``lnprior [T, C]``.

    Returns ``(x, lnlike, lnprior, accepted [T, C] bool, proposed [T] bool)``:
    ``accepted[i]`` marks pair ``(i, i+1)`` swaps; every pair but the unused
    index ``T-1`` is proposed.
    """
    t, c = lnlike.shape
    proposed = torch.arange(t, device=lnlike.device) < (t - 1)
    if t <= 1:
        return x, lnlike, lnprior, torch.zeros((t, c), dtype=torch.bool, device=x.device), proposed
    acc_rows, ll_rows, (x_rows, lp_rows) = _sweep_rows(
        us, lnlike, betas, payload_rows=([x[i] for i in range(t)], [lnprior[i] for i in range(t)])
    )
    return (
        torch.stack(x_rows),
        torch.stack(ll_rows),
        torch.stack(lp_rows),
        torch.stack(acc_rows),
        proposed,
    )


def draw_swap_uniforms(rng, t, c, device):
    """The sweep's uniforms ``[T-1, C]``."""
    return torch.rand((t - 1, c), generator=rng, device=device)
