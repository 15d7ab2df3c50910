"""Replica-exchange swaps, on the device.

The ladder is the leading array axis, so a swap permutes rows, vectorised
over chains; positions, log-likelihoods and log-priors all move with the
exchanges (``swap_mode``):

* ``"sweep"``: the reference's serial sweep from the hottest adjacent pair
  down, with the acceptance rule
  ``log_acc = (1/T_i - 1/T_{i+1}) * (L[m[i+1]] - L[m[i]])``
  (PTMCMCSampler.py:631-697), carrying the permuted rows directly.
* ``"deo"``: the deterministic even/odd scheme: at parity 0 the disjoint
  pairs (0, 1), (2, 3), ..., at parity 1 (1, 2), (3, 4), ...; each pair
  swaps on its own, so the permutation is two shifted selects.

Randomness is an input: ``us [T-1, C]``, row ``i`` for pair ``(i, i+1)``.
"""

from __future__ import annotations

import torch


def _log_acc(li, li1, bi, bi1):
    """The log acceptance of exchanging rows with likelihoods ``li``, ``li1``
    at inverse temperatures ``bi > bi1``: 0 between two -inf rows, -inf
    where it is NaN."""
    dll = torch.where(torch.isneginf(li1) & torch.isneginf(li), 0.0, li1 - li)
    log_acc = (bi - bi1) * dll
    return torch.where(torch.isnan(log_acc), float("-inf"), log_acc)


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
        take = log_us[i] <= _log_acc(li, li1, betas[i], betas[i + 1])
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


def sweep_swap_map(us, lnlike, betas):
    """The sweep as a permutation: ``(swap_map [T, C] int32, accepted [T, C],
    proposed [T])``, where row ``i`` of the swapped state is row
    ``swap_map[i]`` of the old one (:func:`apply_swap`)."""
    t, c = lnlike.shape
    dev = lnlike.device
    rows = torch.arange(t, dtype=torch.int32, device=dev)
    proposed = rows < (t - 1)
    if t <= 1:
        return (rows[:, None].expand(t, c).clone(),
                torch.zeros((t, c), dtype=torch.bool, device=dev), proposed)
    acc_rows, _, (m_rows,) = _sweep_rows(
        us, lnlike, betas, payload_rows=([rows[i].expand(c) for i in range(t)],))
    return torch.stack(m_rows), torch.stack(acc_rows), proposed


def _pair_take(us, lnlike, betas, parity):
    """DEO's accepted exchanges ``take [T-1, C]`` (pair ``(i, i+1)`` active
    where ``i % 2 == parity``) and the active pairs ``[T-1]``."""
    active = (torch.arange(lnlike.shape[0] - 1, device=lnlike.device) % 2) == parity % 2
    log_acc = _log_acc(lnlike[:-1], lnlike[1:], betas[:-1, None], betas[1:, None])
    take = active[:, None] & (torch.log(torch.clamp(us, min=1e-37)) <= log_acc)
    return take, active


def _pad_row(a, where):
    """``a [T-1, ...]`` with a row of False added at the ``"end"`` or ``"start"``."""
    pad = torch.zeros_like(a[:1])
    return torch.cat([a, pad] if where == "end" else [pad, a])


def deo_swap_map(us, lnlike, betas, parity):
    """DEO as a permutation: ``(swap_map [T, C] int32, accepted [T, C],
    proposed [T])``; ``proposed[i]`` only for the pairs active at
    ``parity``, so accepted / proposed is a pair's acceptance rate under
    either scheme."""
    t, c = lnlike.shape
    dev = lnlike.device
    rows = torch.arange(t, dtype=torch.int32, device=dev)[:, None].expand(t, c)
    if t <= 1:
        return (rows.clone(), torch.zeros((t, c), dtype=torch.bool, device=dev),
                torch.zeros(t, dtype=torch.bool, device=dev))
    take, active = _pair_take(us, lnlike, betas, parity)
    up, down = _pad_row(take, "end"), _pad_row(take, "start")  # row i swaps with i+1, i-1
    swap_map = torch.where(up, rows + 1, torch.where(down, rows - 1, rows))
    return swap_map, up, _pad_row(active, "end")


def apply_swap(swap_map, x, lnlike, lnprior):
    """Permute ``x [T, D, C]``, ``lnlike``/``lnprior [T, C]`` by ``swap_map``:
    row ``i`` of chain ``c`` takes row ``swap_map[i, c]``. Up to 16 rungs a
    select over the rows, as the JAX package writes it (its cost grows as
    T^2); above, a gather. The values are the same."""
    t = lnlike.shape[0]
    if t > 16:
        idx = swap_map.long()
        xg = torch.gather(x, 0, idx[:, None, :].expand_as(x))
        return xg, torch.gather(lnlike, 0, idx), torch.gather(lnprior, 0, idx)
    x_rows, ll_rows, lp_rows = [], [], []
    for i in range(t):
        sel = swap_map[i]
        xi, lli, lpi = x[i], lnlike[i], lnprior[i]
        for j in range(t):
            if j != i:
                m = sel == j
                xi = torch.where(m, x[j], xi)
                lli = torch.where(m, lnlike[j], lli)
                lpi = torch.where(m, lnprior[j], lpi)
        x_rows.append(xi)
        ll_rows.append(lli)
        lp_rows.append(lpi)
    return torch.stack(x_rows), torch.stack(ll_rows), torch.stack(lp_rows)


def deo_swap_apply(us, x, lnlike, lnprior, betas, parity):
    """One DEO event at ``parity`` (0 or 1, a host int) on ``x [T, D, C]``,
    ``lnlike``/``lnprior [T, C]``: each row exchanges only with its one
    partner, so the permutation is two shifted selects, the same values as
    ``apply_swap(deo_swap_map(...))``.

    Returns ``(x, lnlike, lnprior, accepted [T, C], proposed [T])``.
    """
    t, c = lnlike.shape
    if t <= 1:
        z = torch.zeros((t, c), dtype=torch.bool, device=x.device)
        return x, lnlike, lnprior, z, z[:, 0]
    take, active = _pair_take(us, lnlike, betas, parity)
    up, down = _pad_row(take, "end"), _pad_row(take, "start")

    def exchange(a, u, d):
        return torch.where(u, torch.roll(a, -1, 0), torch.where(d, torch.roll(a, 1, 0), a))

    new_x = exchange(x, up[:, None, :], down[:, None, :])
    return (new_x, exchange(lnlike, up, down), exchange(lnprior, up, down), up,
            _pad_row(active, "end"))


def draw_swap_uniforms(rng, t, c, device):
    """The sweep's uniforms ``[T-1, C]``."""
    return torch.rand((t - 1, c), generator=rng, device=device)


def draw_pair_uniforms(rng, t, c, device):
    """DEO's uniforms ``[T-1, C]``, row ``g`` for pair ``(g, g+1)``.

    The JAX package draws row ``g`` from its key folded with ``g``
    (``ptmcmcsampler_tpu/swaps.py pair_uniforms``) so that a device holding
    a shard of the ladder regenerates the rows of the pairs it owns. Here
    every rank of a sharded run draws the whole array, as the unsharded run
    does, and keeps its block (:func:`block_uniforms`): the unsharded
    stream stays what it was.
    """
    return torch.rand((t - 1, c), generator=rng, device=device)


def block_uniforms(us, block):
    """A block's rows and chains of the swap uniforms ``us [T-1, C]``:
    ``[Tl, Cl]``, local row ``i`` for pair ``(t0 + i, t0 + i + 1)``; the top
    shard's last row, which no pair has, is a copy of its row above. A block
    of every rung keeps all ``T - 1`` rows."""
    if block.t1 - block.t0 < block.ntemps:
        us = torch.cat([us, us[-1:]])
    return block.take(us, ("T", "C"))


def deo_shard_take(us, lnlike, betas, up_ll, up_beta, parity, t0, ntemps):
    """The DEO decisions of one temperature shard: ``(take [Tl, C] bool,
    active [Tl] bool)``, row ``i`` the pair ``(t0 + i, t0 + i + 1)``, from its
    rows ``lnlike [Tl, C]``, ``betas [Tl]``, uniforms ``us [Tl, C]``
    (:func:`block_uniforms`) and the first row of the shard above
    (``up_ll [C]``, ``up_beta`` 0-d; None for the top shard). The same
    operations as :func:`deo_swap_apply`'s, row by row."""
    tl = lnlike.shape[0]
    g = t0 + torch.arange(tl, device=lnlike.device)
    active = ((g % 2) == parity % 2) & (g <= ntemps - 2)
    if up_ll is None:  # the top row has no pair: any finite row, inactive
        up_ll, up_beta = lnlike[-1], betas[-1]
    hi_ll = torch.cat([lnlike[1:], up_ll[None]])
    hi_beta = torch.cat([betas[1:], up_beta.reshape(1)])
    log_acc = _log_acc(lnlike, hi_ll, betas[:, None], hi_beta[:, None])
    take = active[:, None] & (torch.log(torch.clamp(us, min=1e-37)) <= log_acc)
    return take, active


def deo_shard_move(take, rows, up_rows, down_rows, down_take):
    """The DEO exchange of one temperature shard: each array of ``rows``
    (``x [Tl, D, C]``, ``lnlike``, ``lnprior [Tl, C]``) after the shard's
    accepted exchanges ``take`` (:func:`deo_shard_take`), with the first rows
    of the shard above (``up_rows``) and the last rows of the shard below
    (``down_rows``, its ``take`` of its last row ``down_take [C]``); None at
    the ends of the ladder. Pairs are disjoint at a parity, so a row takes
    at most one neighbour's."""
    if down_take is None:
        down_take = torch.zeros_like(take[0])
    take_hi = torch.cat([down_take[None], take[:-1]])
    out = []
    for k, a in enumerate(rows):
        up = a[-1] if up_rows is None else up_rows[k]
        down = a[0] if down_rows is None else down_rows[k]
        shape = (-1,) + (1,) * (a.dim() - 2) + (a.shape[-1],)
        hi = torch.cat([a[1:], up[None]])
        lo = torch.cat([down[None], a[:-1]])
        out.append(torch.where(take.view(shape), hi,
                               torch.where(take_hi.view(shape), lo, a)))
    return out


def make_sharded_deo(block):
    """DEO on a temperature-sharded mesh, each shard's boundary rows sent to
    its neighbours (``torch.distributed`` sends, ``parallel.mesh
    .neighbour_exchange``), never a gather of the positions: the port of the
    JAX package's ``make_sharded_deo`` (its ``swaps.py:241``). Each shard
    sends its first row (``x``, ``lnlike``, ``lnprior``, beta) to the shard
    below, decides its pairs (:func:`deo_shard_take`), then sends its last
    row and that row's decision to the shard above
    (:func:`deo_shard_move`).

    Returns ``f(us, x, lnlike, lnprior, betas, parity) -> (x, lnlike,
    lnprior, accepted [Tl, C], proposed [T])`` on the block's rows,
    ``us`` the block's uniforms (:func:`block_uniforms`), ``betas`` its
    ``[Tl]``; ``proposed`` is the whole ladder's (every rank holds it).
    """
    from .parallel.mesh import neighbour_exchange

    mesh = block.mesh
    below = mesh.ti - 1 if mesh.ti > 0 else None
    above = mesh.ti + 1 if mesh.ti < mesh.ntemp - 1 else None
    t = block.ntemps

    def split(flat, d, c):
        return flat[:d * c].view(d, c), flat[d * c:(d + 1) * c], flat[(d + 1) * c:(d + 2) * c], \
            flat[(d + 2) * c:]

    def run(us, x, lnlike, lnprior, betas, parity):
        _, d, c = x.shape
        first = torch.cat([x[0].reshape(-1), lnlike[0], lnprior[0], betas[:1]])
        got = neighbour_exchange(block, first, below, first, above)
        up = None if got is None else split(got, d, c)
        take, _ = deo_shard_take(us, lnlike, betas, None if up is None else up[1],
                                 None if up is None else up[3][0], parity, block.t0, t)
        last = torch.cat([x[-1].reshape(-1), lnlike[-1], lnprior[-1],
                          take[-1].to(x.dtype)])
        got = neighbour_exchange(block, last, above, last, below)
        down = None if got is None else split(got, d, c)
        new = deo_shard_move(take, (x, lnlike, lnprior),
                             None if up is None else up[:3],
                             None if down is None else down[:3],
                             None if down is None else down[3] > 0.5)
        rows = torch.arange(t - 1, device=x.device)
        proposed = _pad_row((rows % 2) == parity % 2, "end")
        return (*new, take, proposed)

    return run


def sweep_swap_gathered(block, us, x, lnlike, lnprior, betas):
    """The sweep on a sharded mesh: every rank gathers the rows
    (``parallel.mesh.gather_many``), runs :func:`sweep_swap_apply` on the whole
    ladder with the whole uniforms ``us [T-1, C]``, and keeps its block.
    Returns :func:`sweep_swap_apply`'s results, ``proposed`` whole."""
    from .parallel.mesh import gather_many

    xd = ("T", x.shape[1], "C")
    rows = gather_many(block, [(x, xd), (lnlike, ("T", "C")), (lnprior, ("T", "C")),
                               (betas, ("T",))])
    x, ll, lp, acc, proposed = sweep_swap_apply(us, *rows)
    return (block.take(x, xd), block.take(ll, ("T", "C")),
            block.take(lp, ("T", "C")), block.take(acc, ("T", "C")), proposed)
