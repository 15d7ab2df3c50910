"""Adaptation updates: batched Welford moments, factor refresh, DE ring.

* ``welford_batch_update``: the Chan et al. parallel merge of a batch of
  samples into (mean, M2), equivalent to feeding them one by one through the
  reference's recursion (PTMCMCSampler.py:785-792);
* ``refresh_factors``: the cadenced per-group eigendecomposition
  (PTMCMCSampler.py:552-560, :794-803);
* ``de_buffer_push``: the DE history ring, written every iteration.
"""

from __future__ import annotations

import dataclasses

import torch

from . import utils
from .config import SamplerConfig
from .state import AdaptState, DEState, de_fill_count


def welford_batch_update(adapt: AdaptState, xs: torch.Tensor) -> AdaptState:
    """Merge a batch of samples ``xs [D, m]`` (chain-minor) into (mean, M2)."""
    n = adapt.count
    nf = float(xs.shape[1])  # a Python scalar: no host-to-device copy per call
    batch_mean = torch.mean(xs, dim=1)
    centered = xs - batch_mean[:, None]
    batch_m2 = centered @ centered.T
    delta = batch_mean - adapt.mean
    # Kahan-compensated count increment, kept in f32: exact integer
    # accumulation long after plain f32 would saturate.
    y = nf - adapt.count_err
    new_count = n + y
    new_err = (new_count - n) - y
    mean = adapt.mean + delta * (nf / new_count)
    m2 = adapt.m2 + batch_m2 + torch.outer(delta, delta) * (n * nf / new_count)
    return dataclasses.replace(adapt, mean=mean, m2=m2, count=new_count, count_err=new_err)


def refresh_factors(config: SamplerConfig, adapt: AdaptState) -> AdaptState:
    """Recompute cov = M2/(n-1) and the per-group (and, with ``mass_adapt``,
    full Cholesky) factors.

    eigh gives the reference's SVD factors up to column order and sign,
    which no proposal depends on. A degenerate covariance (all zero or NaN)
    keeps the previous factors; the guard is a ``where``, not a branch, so
    the host never waits for it. ``torch.linalg.eigh`` itself synchronises
    with the device on CUDA; it runs once every ``cov_update`` iterations.
    """
    n = torch.clamp(adapt.count, min=2.0)
    cov = adapt.m2 / (n - 1.0)
    group_u, group_s = [], []
    for gi, g in enumerate(config.groups):
        idx = torch.as_tensor(g, device=cov.device)
        sub = cov[idx][:, idx]
        s, u = torch.linalg.eigh(sub)
        s = torch.clamp(s, min=0.0)
        ok = torch.all(torch.isfinite(u)) & (torch.max(s) > 0)
        group_u.append(torch.where(ok, u, adapt.group_u[gi]))
        group_s.append(torch.where(ok, s, adapt.group_s[gi]))
    new = dataclasses.replace(adapt, cov=cov, group_u=tuple(group_u), group_s=tuple(group_s))
    if config.mass_adapt:
        chol = utils.cholesky_psd(cov)
        ok = torch.all(torch.isfinite(chol))
        eye = torch.eye(config.ndim, dtype=chol.dtype, device=chol.device)
        chol_inv = torch.linalg.solve_triangular(chol, eye, upper=False)
        # A Cholesky factor and its triangular solve: the pair's tag widens
        # to "dense" without a read of the device, which every pair the
        # where may keep satisfies.
        new = dataclasses.replace(
            new,
            chol=torch.where(ok, chol, adapt.chol),
            chol_inv=torch.where(ok, chol_inv, adapt.chol_inv),
            structure="dense",
        )
    return new


def de_buffer_push(de: DEState, xs: torch.Tensor) -> DEState:
    """Write ``xs [D, m]`` into the ring buffer ``buf [D, B]`` (``m <= B``).

    The law is the JAX package's: column ``(start + i) % B`` takes
    ``xs[:, i]``, with ``start = filled % B``. The JAX version writes it as a
    masked roll, because a traced-index scatter is slow on a TPU; here the
    columns are written in place on ``de.buf`` through a device index,
    ``(de.start + arange(m)) % B``, so a captured step reads the start from
    the device and no host value is frozen into it. The host-known count
    advances as before and stays below ``2 * B``
    (:func:`~ptmcmcsampler_torch.state.de_fill_count`).
    """
    rows = de.buf.shape[1]
    m = xs.shape[1]
    cols = (de.start + torch.arange(m, device=de.buf.device)) % rows
    de.buf.index_copy_(1, cols, xs)
    return DEState(buf=de.buf, filled=de_filled_after(de, m), start=(de.start + m) % rows)


def de_filled_after(de: DEState, m: int) -> int:
    """The host count after ``m`` more columns: what the block runner keeps
    on the host for an iteration whose push ran inside a graph."""
    return de_fill_count(de.filled + m, de.buf.shape[1])


def de_valid_rows(de: DEState) -> int:
    return min(de.filled, de.buf.shape[1])
