"""The temperature ladder: its construction (host numpy) and its adaptation
(device tensors).

Geometric ladder ``T_i = Tmin * c**i`` with default spacing
``c = 1 + sqrt(2/ndim)``, or ``c = exp(log(Tmax/Tmin)/(ntemps-1))`` when
``Tmax`` is given; a single chain gets ``[1]`` (PTMCMCSampler.py:699-720).
The reference's ladder is static; :func:`adapt_ladder_betas` is the JAX
package's adaptive geometry (BASELINE.json config 5).
"""

from __future__ import annotations

import numpy as np
import torch

HOT_TEMP = 1e80  # the reference's prior-sampling chain temperature


def temperature_ladder(ndim, ntemps, tmin=1.0, tmax=None, tstep=None):
    """Build a geometric temperature ladder as a host numpy array."""
    if ntemps <= 1:
        # Integer 1, so a chain file would be named "chain_1.txt".
        return np.array([1])
    if tstep is None and tmax is None:
        tstep = 1.0 + np.sqrt(2.0 / ndim)
    elif tstep is None:
        tstep = np.exp(np.log(tmax / tmin) / (ntemps - 1))
    return tmin * tstep ** np.arange(ntemps)


def ladder_betas(ladder, hot_chain=False):
    """``(ladder, betas)``: inverse temperatures for the compute path.

    ``hot_chain=True`` replaces the hottest rung with the reference's
    ``temp = 1e80`` chain; in f32 its beta underflows to exactly 0, which
    :func:`ptmcmcsampler_torch.utils.tempered_lnprob` handles.
    """
    ladder = np.asarray(ladder).copy()
    if hot_chain and len(ladder) > 1:
        ladder = ladder.astype(np.float64)
        ladder[-1] = HOT_TEMP
    return ladder, 1.0 / ladder.astype(np.float64)


def adapt_ladder_betas(betas, pair_rates, it, lag=10000.0, time=100.0, skip_top=False,
                       pair_valid=None):
    """One adaptive-ladder update, as ``ptmcmcsampler_tpu.ladder.adapt_ladder_betas``.

    The hyperbolic-decay scheme of Vousden, Farr & Mandel (2016): each
    temperature spacing ``T_{i+1} - T_i`` grows by ``exp(kappa (A_i -
    A_{i+1}))`` for the pair acceptance rates ``A``, with ``kappa = lag /
    (it + lag) / time``, which drives the rates along the ladder to one
    value. The coldest and hottest rungs stay fixed; the spacings are
    scaled into 0.995 of the span between them where they would overflow
    it, so the ladder never inverts.

    ``betas [T]`` descending, ``pair_rates [T]`` (index ``i`` the pair
    ``(i, i+1)``; the last unused), ``it`` the iteration as an integer
    tensor on the betas' device (the decay is computed there in f32, so a
    CUDA graph that holds this update reads the iteration of its replay).
    ``skip_top`` leaves the top rung (a beta = 0 hot chain) out of the
    geometry. ``pair_valid [T]`` bool: an update of a spacing applies only
    where both pairs it compares had proposals. Returns the new betas.
    """
    t = betas.shape[0] - (1 if skip_top else 0)
    if t < 3:
        return betas
    dt = betas.dtype
    # The constants as fills on the device (a copy from the host cannot be
    # captured in a CUDA graph).
    lag_t = torch.full((), lag, dtype=dt, device=betas.device)
    decay = lag_t / (it.to(dt) + lag_t)
    kappa = decay / torch.full((), time, dtype=dt, device=betas.device)
    b = betas[:t]
    rates = pair_rates[: t - 1]
    ds = kappa * (rates[:-1] - rates[1:])  # [t-2]
    if pair_valid is not None:
        ok = pair_valid[: t - 1]
        ds = torch.where(ok[:-1] & ok[1:], ds, 0.0)
    delta_t = torch.diff(1.0 / b[:-1]) * torch.exp(ds)
    t0 = 1.0 / b[0]
    avail = 1.0 / b[t - 1] - t0
    total = torch.sum(delta_t)
    scale = torch.clamp(0.995 * avail / torch.clamp(total, min=1e-30), max=1.0)
    new_mid = 1.0 / (torch.cumsum(delta_t * scale, 0) + t0)
    return torch.cat([betas[:1], new_mid.to(dt), betas[t - 1:]])
