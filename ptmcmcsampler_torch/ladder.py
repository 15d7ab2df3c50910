"""Temperature-ladder construction (host numpy).

Geometric ladder ``T_i = Tmin * c**i`` with default spacing
``c = 1 + sqrt(2/ndim)``, or ``c = exp(log(Tmax/Tmin)/(ntemps-1))`` when
``Tmax`` is given; a single chain gets ``[1]`` (PTMCMCSampler.py:699-720).
"""

from __future__ import annotations

import numpy as np

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
