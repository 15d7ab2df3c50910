"""Weighted proposal cycle.

Each iteration one jump kind is drawn for the whole batch
(``jump_select="shared"``), with probability weight / sum of the active
weights; the DE jump is active only after its ``activate_after`` iteration
(PTMCMCSampler.py:579-585, :987-1067). The draw is independent of all chain
state, so a whole block's kind sequence is drawn up front on the host and
each iteration calls the chosen branch directly: no per-iteration read back
from the device. The user's custom and prior-draw jumps are branches too,
and the auxiliary jumps follow every branch (``proposals/custom.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import (
    KIND_AM,
    KIND_CHEES,
    KIND_CUSTOM,
    KIND_DE,
    KIND_HMC,
    KIND_MALA,
    KIND_NUTS,
    KIND_PRIOR,
    KIND_SCAM,
    SamplerConfig,
)
from . import am, chees, custom, de, gradient, nuts


def build_jump_branches(config: SamplerConfig, model, device):
    """One branch per jump of ``config.jumps``, each
    ``branch(rng, x[T, D, C], betas[T], it, ctx, ss) -> (q, qxy[T, C], ss)``."""
    makers = {
        KIND_SCAM: lambda spec: am.make_scam(config, device),
        KIND_AM: lambda spec: am.make_am(config, device),
        KIND_DE: lambda spec: de.make_de(config, device),
        KIND_CHEES: lambda spec: chees.make_chees(config, model),
        KIND_NUTS: lambda spec: nuts.make_nuts(config, model),
        KIND_HMC: lambda spec: gradient.make_hmc(config, model),
        KIND_MALA: lambda spec: gradient.make_mala(config, model),
        KIND_CUSTOM: custom.make_custom,
        KIND_PRIOR: lambda spec: custom.make_prior_draw(spec, model),
    }
    return [makers[spec.kind](spec) for spec in config.jumps]


def jump_probabilities(config: SamplerConfig, it):
    """Active-cycle pick probabilities at host iteration ``it`` (numpy [J])."""
    w, act = config.weights_and_activation()
    active = (it > act) | (act == 0)
    probs = w * active.astype(w.dtype)
    return probs / max(float(np.sum(probs)), 1e-9)


def draw_kinds(config: SamplerConfig, it0, n, host_rng):
    """Jump kinds for iterations ``it0+1 .. it0+n`` (a list of ints), drawn
    on the CPU generator ``host_rng``."""
    probs = np.stack([jump_probabilities(config, it0 + k) for k in range(1, n + 1)])
    kinds = torch.multinomial(
        torch.as_tensor(probs, dtype=torch.float64), 1, generator=host_rng
    )
    return kinds[:, 0].tolist()
