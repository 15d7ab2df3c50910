"""Weighted proposal cycle.

With ``jump_select="shared"`` each iteration one jump kind is drawn for the
whole batch, with probability weight / sum of the active weights; the DE
jump is active only after its ``activate_after`` iteration
(PTMCMCSampler.py:579-585, :987-1067). The draw is independent of all chain
state, so a whole block's kind sequence is drawn up front on the host and
each iteration calls the chosen branch directly: no per-iteration read back
from the device. The user's custom and prior-draw jumps are branches too,
and the auxiliary jumps follow every branch (``proposals/custom.py``).

With ``jump_select="per_chain"`` each chain takes its own kind every
iteration, the reference's law (PTMCMCSampler.py:1058-1059); the kinds are
drawn on the device (``kernel.py``). Which jumps are active then depends on
the iteration only through the activation thresholds crossed: the phase
(:func:`activation_phase`), a host value. The rotation mode's static layout
of a phase is :func:`rotation_partition`.
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


def build_jump_branches(config: SamplerConfig, model, device, capture=None):
    """One branch per jump of ``config.jumps``, each
    ``branch(rng, x[T, D, C], betas[T], it, ctx, ss) -> (q, qxy[T, C], ss)``;
    the NUTS branch writes its trajectory into ``capture`` if given."""
    makers = {
        KIND_SCAM: lambda spec: am.make_scam(config, device),
        KIND_AM: lambda spec: am.make_am(config, device),
        KIND_DE: lambda spec: de.make_de(config, device),
        KIND_CHEES: lambda spec: chees.make_chees(config, model),
        KIND_NUTS: lambda spec: nuts.make_nuts(config, model, capture),
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


def activation_thresholds(config: SamplerConfig):
    """The distinct positive ``activate_after`` iterations, ascending."""
    _, act = config.weights_and_activation()
    return sorted({int(a) for a in act if int(a) > 0})


def activation_phase(config: SamplerConfig, it):
    """How many activation thresholds host iteration ``it`` has crossed
    (``it > threshold``): the per_chain phase, 0 before the first."""
    return sum(it > thr for thr in activation_thresholds(config))


def rotation_partition(config: SamplerConfig, crossed):
    """Chains of each jump in the rotation's static layout (numpy int
    ``[J]``, summing to ``nchains``), once the thresholds in ``crossed`` are
    crossed: the largest-remainder rounding of ``nchains`` times the active
    jumps' probabilities, as the JAX package's ``kernel.py`` partitions
    (its :184-197, ties broken by the same ``argsort``); an inactive jump
    gets no chain."""
    c = config.nchains
    w_np, act_np = config.weights_and_activation()
    active = np.array([(int(a) == 0) or (int(a) in crossed) for a in act_np])
    probs = w_np * active
    if probs.sum() <= 0:  # degenerate: nothing active yet
        probs = np.asarray(w_np, np.float64)
    raw = probs / probs.sum() * c
    counts = np.floor(raw).astype(int)
    frac = raw - counts
    frac[~active] = -1.0
    for k in np.argsort(-frac)[: c - counts.sum()]:
        counts[k] += 1
    return counts


def phase_partitions(config: SamplerConfig):
    """:func:`rotation_partition` of each phase, by phase index."""
    thresholds = activation_thresholds(config)
    return [rotation_partition(config, set(thresholds[:p])) for p in range(len(thresholds) + 1)]
