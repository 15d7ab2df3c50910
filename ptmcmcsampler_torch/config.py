"""Static sampler configuration (PyTorch port of ``ptmcmcsampler_tpu.config``).

Everything here is host-side and constant for one sampler: shapes, cadences,
the jump-cycle layout and the parameter groups. The dynamic quantities live
in :mod:`ptmcmcsampler_torch.state`. All state is float32.

The port covers the whole cycle of the JAX package: SCAM/AM/DE, the
gradient jumps ChEES, NUTS, HMC and MALA, the user's custom, prior-draw and
auxiliary jumps, both jump selections (one kind an iteration for the whole
batch, or one a chain: ``jump_select="per_chain"``), both swap schemes (the
hottest-first sweep and DEO), the adaptive ladder, the three DE pair laws
(blocked, rolled, iid), NUTS trees to depth 30 with a forced length, and
the capture of one NUTS trajectory. ``__post_init__`` refuses what the JAX
package refuses. The JAX package's TPU dispatch knobs (``use_pallas``,
``nuts_impl``, ``pallas_nuts_block_n``, ``nuts_pass1_depth``) choose among
TPU code paths with the same results and have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np

KIND_SCAM = "scam"
KIND_AM = "am"
KIND_DE = "de"
KIND_MALA = "mala"
KIND_HMC = "hmc"
KIND_NUTS = "nuts"
KIND_CHEES = "chees"
KIND_CUSTOM = "custom"
KIND_PRIOR = "prior_draw"

PORTED_KINDS = (KIND_SCAM, KIND_AM, KIND_DE, KIND_CHEES, KIND_NUTS, KIND_HMC, KIND_MALA,
                KIND_CUSTOM, KIND_PRIOR)

#: How a custom, prior-draw or auxiliary jump's callable runs: "torch", batched
#: over the chains by ``torch.func.vmap`` on the device (inside the step's CUDA
#: graphs on the card), or "host", one numpy call a chain (eagerly).
PROTOCOLS = ("torch", "host")

#: Deepest NUTS tree of the NUTS kernel's default entries (2**10 - 1 = 1023
#: leaves), as the JAX package's fused tree kernel; deeper trees, a forced
#: trajectory length and the trajectory capture run its general entry.
NUTS_MAX_KERNEL_DEPTH = 10

#: Deepest NUTS tree any entry builds. The JAX package counts a subtree's
#: leaves in int32 (``1 << depth``, its proposals/nuts.py), which overflows
#: at depth 31; so does the reservoir's 32-bit Philox row counter here.
NUTS_MAX_DEPTH = 30

#: How ``jump_select="per_chain"`` assigns the kinds: "rotation" (a static
#: weight-proportional layout of the chains, rotated by one random offset an
#: iteration; each branch runs once on its slice), "stacked" (every branch on
#: the whole batch, each chain taking its own kind's result) or "auto"
#: (rotation from PER_CHAIN_ROTATION_MIN chains, stacked below).
PER_CHAIN_MODES = ("auto", "rotation", "stacked")
PER_CHAIN_ROTATION_MIN = 128


@dataclasses.dataclass(frozen=True)
class JumpSpec:
    """One entry of the weighted proposal cycle.

    A proposal with weight ``w`` is drawn with probability ``w / sum(weights)``
    among the active proposals; ``activate_after`` delays activation until a
    given iteration (the DE jump enters after burn-in). A custom, prior-draw
    or auxiliary jump carries the user's callable ``fn`` and its
    ``protocol`` (:data:`PROTOCOLS`; ``proposals/custom.py`` has the
    signatures).
    """

    name: str
    kind: str
    weight: float
    activate_after: int = 0
    fn: Optional[Callable] = None
    protocol: str = "torch"


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Constants for one sampler."""

    ndim: int
    ntemps: int
    nchains: int
    groups: Tuple[Tuple[int, ...], ...]
    jumps: Tuple[JumpSpec, ...]
    aux_jumps: Tuple[JumpSpec, ...] = ()

    tskip: int = 100  # iterations between swap sweeps
    cov_update: int = 1000  # iterations between covariance refreshes
    burn: int = 10000  # DE activation and ChEES adaptation window
    thin: int = 10
    de_size: int = 10000  # DE history ring-buffer rows

    jump_select: str = "shared"  # "shared" (one kind an iteration) or "per_chain"
    per_chain_mode: str = "auto"  # PER_CHAIN_MODES
    # DE pair law (proposals/de.py): "blocked" (one ordered-distinct pair a
    # group of de_block chains), "iid" (one a chain, the reference's law) or
    # "rolled" (one shift pair an iteration, counter-rotating over chains).
    de_pair: str = "blocked"
    de_block: int = 8  # chains per shared DE pair
    swap_mode: str = "sweep"  # "sweep" (the reference's) or "deo" (even/odd)
    adapt_from: str = "cold"  # covariance data source: "cold" chain or "all"
    # Adaptive ladder geometry (Vousden+ 2016; BASELINE.json config 5), in
    # burn-in only, both ends fixed (ladder.adapt_ladder_betas).
    adapt_ladder: bool = False
    ladder_adapt_lag: float = 10000.0
    ladder_adapt_time: float = 100.0
    ladder_adapt_skip_top: bool = False  # True when the top rung is a beta = 0 hot chain

    hmc_stepsize: float = 0.1  # HMC step size; initial ChEES step size
    hmc_nminsteps: int = 2  # HMC trajectory length drawn from [nmin, nmax)
    hmc_nmaxsteps: int = 300
    nuts_delta: float = 0.6  # dual-averaging target (nutsjump.py:410)
    nuts_max_depth: int = 10  # 1 .. NUTS_MAX_DEPTH
    nuts_force_epsilon: Optional[float] = None
    # Leaves a NUTS tree runs to in place of the U-turn test (the JAX
    # package's semantics: the tree stops once it has this many leaves).
    nuts_force_trajlen: Optional[int] = None
    nuts_trajectory: bool = False  # capture the (T0, C0) trajectory (nutsjump.py:818-835)
    chees_max_steps: int = 256
    chees_delta: float = 0.651
    chees_lr: float = 0.025
    mass_adapt: bool = False

    def __post_init__(self):
        if not (self.ndim >= 1 and self.ntemps >= 1 and self.nchains >= 1):
            raise ValueError("ndim, ntemps and nchains must be >= 1")
        for g in self.groups:
            for i in g:
                if not 0 <= i < self.ndim:
                    raise ValueError(f"group index {i} out of range")
        if not self.jumps:
            raise ValueError("No jump proposals specified!")
        if self.jump_select not in ("shared", "per_chain"):
            raise ValueError(f"unknown jump_select {self.jump_select!r}")
        if self.per_chain_mode not in PER_CHAIN_MODES:
            raise ValueError(f"unknown per_chain_mode {self.per_chain_mode!r}")
        if self.swap_mode not in ("sweep", "deo"):
            raise ValueError(f"unknown swap_mode {self.swap_mode!r}")
        if self.de_pair not in ("blocked", "rolled", "iid"):
            raise ValueError(f"unknown de_pair {self.de_pair!r}")
        if self.de_block < 1:
            raise ValueError("de_block must be >= 1")
        if self.adapt_from not in ("cold", "all"):
            raise ValueError(f"unknown adapt_from {self.adapt_from!r}")
        if not 1 <= self.nuts_max_depth <= NUTS_MAX_DEPTH:
            raise ValueError(f"nuts_max_depth={self.nuts_max_depth} is outside [1, "
                             f"{NUTS_MAX_DEPTH}]: a tree's leaf count must fit an int32")
        for j in self.jumps:
            if j.kind not in PORTED_KINDS:
                raise ValueError(f"unknown jump kind {j.kind!r}")
        for j in self.jumps + self.aux_jumps:
            user = j.kind in (KIND_CUSTOM, KIND_PRIOR)
            if user and (j.fn is None or j.protocol not in PROTOCOLS):
                raise ValueError(f"jump {j.name!r} needs a callable and a protocol in "
                                 f"{PROTOCOLS}")
        if self.jump_select == "per_chain":
            for j in self.jumps:
                if j.protocol == "host":
                    # The stacked mode runs every branch each iteration; a host
                    # branch would make ntemps * nchains host calls.
                    raise ValueError(
                        f"per_chain jump selection cannot include the host (numpy) jump "
                        f"{j.name!r}; pass a torch-native jump or use jump_select='shared'")
            if self.nuts_trajectory:
                raise ValueError("NUTS trajectory capture requires jump_select='shared'")

    @property
    def per_chain_rotation(self):
        """Whether ``per_chain`` selection runs the rotation (else stacked)."""
        mode = self.per_chain_mode
        return mode == "rotation" or (mode == "auto" and self.nchains >= PER_CHAIN_ROTATION_MIN)

    @property
    def njumps(self):
        return len(self.jumps)

    def jump_names(self):
        return tuple(j.name for j in self.jumps)

    def weights_and_activation(self):
        """(weights[J], activate_after[J]) as numpy arrays."""
        w = np.array([j.weight for j in self.jumps], dtype=np.float32)
        act = np.array([j.activate_after for j in self.jumps], dtype=np.int32)
        return w, act


def build_default_jumps(
    SCAMweight=20,
    AMweight=20,
    DEweight=20,
    NUTSweight=0,
    MALAweight=0,
    HMCweight=0,
    CHEESweight=0,
    burn=10000,
    have_grads=False,
):
    """Reference-default jump cycle (PTMCMCSampler.py:226-264).

    Gradient jumps are only registered when gradients are available;
    zero-weight jumps are dropped. The DE jump activates after ``burn``.
    """
    jumps = []
    if have_grads:
        if MALAweight:
            jumps.append(JumpSpec("MALAJump", KIND_MALA, MALAweight))
        if HMCweight:
            jumps.append(JumpSpec("HMCJump", KIND_HMC, HMCweight))
        if NUTSweight:
            jumps.append(JumpSpec("NUTSJUMP", KIND_NUTS, NUTSweight))
        if CHEESweight:
            jumps.append(JumpSpec("ChEESHMCJump", KIND_CHEES, CHEESweight))
    if SCAMweight:
        jumps.append(JumpSpec("covarianceJumpProposalSCAM", KIND_SCAM, SCAMweight))
    if AMweight:
        jumps.append(JumpSpec("covarianceJumpProposalAM", KIND_AM, AMweight))
    if DEweight:
        jumps.append(JumpSpec("DEJump", KIND_DE, DEweight, activate_after=burn))
    return tuple(jumps)
