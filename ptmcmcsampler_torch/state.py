"""Sampler state: plain dataclasses of tensors, chain-minor ``[T, D, C]``.

Positions keep the JAX package's layout: the chain batch is the minor axis,
so one CUDA thread per chain reads neighbouring addresses. Host-known
integers (the iteration number and the DE fill count) are Python ints, so
the step never has to ask the device for them.

A captured step (``kernel.run_block`` on the card) reads and writes fixed
addresses: the block runner keeps one static state, a holder made by
:func:`map_state`, and writes every other state into it in place with
:func:`copy_into`.

``state_to_numpy`` / ``state_from_numpy`` use the path names of the JAX
package's checkpoint format (``"x"``, ``"adapt/cov"``, ``"adapt/group_u/0"``,
``"de/buf"``, ``"stepsize/chees_tlen"``, ``"counters/naccepted"``, ...), so a
JAX state flattened as its checkpoint flattens it loads here. The PRNG key
does not carry over: the torch generators are seeded separately.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import utils
from .config import SamplerConfig
from .ops.common import factor_structure

DTYPE = torch.float32


@dataclasses.dataclass
class AdaptState:
    """Covariance adaptation and the gradient jumps' whitening factors."""

    mean: torch.Tensor  # [D] running mean (Welford mu)
    m2: torch.Tensor  # [D, D] running scatter (Welford M2)
    # Samples consumed, as a Kahan-compensated f32 pair: f32 alone stops
    # incrementing once ulp(count) exceeds the batch size.
    count: torch.Tensor  # scalar f32
    count_err: torch.Tensor  # scalar f32 Kahan compensation
    cov: torch.Tensor  # [D, D] current proposal covariance
    group_u: tuple  # per-group eigenvectors [(sg, sg), ...]
    group_s: tuple  # per-group eigenvalues [(sg,), ...]
    chol: torch.Tensor  # [D, D] lower Cholesky factor of the mass-matrix inverse
    chol_inv: torch.Tensor  # [D, D] inverse of chol
    # The pair's structure tag (ops/common.py STRUCTURES: "dense" or
    # "diagonal"), worked out on the host where the factors are made: from
    # their f32 values here and on a load, from how they are made in
    # adaptation.refresh_factors. The wide kernels skip the terms it zeroes.
    # Not a checkpoint entry: a load recomputes it.
    structure: str


@dataclasses.dataclass
class DEState:
    """Differential-evolution history ring buffer."""

    buf: torch.Tensor  # [D, B] (history-minor, like SamplerState.x)
    filled: int  # columns written so far, below 2 * B (host-known)
    # The ring's next column, ``filled % B``, as an int64 scalar on the
    # ring's device: a captured step writes the ring through it
    # (adaptation.de_buffer_push). Made from ``filled`` when not given.
    start: torch.Tensor = None

    def __post_init__(self):
        if self.start is None:
            self.start = torch.tensor(self.filled % self.buf.shape[1], device=self.buf.device)


def de_fill_count(filled: int, rows: int) -> int:
    """A fill count kept below ``2 * rows``: once the ring is full, ``rows +
    (filled - rows) % rows`` has the same ring start (``filled % rows``) and
    the same valid count (``rows``), and it fits the checkpoint's int32
    however long the run."""
    return filled if filled < rows else rows + (filled - rows) % rows


SS_FIELDS = (
    "epsilon", "epsilonbar", "hbar", "mu", "ncalls",
    "chees_eps", "chees_epsbar", "chees_hbar", "chees_mu",
    "chees_count", "chees_m", "chees_v", "chees_tlen",
)


@dataclasses.dataclass
class StepSizeState:
    """Step-size adaptation, [T, C] each: the NUTS jump's per-chain dual
    averaging (epsilon <= 0 until its first call sets it) and the ChEES
    jump's per-temperature values, replicated along C."""

    epsilon: torch.Tensor
    epsilonbar: torch.Tensor
    hbar: torch.Tensor
    mu: torch.Tensor
    ncalls: torch.Tensor
    chees_eps: torch.Tensor
    chees_epsbar: torch.Tensor
    chees_hbar: torch.Tensor
    chees_mu: torch.Tensor  # 0 = "uninitialized"
    chees_count: torch.Tensor
    chees_m: torch.Tensor  # Adam first moment (log tlen)
    chees_v: torch.Tensor  # Adam second moment
    chees_tlen: torch.Tensor  # trajectory length (time units)


@dataclasses.dataclass
class Counters:
    """Acceptance bookkeeping (int32)."""

    naccepted: torch.Tensor  # [T, C]
    jump_proposed: torch.Tensor  # [J, T, C]
    jump_accepted: torch.Tensor  # [J, T, C]
    swaps_proposed: torch.Tensor  # [T] per adjacent pair (index T-1 unused)
    swaps_accepted: torch.Tensor  # [T, C]
    swaps_proposed_lad: torch.Tensor  # [T] ladder-window snapshots
    swaps_accepted_lad: torch.Tensor  # [T, C]


@dataclasses.dataclass
class SamplerState:
    it: int  # current iteration number
    x: torch.Tensor  # [T, D, C] positions (chain-minor)
    lnlike: torch.Tensor  # [T, C]
    lnprior: torch.Tensor  # [T, C]
    betas: torch.Tensor  # [T] inverse temperatures
    adapt: AdaptState
    de: DEState
    stepsize: StepSizeState
    counters: Counters
    rng: torch.Generator  # on the state's device: every per-chain draw
    host_rng: torch.Generator  # CPU: the jump-kind sequence

    @property
    def lnprob(self):
        return utils.tempered_lnprob(self.lnlike, self.lnprior, self.betas[:, None])


def make_generators(seed, device):
    """(device generator, CPU generator), seeded from one caller seed."""
    s_dev, s_host = np.random.SeedSequence(int(seed)).generate_state(2)
    rng = torch.Generator(device=device)
    rng.manual_seed(int(s_dev))
    host_rng = torch.Generator()
    host_rng.manual_seed(int(s_host))
    return rng, host_rng


def _t(a, device):
    """f32 tensor from host data (rounded from f64 once, as the JAX package)."""
    return torch.as_tensor(np.array(a, dtype=np.float32), device=device)


def init_adapt_state(config: SamplerConfig, cov0, device) -> AdaptState:
    """Factors of the initial covariance, computed in f64 on the host."""
    d = config.ndim
    cov0 = np.asarray(cov0, dtype=np.float64)
    group_u, group_s = [], []
    for g in config.groups:
        s, u = np.linalg.eigh(cov0[np.ix_(g, g)])
        group_u.append(_t(u, device))
        group_s.append(_t(np.maximum(s, 0.0), device))
    chol = np.linalg.cholesky(cov0 + 1e-12 * np.mean(np.diag(cov0)) * np.eye(d))
    chol_inv = np.linalg.solve(chol, np.eye(d))  # tested, not assumed, triangular
    return AdaptState(
        mean=torch.zeros(d, dtype=DTYPE, device=device),
        m2=torch.zeros(d, d, dtype=DTYPE, device=device),
        count=torch.zeros((), dtype=torch.float32, device=device),
        count_err=torch.zeros((), dtype=torch.float32, device=device),
        cov=_t(cov0, device),
        group_u=tuple(group_u),
        group_s=tuple(group_s),
        chol=_t(chol, device),
        chol_inv=_t(chol_inv, device),
        structure=factor_structure(np.float32(chol), np.float32(chol_inv)),
    )


def init_state(
    config: SamplerConfig, seed, x0, cov0, betas, lnlike0, lnprior0, device="cuda"
) -> SamplerState:
    """Initial state on ``device``.

    ``x0`` is one start point ``[D]`` for every chain, or per-chain starts in
    the caller-facing ``[T, C, D]`` convention; ``lnlike0``/``lnprior0`` are
    ``[T, C]`` (or anything reshapeable to it).
    """
    t, c, d = config.ntemps, config.nchains, config.ndim
    j = config.njumps
    dev = torch.device(device)
    de_rows = max(config.de_size, c)
    x0a = np.asarray(x0, dtype=np.float64)
    if x0a.ndim == 3:
        xs0 = np.moveaxis(x0a, 2, 1)
    else:
        xs0 = np.broadcast_to(x0a.reshape(d, 1), (t, d, c))
    rng, host_rng = make_generators(seed, dev)

    def full(v):
        return torch.full((t, c), v, dtype=DTYPE, device=dev)

    def zi(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    return SamplerState(
        it=0,
        x=_t(xs0, dev).contiguous(),
        lnlike=torch.as_tensor(lnlike0, device=dev).to(DTYPE).reshape(t, c),
        lnprior=torch.as_tensor(lnprior0, device=dev).to(DTYPE).reshape(t, c),
        betas=_t(betas, dev),
        adapt=init_adapt_state(config, cov0, dev),
        de=DEState(buf=torch.zeros(d, de_rows, dtype=DTYPE, device=dev), filled=0),
        stepsize=StepSizeState(
            epsilon=full(-1.0), epsilonbar=full(1.0), hbar=full(0.0), mu=full(0.0),
            ncalls=full(0.0), chees_eps=full(0.0), chees_epsbar=full(0.0),
            chees_hbar=full(0.0), chees_mu=full(0.0), chees_count=full(0.0),
            chees_m=full(0.0), chees_v=full(0.0),
            chees_tlen=full(float(config.hmc_stepsize)),
        ),
        counters=Counters(
            naccepted=zi(t, c), jump_proposed=zi(j, t, c), jump_accepted=zi(j, t, c),
            swaps_proposed=zi(t), swaps_accepted=zi(t, c),
            swaps_proposed_lad=zi(t), swaps_accepted_lad=zi(t, c),
        ),
        rng=rng,
        host_rng=host_rng,
    )


_TENSOR_GROUPS = {
    "adapt": ("mean", "m2", "count", "count_err", "cov", "chol", "chol_inv"),
    "stepsize": SS_FIELDS,
    "counters": tuple(f.name for f in dataclasses.fields(Counters)),
}


def state_tensors(state: SamplerState) -> dict:
    """Every tensor of ``state`` by path: the checkpoint's path names (see
    :func:`state_to_numpy`) and ``"de/start"``."""
    out = {
        "x": state.x, "lnlike": state.lnlike, "lnprior": state.lnprior, "betas": state.betas,
        "de/buf": state.de.buf, "de/start": state.de.start,
    }
    for group, names in _TENSOR_GROUPS.items():
        sub = getattr(state, group)
        out.update({f"{group}/{name}": getattr(sub, name) for name in names})
    for i, (u, s) in enumerate(zip(state.adapt.group_u, state.adapt.group_s)):
        out[f"adapt/group_u/{i}"] = u
        out[f"adapt/group_s/{i}"] = s
    return out


def state_to_numpy(state: SamplerState) -> dict:
    """Flatten to ``{path: numpy array}`` with the checkpoint's path names."""
    out = {"it": np.asarray(state.it, np.int32)}
    for path, a in state_tensors(state).items():
        if path == "de/start":  # filled % B: the count below stands for it
            out["de/filled"] = np.asarray(
                de_fill_count(state.de.filled, state.de.buf.shape[1]), np.int32)
            continue
        out[path] = a.detach().cpu().numpy().copy()
    return out


def map_state(state: SamplerState, fn, rng=None, host_rng=None) -> SamplerState:
    """A state whose every tensor is ``fn(tensor)``, with the host fields of
    ``state`` and the generators ``rng``/``host_rng`` (by default the same
    objects as ``state``'s). ``map_state(state, torch.clone)`` is a holder
    with addresses of its own; the sampler maps block states to the host."""
    a, de = state.adapt, state.de
    return SamplerState(
        it=state.it,
        x=fn(state.x),
        lnlike=fn(state.lnlike),
        lnprior=fn(state.lnprior),
        betas=fn(state.betas),
        adapt=AdaptState(
            **{n: fn(getattr(a, n)) for n in _TENSOR_GROUPS["adapt"]},
            group_u=tuple(fn(u) for u in a.group_u),
            group_s=tuple(fn(v) for v in a.group_s),
            structure=a.structure,
        ),
        de=DEState(buf=fn(de.buf), filled=de.filled, start=fn(de.start)),
        stepsize=StepSizeState(**{n: fn(getattr(state.stepsize, n)) for n in SS_FIELDS}),
        counters=Counters(**{n: fn(getattr(state.counters, n))
                             for n in _TENSOR_GROUPS["counters"]}),
        rng=state.rng if rng is None else rng,
        host_rng=state.host_rng if host_rng is None else host_rng,
    )


def clone_generator(gen: torch.Generator) -> torch.Generator:
    """A new generator on ``gen``'s device in ``gen``'s state (host-side: no
    device work)."""
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def copy_into(static: SamplerState, state: SamplerState) -> SamplerState:
    """Write ``state`` into ``static`` in place and return ``static``: every
    tensor into ``static``'s tensor of the same path (skipped where they are
    one object), the host fields, and the generators' states where the
    objects differ. ``static``'s addresses do not change, so a step captured
    on them reads what was written. Raises ``ValueError`` where a tensor's
    shape or type differs."""
    if state is static:
        return static
    dst = state_tensors(static)
    for path, t in state_tensors(state).items():
        d = dst[path]
        if d is t:
            continue
        if d.shape != t.shape or d.dtype != t.dtype:
            raise ValueError(f"copy_into: {path} is {tuple(t.shape)} {t.dtype}, the static "
                             f"state's {tuple(d.shape)} {d.dtype}")
        d.copy_(t)
    static.it = state.it
    static.de.filled = state.de.filled
    static.adapt.structure = state.adapt.structure
    for name in ("rng", "host_rng"):
        gen = getattr(state, name)
        if gen is not getattr(static, name):
            getattr(static, name).set_state(gen.get_state())
    return static


def state_shapes(config: SamplerConfig) -> dict:
    """``{path: shape}`` of every array a state of ``config`` holds."""
    t, c, d, j = config.ntemps, config.nchains, config.ndim, config.njumps
    shapes = {
        "it": (), "x": (t, d, c), "lnlike": (t, c), "lnprior": (t, c), "betas": (t,),
        "de/buf": (d, max(config.de_size, c)), "de/filled": (),
        "adapt/mean": (d,), "adapt/m2": (d, d), "adapt/count": (), "adapt/count_err": (),
        "adapt/cov": (d, d), "adapt/chol": (d, d), "adapt/chol_inv": (d, d),
    }
    shapes.update({f"stepsize/{f}": (t, c) for f in SS_FIELDS})
    shapes.update({
        "counters/naccepted": (t, c), "counters/jump_proposed": (j, t, c),
        "counters/jump_accepted": (j, t, c), "counters/swaps_proposed": (t,),
        "counters/swaps_accepted": (t, c), "counters/swaps_proposed_lad": (t,),
        "counters/swaps_accepted_lad": (t, c),
    })
    for i, g in enumerate(config.groups):
        shapes[f"adapt/group_u/{i}"] = (len(g), len(g))
        shapes[f"adapt/group_s/{i}"] = (len(g),)
    return shapes


def state_from_numpy(arrays, config: SamplerConfig, device="cuda", seed=0) -> SamplerState:
    """Rebuild a state from ``{path: array}`` (see :func:`state_to_numpy`).

    Every path the state needs must be present with the shape ``config``
    implies; a missing or misshapen entry raises ``ValueError``. A ``"key"``
    entry (the JAX PRNG key) is ignored; the generators are seeded from
    ``seed``. A negative ``"de/filled"``, which the JAX package's int32
    count reaches after 2**31 pushes, is read as that count plus 2**32: a
    full ring.
    """
    dev = torch.device(device)
    c = config.nchains
    for name, shape in state_shapes(config).items():
        if name not in arrays:
            raise ValueError(f"state arrays are missing {name!r}")
        if tuple(np.shape(arrays[name])) != shape:
            raise ValueError(
                f"state array {name!r} has shape {np.shape(arrays[name])}, "
                f"config implies {shape}"
            )

    def f32(name):
        return torch.as_tensor(np.array(arrays[name], np.float32), device=dev)

    def i32(name):
        return torch.as_tensor(np.array(arrays[name], np.int32), device=dev)

    ng = len(config.groups)
    de_rows = max(config.de_size, c)
    filled = int(arrays["de/filled"])
    rng, host_rng = make_generators(seed, dev)
    return SamplerState(
        it=int(arrays["it"]),
        x=f32("x"),
        lnlike=f32("lnlike"),
        lnprior=f32("lnprior"),
        betas=f32("betas"),
        adapt=AdaptState(
            **{n: f32(f"adapt/{n}") for n in _TENSOR_GROUPS["adapt"]},
            group_u=tuple(f32(f"adapt/group_u/{i}") for i in range(ng)),
            group_s=tuple(f32(f"adapt/group_s/{i}") for i in range(ng)),
            structure=factor_structure(np.float32(arrays["adapt/chol"]),
                                       np.float32(arrays["adapt/chol_inv"])),
        ),
        de=DEState(buf=f32("de/buf"), filled=de_fill_count(filled % 2**32, de_rows)),
        stepsize=StepSizeState(**{n: f32(f"stepsize/{n}") for n in SS_FIELDS}),
        counters=Counters(**{n: i32(f"counters/{n}") for n in _TENSOR_GROUPS["counters"]}),
        rng=rng,
        host_rng=host_rng,
    )
