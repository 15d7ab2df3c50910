"""Small shared numerical helpers."""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def resolve_device(device, caller):
    """``torch.device(device)``, with a bare ``"cuda"`` pinned to the current
    card; raises when it names the card and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{caller}: device='cuda' but no CUDA device is available; "
                "pass device='cpu' to run on the CPU"
            )
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def tempered_lnprob(lnlike, lnprior, beta):
    """Tempered log-posterior ``beta * lnlike + lnprior``.

    Two guards keep the reference's semantics (PTMCMCSampler.py:481-487):

    * ``beta == 0`` (the hot chain): ``0 * -inf`` is NaN in torch as in IEEE,
      but a ``-inf`` likelihood must stay ``-inf`` at any temperature;
    * ``lnprior == -inf`` dominates whatever the likelihood is.
    """
    tempered = torch.where(torch.isneginf(lnlike), NEG_INF, beta * lnlike)
    return torch.where(torch.isneginf(lnprior), NEG_INF, tempered + lnprior)


def cholesky_psd(mat, jitter=1e-10):
    """Cholesky factor of a (possibly barely-) PSD matrix with a jitter retry.

    Uses ``cholesky_ex`` so that a failed factorisation yields NaNs to test
    for instead of an exception that would need the device to report back.
    """
    d = mat.shape[-1]
    eye = torch.eye(d, dtype=mat.dtype, device=mat.device)
    scale = torch.clamp(torch.mean(torch.diagonal(mat)), min=1.0)
    chol, info = torch.linalg.cholesky_ex(mat + jitter * scale * eye)
    ok = (info == 0) & torch.all(torch.isfinite(chol))
    bigger, _ = torch.linalg.cholesky_ex(mat + 1e-4 * scale * eye)
    return torch.where(ok, chol, bigger)


class Block:
    """Where one rank's block of rungs and chains lies in the ``[T, C]``
    batch: rungs ``[t0, t1)`` and chains ``[c0, c1)`` of ``ntemps`` and
    ``nchains`` (the whole batch, the default, is the unsharded run). ``mesh``
    is the ``parallel.PTMesh`` the block belongs to (None unsharded).

    Every random draw of a step is of the unsharded run's shape, and each
    rank keeps its block of it (:meth:`draw`): every rank seeds its
    generators alike, so a sharded run draws what the unsharded one does,
    and an unsharded run's stream is the one it always was. ``dims`` names
    an array's axes: ``"T"`` the rungs, ``"C"`` the chains, an int any other
    axis of that extent.
    """

    def __init__(self, ntemps, nchains, t0=0, t1=None, c0=0, c1=None, mesh=None):
        self.ntemps, self.nchains = int(ntemps), int(nchains)
        self.t0, self.t1 = int(t0), self.ntemps if t1 is None else int(t1)
        self.c0, self.c1 = int(c0), self.nchains if c1 is None else int(c1)
        self.mesh = mesh

    @property
    def sharded(self) -> bool:
        """Whether the block is less than the whole batch."""
        return (self.t1 - self.t0, self.c1 - self.c0) != (self.ntemps, self.nchains)

    @property
    def n0(self) -> int:
        """The unsharded index of the block's first chain, ``t0 * C + c0``:
        the kernels' counter base (``ops/common.py chain_counters``)."""
        return self.t0 * self.nchains + self.c0

    def shape(self, dims):
        """The unsharded shape of an array of axes ``dims``."""
        return tuple(self.ntemps if d == "T" else self.nchains if d == "C" else int(d)
                     for d in dims)

    def take(self, a, dims):
        """This block of ``a`` (axes ``dims``, the unsharded shape); ``a``
        itself when the block is the whole batch."""
        if not self.sharded:
            return a
        index = tuple(slice(self.t0, self.t1) if d == "T" else slice(self.c0, self.c1)
                      if d == "C" else slice(None) for d in dims)
        return a[index].contiguous()

    def draw(self, fn, rng, dims, device, *args, **kwargs):
        """``fn(*args, shape, generator=rng, device=device, **kwargs)`` at the
        unsharded ``shape`` of ``dims``, and this block of it."""
        return self.take(fn(*args, self.shape(dims), generator=rng, device=device, **kwargs),
                         dims)

    def spread(self, a, dims, fill=0.0):
        """The unsharded array whose block is ``a`` (axes ``dims``), ``fill``
        elsewhere; ``a`` itself when the block is the whole batch."""
        if not self.sharded:
            return a
        shape = tuple(self.ntemps if d == "T" else self.nchains if d == "C" else n
                      for d, n in zip(dims, a.shape))
        out = torch.full(shape, fill, dtype=a.dtype, device=a.device)
        index = tuple(slice(self.t0, self.t1) if d == "T" else slice(self.c0, self.c1)
                      if d == "C" else slice(None) for d in dims)
        out[index] = a
        return out

    def slice_pieces(self, start, n):
        """This block's part of a slice of ``n`` chains whose position ``k``
        holds chain ``(start + k) % nchains`` (a ``per_chain`` rotation
        slice): ``[(k0, k1), ...]``, the runs of positions whose chains the
        block holds, ascending. One run, or two where the block's chains
        hold both ends of the slice but not its middle; none where they hold
        none of it."""
        c = self.nchains
        s, width = (self.c0 - start) % c, self.c1 - self.c0
        if s + width <= c:  # the positions of the block's chains: [s, s + width)
            runs = [(s, min(s + width, n))]
        else:  # they wrap: [0, s + width - c) and [s, c)
            runs = [(0, min(s + width - c, n)), (s, n)]
            if runs[0][1] == s:  # the whole batch's chains: one run
                runs = [(0, n)]
        return [(k0, k1) for k0, k1 in runs if k0 < k1]

    def piece(self, n, k0, k1):
        """The block of positions ``[k0, k1)`` of an ``n``-chain slice, on
        this block's rungs: the sub-batch a ``per_chain`` branch runs on,
        whose draws are of the slice's unsharded shape ``[T, ..., n]`` and
        whose kernel counters are ``t * n + k`` (:attr:`n0`, ``nchains``)."""
        return Block(self.ntemps, n, self.t0, self.t1, k0, k1)


def block_of(ctx, x):
    """The block of a proposal context (``ctx.block``), or for a context
    without one the whole batch of ``x [T, D, C]``."""
    block = getattr(ctx, "block", None)
    return Block(x.shape[0], x.shape[2]) if block is None else block


def exponential(shape, generator, device):
    """Exp(1) draws of ``shape`` (a :meth:`Block.draw` ``fn``)."""
    return torch.empty(shape, device=device).exponential_(generator=generator)
