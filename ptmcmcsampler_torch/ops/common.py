"""What the kernel wrappers share: the plain versions' ordered arithmetic,
the checks a wrapper makes before it launches, and the ``ctypes`` binding.

The plain versions write every product over ``D`` as an ordered sum with one
rounding per product and per sum, as the kernels do (``csrc/models.cuh``),
so that a kernel built with ``--fmad=false`` rounds as its plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

# Device functors compiled into every kernel (csrc/models.cuh), by the name a
# model gives in ``cuda_functor``, with the dimension each is compiled for.
FUNCTOR_NDIM = {"curved": 2}

# Philox4x32-10 (Salmon et al., SC'11): round multipliers and key bumps.
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def _mulhilo(a, b):
    """High and low words of ``a * b`` for a 32-bit constant ``a`` and an
    int64 tensor ``b`` of 32-bit words. torch has no unsigned 32 x 32 -> 64
    multiply and an int64 product of two words overflows, so ``b`` is split
    into 16-bit halves and each partial product stays below 2**48."""
    pl = a * (b & 0xFFFF)
    ph = a * (b >> 16)
    return (ph + (pl >> 16)) >> 16, (pl + ((ph & 0xFFFF) << 16)) & _MASK32


def philox4x32(ctr, key):
    """Philox4x32-10 as Random123 and ``csrc/philox.cuh`` define it: the
    plain versions' counter-based draws (the NUTS reservoir's uniforms, the
    HMC step's momenta and lengths).

    ``ctr``: four int64 tensors (or ints) of 32-bit words, broadcastable;
    ``key``: two. Returns the four output words as int64 tensors.
    """
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for i in range(10):
        if i:
            k0 = (k0 + PHILOX_W[0]) & _MASK32
            k1 = (k1 + PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def matvec(m, v):
    """``m @ v`` for ``m [D, D]``, ``v [T, D, C]``, summed over k in order."""
    out = m[None, :, 0, None] * v[:, 0:1]
    for k in range(1, m.shape[1]):
        out = out + m[None, :, k, None] * v[:, k:k + 1]
    return out


def rdot(a, b):
    """``sum_d a[..., d, :] * b[..., d, :]`` over the ``D`` axis (-2), in order."""
    out = a[..., 0, :] * b[..., 0, :]
    for k in range(1, a.shape[-2]):
        out = out + a[..., k, :] * b[..., k, :]
    return out


def log_hamiltonian(logp, p):
    """``logp - p.p/2`` with NaN mapped to -inf; ``p [T, D, C]``."""
    h = logp - 0.5 * rdot(p, p)
    return torch.where(torch.isnan(h), float("-inf"), h)


def whitened(model, chol, beta_b):
    """``q -> (logp, chol @ grad)`` at ``x = chol^T q``, for ``q [T, D, C]``."""

    def fgw(q):
        val, g = model.value_grad(matvec(chol.T, q), beta_b)
        return val, matvec(chol, g)

    return fgw


def cuda_functor(kernel, model, ndim):
    """The model's device functor name, or raise naming the model."""
    functor = getattr(model, "cuda_functor", None)
    if functor not in FUNCTOR_NDIM:
        raise NotImplementedError(
            f"model {type(model).__name__} has no CUDA device functor for the "
            f"{kernel} kernel (csrc/models.cuh)"
        )
    if ndim != FUNCTOR_NDIM[functor]:
        raise ValueError(
            f"functor {functor!r} is compiled for D={FUNCTOR_NDIM[functor]}, got {ndim}"
        )
    return functor


def check_args(fn_name, device, expect):
    """Raise unless every ``name: (tensor, shape, dtype)`` of ``expect`` has
    that shape and type, lies on ``device`` and is contiguous."""
    for name, (a, shape, dtype) in expect.items():
        if tuple(a.shape) != tuple(shape) or a.dtype != dtype or a.device != device:
            raise ValueError(
                f"{fn_name}: {name} is {tuple(a.shape)} {a.dtype} on {a.device}, "
                f"expected {tuple(shape)} {dtype} on {device}"
            )
        if not a.is_contiguous():
            raise ValueError(f"{fn_name}: {name} is not contiguous")


def check_device(fn_name, t):
    """True for a CPU tensor (the plain version runs), False for CUDA, else raise."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{fn_name}: unsupported device {t.device}")
    return False


def entry(source, symbol, argtypes):
    """The ``ctypes`` function ``symbol`` of ``csrc/<source>.cu``, built on
    first use; it returns the launch's CUDA error code."""
    fn = getattr(build.load(source), symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def launch(kernel, fn, device, *args):
    """Call ``fn(*args, stream)`` on ``device``'s current stream; raise on a
    CUDA error."""
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
