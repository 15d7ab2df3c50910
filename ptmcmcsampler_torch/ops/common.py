"""What the kernel wrappers share: the plain versions' ordered arithmetic,
the checks a wrapper makes before it launches, and the ``ctypes`` binding.

The plain versions write every product over ``D`` as an ordered sum with one
rounding per product and per sum, as the kernels do (``csrc/models.cuh``),
so that a kernel built with ``--fmad=false`` rounds as its plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

# Most dimensions of the wide layout (csrc/models.cuh kWideMaxD), and its
# products: rows a thread keeps, rows a tile, stages in flight where they fit.
WIDE_MAX_D = 1024
WIDE_J, WIDE_KT, WIDE_STAGES = 4, 16, 3
# The dynamic shared memory a wide kernel may ask for (kWideSmemLimit): the
# H100's 227 KiB a block (232,448 B, static arrays included) less 8 KiB kept
# for the kernels' static arrays.
WIDE_SMEM_LIMIT = 232448 - 8192


def wide_group(ndim):
    """Chains a group of the wide layout runs together at dimension ``ndim``
    (csrc/models.cuh wide_group): 64, 32, 16, 8 or 4 as ``ndim`` <= 64, 128,
    256, 512 or 1024, so that a block's 256 threads of WIDE_J rows and 4
    chains cover the dimension."""
    for most, group in ((64, 64), (128, 32), (256, 16), (512, 8)):
        if ndim <= most:
            return group
    return 4


def _smem_bytes(ndim, group, stages):
    """Five ``[D][group]`` vectors and ``stages`` tile stages of D rounded up
    to WIDE_J rows of WIDE_KT + 1 floats (a row-dot tile's padded stride),
    rounded up to 16 bytes."""
    rows = -(-ndim // WIDE_J) * WIDE_J
    stage = (rows * (WIDE_KT + 1) + 3) & ~3
    return 4 * (5 * ndim * group + stages * stage)


def wide_stages(ndim, group):
    """Tile stages of the wide products' ring (csrc/models.cuh wide_stages):
    WIDE_STAGES where they fit in WIDE_SMEM_LIMIT, else two."""
    return WIDE_STAGES if _smem_bytes(ndim, group, WIDE_STAGES) <= WIDE_SMEM_LIMIT else 2


def wide_smem_bytes(ndim, group):
    """Dynamic shared memory of a wide kernel's block at dimension ``ndim``
    and group size ``group`` (csrc/models.cuh wide_smem_bytes): the five
    vectors and ``wide_stages`` tile stages."""
    return _smem_bytes(ndim, group, wide_stages(ndim, group))


# The device functors of csrc/models.cuh, by the name a model gives in
# ``cuda_functor``: for each kernel that has an entry for the functor, the
# dimensions ``(least, most)`` it takes. The curved functor is compiled for
# D = 2 into the register kernels of all three; the wide functors run in the
# wide layout of all three at any D up to WIDE_MAX_D. ``user.register_functor``
# adds a user's functor, which runs in the wide layout at its own dims.
_WIDE = {"chees": (1, WIDE_MAX_D), "hmc": (1, WIDE_MAX_D), "nuts": (1, WIDE_MAX_D)}
FUNCTORS = {
    "curved": {"chees": (2, 2), "hmc": (2, 2), "nuts": (2, 2)},
    "correlated_gaussian": dict(_WIDE),
    "interval_gaussian": dict(_WIDE),
    "hierarchical_gaussian": {kernel: (2, WIDE_MAX_D) for kernel in _WIDE},
}

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


# The structures of a whitening factor pair (chol, chol_inv); a wide entry
# takes the index as its launch argument (csrc/models.cuh WideStructure).
# "diagonal": both factors diagonal, their products elementwise; "dense":
# any pair, every term multiplied (a triangular factor too: a lower path
# measured slower than the dense one on every wide workload, PERF.md).
STRUCTURES = ("dense", "diagonal")


def matrix_structure(m):
    """"diagonal" if the square matrix ``m`` (numpy, or a tensor) is zero
    off its diagonal, else "dense". It reads a tensor's values to the host:
    for where a factor is made and for the plain versions, never inside a
    step on the card."""
    a = m.detach().cpu().numpy() if isinstance(m, torch.Tensor) else np.asarray(m)
    return "diagonal" if not (a - np.diag(np.diag(a))).any() else "dense"


def factor_structure(*mats):
    """The structure tag of a factor pair from its f32 values: "diagonal"
    if every matrix is, else "dense". Worked out on the host where the
    factors are made (state.py), never inside a step."""
    diagonal = all(matrix_structure(m) == "diagonal" for m in mats)
    return "diagonal" if diagonal else "dense"


def check_structure(label, structure, *mats):
    """Raise unless ``structure`` is a tag of STRUCTURES and each matrix of
    ``mats`` is zero wherever it says: a wrong tag must never give a
    silently wrong product. The plain versions' check; it reads the values,
    so the kernel wrappers do not make it on the card."""
    structure_code(label, structure)
    if structure == "diagonal" and factor_structure(*mats) != "diagonal":
        raise ValueError(f"{label}: the factor is tagged 'diagonal' but is dense")


def structure_code(label, structure):
    """A wide entry's launch argument for the tag ``structure``."""
    if structure not in STRUCTURES:
        raise ValueError(f"{label}: structure {structure!r} is not one of {STRUCTURES}")
    return STRUCTURES.index(structure)


def kernel_structure(model, structure):
    """The structure a kernel and its plain version use for ``model``: the
    tag for the wide functors, whose products skip a diagonal factor's
    zeros; "dense" for everything else (the curved D = 2 kernels multiply
    every term)."""
    functor = getattr(model, "cuda_functor", None)
    return structure if functor in FUNCTORS and functor != "curved" else "dense"


def matvec(m, v, structure="dense"):
    """``m @ v`` for ``m [D, D]``, ``v [..., D, C]``, summed over k in order,
    or with ``structure`` "diagonal" the elementwise ``m[i, i] * v[i]``, as
    the kernels compute it (csrc/models.cuh wide_matvec)."""
    if structure == "diagonal":
        return torch.diagonal(m)[:, None] * v
    out = m[:, 0, None] * v[..., 0:1, :]
    for k in range(1, m.shape[1]):
        out = out + m[:, k, None] * v[..., k:k + 1, :]
    return out


def rsum(a):
    """``sum_d a[..., d, :]`` over the ``D`` axis (-2), in order."""
    out = a[..., 0, :]
    for k in range(1, a.shape[-2]):
        out = out + a[..., k, :]
    return out


def rdot(a, b):
    """``sum_d a[..., d, :] * b[..., d, :]`` over the ``D`` axis (-2), in order."""
    return rsum(a * b)


def log_hamiltonian(logp, p):
    """``logp - p.p/2`` with NaN mapped to -inf; ``p [T, D, C]``."""
    h = logp - 0.5 * rdot(p, p)
    return torch.where(torch.isnan(h), float("-inf"), h)


def whitened(model, chol, beta_b, structure="dense"):
    """``q -> (logp, chol @ grad)`` at ``x = chol^T q``, for ``q [T, D, C]``,
    both products over the terms of the factor's ``structure``."""

    def fgw(q):
        val, g = model.value_grad(matvec(chol.T, q, structure), beta_b)
        return val, matvec(chol, g, structure)

    return fgw


def kernel_refusal(functor, kernel, ndim):
    """Why ``kernel`` ("chees", "hmc" or "nuts") cannot run the device
    functor ``functor`` at dimension ``ndim``, or None if it can."""
    if functor not in FUNCTORS:
        return ("no CUDA device functor: none of csrc/models.cuh, nor one registered "
                "with ptmcmcsampler_torch.register_functor")
    dims = FUNCTORS[functor].get(kernel)
    if dims is None:
        return f"the {kernel.upper()} kernel has no entry for functor {functor!r}"
    if dims[0] == dims[1] != ndim:
        return f"functor {functor!r} is compiled for D={dims[0]}, got {ndim}"
    if not dims[0] <= ndim <= dims[1]:
        return (f"the {kernel.upper()} kernel takes functor {functor!r} at "
                f"{dims[0]} <= D <= {dims[1]}, got {ndim}")
    return None


def cuda_functor(kernel, model, ndim, label):
    """The model's device functor name for ``kernel``, or raise naming the
    model: NotImplementedError for a model or functor without an entry,
    ValueError for a dimension the entry does not take."""
    functor = getattr(model, "cuda_functor", None)
    why = kernel_refusal(functor, kernel, ndim)
    if why is not None:
        kind = ValueError if FUNCTORS.get(functor, {}).get(kernel) else NotImplementedError
        raise kind(f"{label}: model {type(model).__name__}: {why}")
    return functor


def cuda_params(label, model, functor, device):
    """A wide functor's constants on ``device`` (``model.cuda_params``),
    checked: f32, contiguous, of the length the model gives
    (``model.cuda_params_len``). Raise if missing."""
    get = getattr(model, "cuda_params", None)
    prm = get(device) if callable(get) else None
    if not isinstance(prm, torch.Tensor):
        raise ValueError(f"{label}: model {type(model).__name__} gives no constants array "
                         f"for functor {functor!r} (cuda_params)")
    check_args(label, device, {"model constants": (prm, (model.cuda_params_len(),),
                                                   torch.float32)})
    return prm


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


def entry(source, functor, symbol, argtypes):
    """The ``ctypes`` function ``symbol`` of ``csrc/<source>.cu``, or of the
    library generated for ``functor`` if it is a registered user functor
    (``ops/user.py``), built on first use; it returns the launch's CUDA
    error code."""
    library = f"{source}_{functor}"
    fn = getattr(build.load(library if library in build.GENERATED else source), symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def chain_counters(t, c, n0, c_total, device):
    """The counter word of each chain of a ``[T, C]`` block, int64 ``[T *
    C]``: ``n0 + t*c_total + c``, its index in the unsharded batch
    (``c_total`` None: ``C``)."""
    c_total = c if c_total is None else c_total
    rows = torch.arange(t, dtype=torch.int64, device=device)[:, None] * c_total
    return (n0 + rows + torch.arange(c, dtype=torch.int64, device=device)).reshape(-1)


def launch(kernel, fn, device, *args):
    """Call ``fn(*args, stream)`` on ``device``'s current stream; raise on a
    CUDA error."""
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
