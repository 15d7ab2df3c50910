"""User device functors: a user's model in the ChEES, NUTS and HMC kernels.

The JAX package traces a user's ``func_grad`` into its Pallas kernels. The
port's kernels are compiled, so a user gives the model's tempered value and
gradient of one chain as CUDA C++ source and registers it::

    functor = register_functor("my_model", '''
        __device__ static float value_grad(const float* x, int stride, int D,
                                           float beta, const float* prm, float* g) {
          ...  // reads x[d * stride], writes g[d * stride] for d < D
          return beta * ll + lp;
        }''', dims=(2, 64))

The source is the body of a struct that the generator names; it may hold
other static device functions beside ``value_grad``. ``prm`` is the model's
constants array (``model.cuda_params(device)``, of ``model.cuda_params_len()``
floats; null where that length is 0). Registration returns the functor's
name, ``"user_<name>"``, for the model's ``cuda_functor``.

Each kernel gets one generated translation unit, which includes the
kernel's templates (``csrc/<kernel>_kernels.cuh``) and instantiates its
wide entries with ``WidePerChain<...>`` (``csrc/models.cuh``) under
``chees_step_user_<name>``, ``chees_trajectory_user_<name>``,
``nuts_tree_user_<name>``, ``nuts_general_user_<name>`` (the NUTS kernel's
general entry, a library of its own), ``hmc_step_user_<name>``,
``hmc_trajectory_user_<name>`` and ``hmc_draws_user_<name>``. The
libraries are keyed like the built-in ones (``ops/build.py``) and built by
:func:`prepare`, or at a kernel's first launch; nothing falls back: a
missing ``nvcc`` or a failed build raises, naming the functor.

A registered functor runs in the wide layout at any D in ``dims``, within
``[1, common.WIDE_MAX_D]`` (1024). At D > 256 a group holds 8 or 4 chains,
so only that many of a block's 256 threads run the functor's per-chain
loop: right, and slow for a model whose value is dear. A kernel is
bitwise equal to its plain version (the model's batched ``value_grad``)
only where the two compute in the same order: the kernels are built
``--fmad=false``, and a sum over D must be ordered in both
(``common.rsum``).
"""

from __future__ import annotations

import re

from . import build, common

# The kernels' sources, the header of each, its entry macro, and the symbols
# the macro defines for a functor.
KERNELS = {
    "chees": ("chees_trajectory", "chees_kernels.cuh", "PTMC_CHEES_WIDE_ENTRIES",
              ("chees_trajectory", "chees_step")),
    "nuts": ("nuts_tree", "nuts_kernels.cuh", "PTMC_NUTS_WIDE_ENTRY", ("nuts_tree",)),
    "hmc": ("hmc_trajectory", "hmc_kernels.cuh", "PTMC_HMC_WIDE_ENTRIES",
            ("hmc_trajectory", "hmc_step", "hmc_draws")),
    # The NUTS kernel's general entry (deep trees, a forced length, the
    # capture): a library of its own, at the NUTS kernel's dims.
    "nuts_general": ("nuts_general", "nuts_general.cuh", "PTMC_NUTS_GENERAL_WIDE_ENTRY",
                     ("nuts_general",)),
}
PREFIX = "user_"

_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*\Z")
_PTR = r"\s*\*\s*(?:__restrict__\s+)?\w+\s*"
_SIGNATURE = re.compile(
    r"\bvalue_grad\s*\(\s*const\s+float" + _PTR + r",\s*int\s+\w+\s*,\s*int\s+\w+\s*,"
    r"\s*float\s+\w+\s*,\s*const\s+float" + _PTR + r",\s*float" + _PTR + r"\)"
)

# Registered functors: name ("user_<name>") -> (source, dims).
REGISTERED: dict = {}


def register_functor(name, source, dims=(1, common.WIDE_MAX_D)):
    """Register a user's device functor and return its name for the model's
    ``cuda_functor``, ``"user_<name>"``.

    ``name`` is a C identifier other than a built-in functor's; ``source``
    defines ``value_grad`` with the signature in the module docstring;
    ``dims = (lo, hi)`` the dimensions it takes, ``1 <= lo <= hi <=
    WIDE_MAX_D`` (1024). The same name again with the same source and dims is a
    no-op; with others it raises. Builds nothing (see :func:`prepare`).
    """
    if not isinstance(name, str) or not _IDENT.match(name):
        raise ValueError(f"register_functor: name {name!r} is not a C identifier")
    if name in common.FUNCTORS:
        raise ValueError(f"register_functor: {name!r} is a built-in functor's name")
    lo, hi = (int(d) for d in dims)
    if not 1 <= lo <= hi <= common.WIDE_MAX_D:
        raise ValueError(f"register_functor: dims {tuple(dims)} are not within "
                         f"1 <= lo <= hi <= {common.WIDE_MAX_D}")
    if not isinstance(source, str) or not _SIGNATURE.search(source):
        raise ValueError(
            "register_functor: the source defines no value_grad(const float* x, int stride, "
            "int D, float beta, const float* prm, float* g)")
    functor = PREFIX + name
    if functor in REGISTERED:
        if REGISTERED[functor] != (source, (lo, hi)):
            raise ValueError(f"register_functor: {name!r} is registered with another "
                             "source or other dims")
        return functor
    REGISTERED[functor] = (source, (lo, hi))
    common.FUNCTORS[functor] = {kernel: (lo, hi) for kernel in KERNELS if kernel != "nuts_general"}
    for kernel in KERNELS:
        build.GENERATED[library_name(kernel, functor)] = translation_unit(kernel, functor)
    return functor


def library_name(kernel, functor):
    """The library of ``kernel`` (a key of KERNELS) built with the
    registered ``functor``."""
    return f"{KERNELS[kernel][0]}_{functor}"


def translation_unit(kernel, functor):
    """The generated CUDA source of ``kernel``'s entries for ``functor``."""
    source, _ = REGISTERED[functor]
    _, header, macro, symbols = KERNELS[kernel]
    struct = f"{functor}_functor"
    names = ", ".join(f"{s}_{functor}" for s in symbols)
    return f"""\
// Generated by ptmcmcsampler_torch/ops/user.py for the registered functor
// {functor!r}: {names}.
#include <type_traits>

#include "{header}"

namespace ptmc_user {{
struct {struct} {{
{source}
}};
static_assert(std::is_same<decltype(&{struct}::value_grad),
                           float (*)(const float*, int, int, float, const float*, float*)>::value,
              "{functor}: value_grad must be a static __device__ function "
              "float(const float*, int, int, float, const float*, float*)");
}}  // namespace ptmc_user

{macro}({functor}, ptmc::WidePerChain<ptmc_user::{struct}>)
"""


def libraries(functor):
    """The names of ``functor``'s libraries, one a kernel."""
    return tuple(library_name(kernel, functor) for kernel in KERNELS)


def prepare(model, device):
    """Build and load the libraries of ``model``'s functor if it is a
    registered one, and check its constants on ``device``: before a CUDA
    graph captures a step, so that no ``nvcc`` runs and no library loads
    under capture or in a timed loop. Returns the functor's build logs
    (``{library: nvcc output}``, empty when built before). A missing
    ``nvcc`` or a failed build raises, naming the functor."""
    functor = getattr(model, "cuda_functor", None)
    if functor not in REGISTERED:
        return {}
    names = libraries(functor)
    try:
        logs = build.build(names)
    except RuntimeError as e:
        raise RuntimeError(f"user functor {functor!r}: {e}") from e
    for name in names:
        build.load(name)
    common.cuda_params("user functor", model, functor, device)
    return logs
