"""The native chain-row formatter: ``ctypes`` bindings to
``ptmcmcsampler_torch/csrc/chainio.cpp``, the port's copy of the JAX
package's C++ formatter.

The library is built with the host C++ compiler at first use, into
``ptmcmcsampler_torch/_build/``, named by a hash of its source and flags as
``ops/build.py`` names the kernels. Several processes may build it at once
(test workers, the ranks of a multi-process run): each compiles into a
temporary name of its own and renames it into place, so a process loads
either nothing or a whole library. There is no fallback: a missing compiler
or a failed build raises, and a buffer too small for the rows is grown and
the rows formatted again.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import uuid

import numpy as np

from ..ops.build import BUILD_DIR, CSRC

SOURCE = CSRC / "chainio.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lib = None


def compiler():
    """The host C++ compiler (``$CXX``, else ``g++``, else ``c++``)."""
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (g++ or c++) found: the native chain-row "
                       "formatter (csrc/chainio.cpp) cannot be built")


def library_path():
    """Where the library is built: named by a hash of its source and flags."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + SOURCE.read_bytes())
    return BUILD_DIR / f"libchainio-{digest.hexdigest()[:16]}.so"


def build():
    """Build the library unless it is built; returns its path."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp")
    cmd = [compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native chain-row formatter failed:\n{proc.stdout}")
    os.replace(tmp, lib)
    return lib


def load():
    """The ``ctypes`` handle of the library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.ptmcmc_format_rows
        fn.restype = ctypes.c_longlong
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong]
        _lib = lib
    return _lib


def _int_digits(a):
    """An upper bound on the integer digits ``%f`` prints for the finite
    values of ``a`` (one more than the largest one's, for the rounding of
    9.99... up to 10)."""
    finite = a[np.isfinite(a)]
    top = float(np.max(np.abs(finite))) if finite.size else 0.0
    return len(str(int(top))) + 1


def capacity(params, tail):
    """Bytes that always hold the rows: each ``%22.22f`` column at most its
    sign, integer digits, point and 22 decimals (22 characters at least),
    each ``%f`` its sign, digits, point and 6 decimals, the tabs, the
    newline, and the terminating NUL."""
    n, ndim = params.shape
    wide = 1 + max(22, 1 + _int_digits(params) + 1 + 22)
    narrow = 1 + max(3, 1 + _int_digits(tail) + 1 + 6)
    return n * (ndim * wide + 4 * narrow + 1) + 1


def format_rows(params, lnprob, lnlike, accept_rate, pt_accept_rate, cap=None):
    """The rows' text, as ``io.chainfile.format_rows_plain`` writes it.
    ``cap``: the first buffer's size (by default :func:`capacity`); a buffer
    the rows do not fit is grown to :func:`capacity` and they are
    formatted again."""
    fn = load().ptmcmc_format_rows
    params = np.ascontiguousarray(params, dtype=np.float64)
    n, ndim = params.shape
    cols = [np.ascontiguousarray(np.broadcast_to(np.asarray(a, np.float64), (n,)))
            for a in (lnprob, lnlike, accept_rate, pt_accept_rate)]

    need = capacity(params, np.concatenate(cols))
    for size in ((need,) if cap is None else (int(cap), need)):
        buf = np.empty(size, np.uint8)
        written = fn(params.ctypes.data, *(a.ctypes.data for a in cols), n, ndim,
                     buf.ctypes.data, size)
        if written >= 0:
            return buf[:written].tobytes().decode("ascii")
    raise RuntimeError(f"the native chain-row formatter did not fit {n} rows of {ndim} "
                       f"columns in {need} bytes")
