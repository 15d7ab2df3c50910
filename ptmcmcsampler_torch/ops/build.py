"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface. It is compiled
with ``nvcc`` for ``sm_90a`` into a shared library under
``ptmcmcsampler_torch/_build/``, named by a hash of its source, of every
header it includes from ``csrc/`` (``models.cuh``, shared by all kernels,
and the kernel's own ``*_kernels.cuh``) and of the flags, at first use, and
loaded with ``ctypes``. A registered user functor's libraries
(``ops/user.py``) are translation units generated as text
(``GENERATED``): each is written into ``_build/`` beside its library and
compiled with ``csrc/`` on the include path, under the same key. No PyTorch
headers are included, so a build takes seconds. A missing ``nvcc`` or a
failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
SOURCES = ("chees_trajectory", "hmc_trajectory", "nuts_tree", "nuts_general")
# --fmad=false: no contraction of a*b+c into one FMA, so a kernel rounds each
# operation as PyTorch's one-operation-per-launch plain versions do and can
# be held to them pointwise (FMA rounding differences grow exponentially
# along chaotic trajectories).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Library name -> the text of a generated translation unit (ops/user.py).
GENERATED: dict = {}
_loaded: dict = {}


def nvcc_path():
    found = shutil.which("nvcc")
    if found is None and os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def _source_text(name, csrc):
    """The translation unit of library ``name``: generated, or ``csrc/<name>.cu``."""
    if name in GENERATED:
        return GENERATED[name].encode()
    return (csrc / f"{name}.cu").read_bytes()


def _headers(text, csrc, seen):
    """Every header that ``text`` includes from ``csrc``, recursively."""
    for inc in _LOCAL_INCLUDE.findall(text):
        header = csrc / inc.decode()
        if header.exists() and header not in seen:
            seen.append(header)
            _headers(header.read_bytes(), csrc, seen)


def library_path(name, csrc=CSRC):
    """Where library ``name`` is built: named by a hash of its translation
    unit, the headers it includes from ``csrc`` and the flags."""
    text = _source_text(name, csrc)
    headers = []
    _headers(text, csrc, headers)
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(f"{name}.cu".encode() + b"\0" + text)
    for f in headers:
        digest.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES):
    """Build every library in ``names`` that is not built yet, one ``nvcc``
    per source, all started together. Returns ``{name: compiler output}``."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        lib = library_path(name)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        if name in GENERATED:
            source = lib.with_suffix(".cu")
            source.write_text(GENERATED[name])
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(source)]
        else:
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))
        else:
            failed.append(name)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name):
    """The ``ctypes`` handle of library ``name``, built on first use."""
    if name not in _loaded:
        build((name,))
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
