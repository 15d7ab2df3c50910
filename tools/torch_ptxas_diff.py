#!/usr/bin/env python3
"""Check that this checkout's built-in kernels compile to what another
checkout's do: the same ptxas report and, where ``cuobjdump`` is found, the
same SASS, kernel by kernel.

Usage, from the root of this checkout on a machine with nvcc::

    python3 tools/torch_ptxas_diff.py --other PATH_TO_OTHER_CHECKOUT

Each ``csrc/<source>.cu`` that both checkouts have (``build.SOURCES``), of
both checkouts, is compiled with this checkout's nvcc flags
(``ops/build.py``) into a temporary directory, all ``nvcc`` at once. For every kernel
instantiation it compares the ``-Xptxas -v`` lines (registers, stack frame,
spill stores and loads, static shared memory; ``chip_smoke.ptxas_info``)
and the SASS that ``cuobjdump -sass`` prints for it. A control build, the
other checkout's sources again with a comment appended to each file, shows
what a change of the file alone does: the mangled names of the kernels in
the anonymous namespace carry a hash of the file's contents, and ptxas
may schedule a kernel differently under another name. Prints one JSON
line a source with both reports, the kernels whose ptxas lines differ, and
for the SASS the kernels that differ from the other build and from the
control, each with its count of differing lines and whether the two hold
the same instructions in another order. Exits 1 if a ptxas line differs,
or if a source's SASS differs from the other build's while its control
build's does not differ at all (then the difference is the code's, not
the names'). Needs no card.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from ptmcmcsampler_torch.ops import build  # noqa: E402


def cuobjdump_path():
    found = shutil.which("cuobjdump")
    if found is None and Path("/usr/local/cuda/bin/cuobjdump").exists():
        found = "/usr/local/cuda/bin/cuobjdump"
    return found


_ANON = re.compile(r"(_GLOBAL__N__)[0-9a-f]{8}(_\d+_\w+?_cu_)[0-9a-f]{8}")


def sass(lib, cuobjdump):
    """``{mangled kernel name: its SASS lines}`` of a library."""
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=600).stdout
    # The anonymous namespace's mangled name carries a hash of the file's
    # contents; the same code in an edited file differs only there.
    text = _ANON.sub(r"\1\2", text)
    out = {}
    for block in text.split("Function : ")[1:]:
        name, body = block.split("\n", 1)
        # Each instruction's line without its address comment.
        out[name.strip()] = [re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip()
                             for line in body.splitlines() if line.strip()]
    return out


def differences(a, b):
    """The kernels whose SASS differs between two builds: for each, the
    lines that differ, whether the same instructions stand in another
    order, and the first pair of differing lines."""
    out = {}
    for k in sorted(set(a) | set(b)):
        x, y = a.get(k, []), b.get(k, [])
        if x == y:
            continue
        pairs = [(i, p, q) for i, (p, q) in enumerate(zip(x, y)) if p != q]
        first = pairs[0] if pairs else (min(len(x), len(y)), None, None)
        out[k] = {"lines": [len(x), len(y)], "differing_lines": len(pairs) + abs(len(x) - len(y)),
                  "same_instructions_reordered": sorted(x) == sorted(y),
                  "first": {"line": first[0], "a": first[1], "b": first[2]}}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    args = ap.parse_args()
    other_csrc = Path(args.other).resolve() / "ptmcmcsampler_torch" / "csrc"
    cuobjdump = cuobjdump_path()
    nvcc = build.nvcc_path()
    failed = False
    sources = [n for n in build.SOURCES if (other_csrc / f"{n}.cu").exists()]
    with tempfile.TemporaryDirectory(prefix="ptxas_diff_") as tmp:
        control = Path(tmp) / "control"
        shutil.copytree(other_csrc, control)
        for name in sources:
            src = control / f"{name}.cu"
            src.write_text(src.read_text() + "\n// control\n")
        procs = {}
        for which, csrc in (("this", build.CSRC), ("other", other_csrc), ("control", control)):
            for name in sources:
                lib = Path(tmp) / f"lib{name}-{which}.so"
                cmd = [nvcc, *build.NVCC_FLAGS, "-o", str(lib), str(csrc / f"{name}.cu")]
                procs[which, name] = (lib, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        reports, codes = {}, {}
        for key, (lib, proc) in procs.items():
            log = proc.communicate()[0]
            if proc.returncode:
                raise SystemExit(f"nvcc failed for {key}:\n{log}")
            reports[key] = cs.ptxas_info(log)
            codes[key] = sass(lib, cuobjdump) if cuobjdump else None
        for name in sources:
            this, other = reports["this", name], reports["other", name]
            ptxas_differ = sorted(k for k in set(this) | set(other)
                                  if this.get(k) != other.get(k))
            line = {"source": name, "kernels": len(this), "ptxas_differ": ptxas_differ,
                    "this": this, "other": other}
            unexplained = []
            if cuobjdump:
                a, b, c = (codes[w, name] for w in ("this", "other", "control"))
                line.update(sass_kernels=len(a), sass_instructions=sum(map(len, a.values())),
                            sass_differ=differences(a, b),
                            sass_differ_control=differences(c, b))
                # Decisive only where a change of the file alone changes nothing.
                unexplained = [] if line["sass_differ_control"] else sorted(line["sass_differ"])
                line["sass_differ_unexplained"] = unexplained
            else:
                line["sass_differ"] = "not compared (no cuobjdump)"
            failed |= bool(ptxas_differ or unexplained)
            print(json.dumps(line), flush=True)
    print(json.dumps({"ok": not failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
