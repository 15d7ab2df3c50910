#!/usr/bin/env python3
"""Time the NUTS kernel's default entries and the fused HMC step of this
checkout against another checkout's on the same inputs, on one CUDA card,
and beside them the general NUTS entry (``csrc/nuts_general.cu``) on those
inputs.

Usage, from the root of this checkout on a machine with a card and nvcc::

    python3 tools/torch_nuts_default_ab.py --other PATH_TO_OTHER_CHECKOUT

The other checkout's ``ptmcmcsampler_torch/csrc/nuts_tree.cu`` and
``hmc_trajectory.cu`` (with the same C interface: the reservoir's Philox
key, the structure argument of the wide entries; a checkout from before the
counter arguments ``n_base`` and ``c_total``, which the calls then leave
out, is told by its source) are compiled with this checkout's nvcc flags
(``ops/build.py``) into a temporary directory, beside this checkout's own
build, and ``ops/nuts.py``'s and ``ops/hmc.py``'s wrappers launch each
library in turn (its library handle swapped), so both get the same
arguments (this checkout's with ``n0 = 0``, ``c_total = C``: an unsharded
call). Cases, at the main path's 8 x 16384 chains and depth cap 10: the
curved target with per-rung step sizes like path 2's adapted ones
(``adapted``) and with every tree run to the cap (``capped``), the 50-D
hierarchy on ``chip_smoke.wide_tree_inputs`` (``hierarchical``), and the
fused HMC step on path 2's curved inputs (``hmc_curved``) and the 50-D
hierarchy (``hmc_hierarchical``). Each is timed by CUDA events with the
stream held, in turns (other, this, this, other); the outputs must be
equal bit for bit. Prints the card's name and power limit, then one JSON
line a case, and exits 1 if an output differs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from ptmcmcsampler_torch.models import CurvedLikelihood, HierarchicalGaussian  # noqa: E402
from ptmcmcsampler_torch.ops import build  # noqa: E402
from ptmcmcsampler_torch.ops.hmc import hmc_step  # noqa: E402
from ptmcmcsampler_torch.ops.nuts import nuts_trees  # noqa: E402
from ptmcmcsampler_torch.proposals.nuts import draw_nuts  # noqa: E402

ADAPTED_EPS = (0.165, 0.241, 0.342, 0.477, 0.679, 0.994, 1.531, 2.472)
REPS = {"adapted": 20, "capped": 3, "hierarchical": 10, "hmc_curved": 50,
        "hmc_hierarchical": 20}
# The entries whose C interface gained the counter arguments (n_base, c_total)
# before the stream.
COUNTED = ("nuts_tree_", "hmc_step_", "hmc_draws_")


class OldInterface:
    """A library of a checkout from before the counter arguments: its
    counted entries called with this checkout's arguments less those two
    (which an unsharded call passes as 0 and C)."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, symbol):
        fn = getattr(self._lib, symbol)
        if not symbol.startswith(COUNTED):
            return fn

        class Call:
            argtypes = None

            def __call__(self, *args):
                if fn.argtypes is None:
                    fn.restype = ctypes.c_int
                    fn.argtypes = self.argtypes[:-3] + self.argtypes[-1:]
                return fn(*args[:-3], args[-1])

        call = Call()
        setattr(self, symbol, call)
        return call


def cases(dev):
    """``{case: (args, model)}``: nuts_trees' arguments but the model."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    t, c, depth = cs.T, cs.C, 10
    q0, _, betas, _, _, chol = cs.trajectory_inputs(gen, dev, 1)
    r0, expo, dirs, accu, key, _ = draw_nuts(gen, t, 2, c, depth, dev)
    adapted = torch.tensor(ADAPTED_EPS, device=dev)[:, None].expand(t, c).contiguous()
    capped = torch.full((t, c), cs.CAPPED_EPS, device=dev)
    out = {name: ((q0, r0, betas, eps, expo, dirs, accu, key, chol), CurvedLikelihood())
           for name, eps in (("adapted", adapted), ("capped", capped))}
    model = HierarchicalGaussian()
    args, _ = cs.wide_tree_inputs(gen, dev, model, c, depth)
    args = list(args)
    args[3] = args[3].abs().clamp(min=1e-3).contiguous()
    out["hierarchical"] = (tuple(args), model)
    gen.manual_seed(16)
    x = cs.hmc_step_inputs(gen, dev)
    out["hmc_curved"] = (x, CurvedLikelihood())
    # The hierarchy's NUTS inputs: its whitened positions taken as positions.
    chol = args[8]
    key = torch.randint(0, 2**32, (2,), generator=gen, device=dev, dtype=torch.int64)
    out["hmc_hierarchical"] = ((args[0], args[2], key, chol,
                                torch.linalg.inv(chol).contiguous()), model)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    sources = ("nuts_tree", "hmc_trajectory")
    build.build(sources + ("nuts_general",))
    libs = {"this": {name: build.load(name) for name in sources}, "other": {}}
    with tempfile.TemporaryDirectory(prefix="nuts_default_ab_") as tmp:
        for name in sources:
            so = Path(tmp) / f"lib{name}_other.so"
            src = Path(args.other).resolve() / "ptmcmcsampler_torch" / "csrc" / f"{name}.cu"
            subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(src)],
                           check=True, capture_output=True, text=True, timeout=900)
            lib = ctypes.CDLL(str(so))
            libs["other"][name] = lib if "n_base" in src.read_text() else OldInterface(lib)
        failed = False

        def run(which, a, model, general=False):
            build._loaded.update(libs[which])
            try:
                if len(a) == 5:  # the fused HMC step
                    return hmc_step(a[0], a[1], a[2], a[3], a[4], cs.HMC_EPS, cs.HMC_NMIN,
                                    cs.HMC_NMAX, model)
                return nuts_trees(*a, model, general=general)
            finally:
                build._loaded.update(libs["this"])

        for name, (a, model) in cases(dev).items():
            nuts = len(a) != 5
            outs = {w: run(w, a, model) for w in ("other", "this")}
            pairs = [(outs["other"], outs["this"])]
            if nuts:
                gen_out = run("this", a, model, general=True)
                pairs.append((outs["this"], gen_out))
            equal = all(cs.lanes_differ(x, y) == 0 for x, y in pairs)
            ms = {}
            for which in ("other", "this", "this", "other"):
                ms.setdefault(which, []).append(cs.cuda_ms(lambda: run(which, a, model),
                                                           REPS[name], hold_stream=True))
            other, this = (sum(ms[w]) / 2 for w in ("other", "this"))
            line = {"case": name, "model": type(model).__name__, "chains": [cs.T, cs.C],
                    "other_ms": ms["other"], "this_ms": ms["this"],
                    "ratio_this_over_other": this / other, "bitwise_equal": equal}
            if nuts:
                general_ms = cs.cuda_ms(lambda: run("this", a, model, general=True),
                                        REPS[name], hold_stream=True)
                line.update(depth=10, general_ms=general_ms,
                            general_over_default=general_ms / this,
                            mean_nalpha=float(outs["this"][4].mean()),
                            max_nalpha=float(outs["this"][4].max()))
            print(json.dumps(line), flush=True)
            failed |= not equal
    print(json.dumps({"ok": not failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
