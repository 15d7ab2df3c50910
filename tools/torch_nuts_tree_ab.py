#!/usr/bin/env python3
"""Time this checkout's NUTS tree kernel against the one it replaced, which
read its reservoir uniforms from a pre-drawn array, on the same inputs, on
one CUDA card.

Usage, from the root of this checkout on a machine with a card and nvcc::

    python3 tools/torch_nuts_tree_ab.py --other PATH_TO_OTHER_CHECKOUT

The other checkout's ``ptmcmcsampler_torch/csrc/nuts_tree.cu`` must have the
array interface (``resu``, ``[2**depth - 1, T, C]`` f32, in place of the
key). It is compiled with this checkout's nvcc flags (``ops/build.py``) into
a temporary directory and bound with ctypes. Both kernels get the same
inputs, at the main path's shape (8 x 16384 chains, D = 2, depth cap 10):
chains around both modes of the curved target (``chip_smoke.py``
``trajectory_inputs``), and the reservoir uniforms of one key, materialised
once for the other kernel (outside its timing), so the outputs are compared
bitwise. Cases, each timed by CUDA events with the stream held, in turns
(this, other, other, this):

* ``adapted``: per-rung step sizes like path 2's adapted ones, so trees of
  the path's sizes;
* ``capped_batch``: every tree run to the cap (step size ``CAPPED_EPS``)
  over the whole batch: the time of a leaf level when every chain is busy;
* ``capped_warp``: the same for one warp alone (T = 1, C = 32): the
  latency of one thread's leaf.

Prints the card's name and power limit, then one JSON line a case.
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
from ptmcmcsampler_torch.models import CurvedLikelihood  # noqa: E402
from ptmcmcsampler_torch.ops import build  # noqa: E402
from ptmcmcsampler_torch.ops.nuts import nuts_trees, nuts_uniforms  # noqa: E402
from ptmcmcsampler_torch.proposals.nuts import draw_nuts  # noqa: E402

ADAPTED_EPS = (0.165, 0.241, 0.342, 0.477, 0.679, 0.994, 1.531, 2.472)
REPS = {"adapted": 20, "capped_batch": 3, "capped_warp": 10}


def other_kernel(checkout, tmp):
    """The other checkout's kernel as ``prepare(inputs) -> run``, where
    ``run()`` launches it and returns its outputs (the uniforms are
    materialised once, in ``prepare``), and its ptxas lines."""
    src = Path(checkout) / "ptmcmcsampler_torch" / "csrc" / "nuts_tree.cu"
    lib = Path(tmp) / "libnuts_tree_other.so"
    out = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         check=True).stdout
    regs = [line.split(":", 1)[-1].strip() for line in out.splitlines()
            if "registers" in line or "spill" in line]
    fn = ctypes.CDLL(str(lib)).nuts_tree_curved
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

    def prepare(inp):
        q0, r0, beta, eps, expo, dirs, accu, key, chol = inp
        t, _, c = q0.shape
        q_prop = torch.empty_like(q0)
        stats = torch.empty((5, t, c), device=q0.device)
        resu = nuts_uniforms(key, dirs.shape[0], t, c)
        args = (q0, r0, beta, eps, expo, dirs, accu, resu, chol, q_prop, *stats.unbind(0))
        ptrs = [a.data_ptr() for a in args]

        def run():
            err = fn(*ptrs, t, c, dirs.shape[0], torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"other kernel launch failed: CUDA error {err}")
            return (q_prop, *stats.unbind(0))

        run.keep = args  # the buffers stay alive while run may launch
        return run

    return prepare, regs


def cases(dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    q0, _, betas, _, _, chol = cs.trajectory_inputs(gen, dev, 1)
    adapted = torch.tensor(ADAPTED_EPS, device=dev)[:, None].expand(cs.T, cs.C)
    for name, t, c, eps in (("adapted", cs.T, cs.C, adapted),
                            ("capped_batch", cs.T, cs.C, cs.CAPPED_EPS),
                            ("capped_warp", 1, 32, cs.CAPPED_EPS)):
        r0, expo, dirs, accu, key, _ = draw_nuts(gen, t, cs.D, c, cs.NUTS_DEPTH, dev)
        eps_t = (eps[:t, :c] if torch.is_tensor(eps)
                 else torch.full((t, c), eps, device=dev)).contiguous()
        yield name, (q0[:t, :, :c].contiguous(), r0, betas[:t].contiguous(), eps_t, expo, dirs,
                     accu, key, chol)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", required=True, help="root of the other checkout")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_nuts_tree_ab: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    model = CurvedLikelihood()
    print(cs.card_line(), flush=True)
    build.build(("nuts_tree",))
    with tempfile.TemporaryDirectory() as tmp:
        prepare, regs = other_kernel(args.other, tmp)
        print(json.dumps({"other": args.other, "other_ptxas": regs}), flush=True)
        for name, inp in cases(dev):
            def this():
                return nuts_trees(*inp, model)[:6]  # all but the step size used

            that = prepare(inp)

            mine, theirs = this(), that()
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(mine, theirs))
            times = {"this": [], "other": []}
            for who, fn in (("this", this), ("other", that), ("other", that), ("this", this)):
                times[who].append(cs.cuda_ms(fn, REPS[name], hold_stream=True))
            leaves = float(mine[4].max())
            print(json.dumps({
                "case": name, "outputs_equal": equal, "max_nalpha": leaves,
                "mean_nalpha": float(mine[4].mean()), "alive_share": float(mine[5].mean()),
                "this_ms": times["this"], "other_ms": times["other"],
                "this_us_per_leaf": [1e3 * m / leaves for m in times["this"]],
                "other_us_per_leaf": [1e3 * m / leaves for m in times["other"]],
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
