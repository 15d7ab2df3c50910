#!/usr/bin/env python3
"""One of ``chip_smoke.py``'s wide workloads alone, at any iteration counts,
on one CUDA card: how long bench.py's own counts take, which the script
cuts to fit its time limit.

Usage, from the root of a checkout on a machine with a card and nvcc::

    python3 tools/torch_wide_workload.py gaussian200 --burn 3000 --timed 500
    python3 tools/torch_wide_workload.py hierarchical --path nuts

Builds the kernels, holds the workload's wide kernels to their plain
versions, then runs one path's cycle on the workload at 8 x 16384 chains
with ``--burn`` burn-in and ``--timed`` timed iterations (bench.py's 3000
and 12000 by default). ``--path chees`` (the default) is path 1, the ChEES
entries (``chip_smoke.phase_wide_vs_plain``, ``phase_wide_path``); ``--path
nuts`` is path 2, bench.py's ``grad_mode=nuts`` cycle, the NUTS and HMC
entries (``chip_smoke.phase_wide_nuts_hmc_vs_plain``,
``phase_wide_nuts_path``). Each prints the main-path JSON line with its
burn-in seconds, a profile line and the wide kernels' timings. Prints the
card's name and power limit, the seconds of each phase, and each kernel
item as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workload", choices=sorted(cs.WIDE_ITERS))
    ap.add_argument("--burn", type=int, default=cs.BURN_ITERS)
    ap.add_argument("--timed", type=int, default=cs.TIMED_ITERS)
    ap.add_argument("--path", choices=("chees", "nuts"), default="chees")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_wide_workload: no CUDA device is available", file=sys.stderr)
        return 1
    from ptmcmcsampler_torch.ops import build

    iters = {args.workload: (args.burn, args.timed)}
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.time()
    logs = build.build()
    print(f"build s {time.time() - t0:.1f}", flush=True)
    model = cs.wide_workload(args.workload)[0]
    t0 = time.time()
    if args.path == "chees":
        cs.WIDE_ITERS = iters
        err = cs.phase_wide_vs_plain(args.workload, model)
    else:
        cs.WIDE_NUTS_ITERS = iters
        err = cs.phase_wide_nuts_hmc_vs_plain(args.workload, model)
    print(f"check s {time.time() - t0:.1f}", flush=True)
    t0 = time.time()
    if args.path == "chees":
        items = [cs.phase_wide_path(args.workload, card, err,
                                    cs.ptxas_info(logs.get("chees_trajectory", "")))]
    else:
        ptxas = {name: cs.ptxas_info(logs.get(name, ""))
                 for name in ("nuts_tree", "hmc_trajectory")}
        items = cs.phase_wide_nuts_path(args.workload, card, err, ptxas)
    print(f"path s {time.time() - t0:.1f}", flush=True)
    for item in items:
        print(json.dumps(item), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
