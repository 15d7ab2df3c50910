#!/usr/bin/env python3
"""One of ``chip_smoke.py``'s wide workloads alone, at any iteration counts,
on one CUDA card: how long bench.py's own counts take, which the script
cuts to fit its time limit.

Usage, from the root of a checkout on a machine with a card and nvcc::

    python3 tools/torch_wide_workload.py gaussian200 --burn 3000 --timed 500

Builds the kernels, holds the workload's wide ChEES entries to their plain
versions (``chip_smoke.phase_wide_vs_plain``), then runs path 1's cycle on
the workload at 8 x 16384 chains with ``--burn`` burn-in and ``--timed``
timed iterations (``chip_smoke.phase_wide_path``: the main-path JSON line
with its burn-in seconds, a profile line and the wide kernel's timings).
Prints the card's name and power limit, the seconds of each phase, and the
kernel item as one JSON line.
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
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_wide_workload: no CUDA device is available", file=sys.stderr)
        return 1
    from ptmcmcsampler_torch.ops import build

    cs.WIDE_ITERS = {args.workload: (args.burn, args.timed)}
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.time()
    ptxas = cs.ptxas_info(build.build().get("chees_trajectory", ""))
    print(f"build s {time.time() - t0:.1f}", flush=True)
    t0 = time.time()
    err = cs.phase_wide_vs_plain(args.workload, cs.wide_workload(args.workload)[0])
    print(f"check s {time.time() - t0:.1f}", flush=True)
    t0 = time.time()
    item = cs.phase_wide_path(args.workload, card, err, ptxas)
    print(f"path s {time.time() - t0:.1f}", flush=True)
    print(json.dumps(item), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
