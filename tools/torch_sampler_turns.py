#!/usr/bin/env python3
"""Separate what ``PTSampler.sample`` adds to path 1's step from the host
slowing down within one process, on one CUDA card.

Usage, from the root of a checkout on a machine with a card and nvcc::

    python3 tools/torch_sampler_turns.py [--iters 1000] [--turns 2]

In one process:

1. ``run_block`` on path 1's configuration (``chip_smoke.py``
   ``headline_config``) from a fresh state, 3000 iterations to warm up,
   then ``--turns`` turns of ``--iters`` iterations, a device sync at the
   end of each.
2. ``PTSampler.sample`` on path 1's workload as ``chip_smoke.py``'s
   sampler phase runs it (8 x 16384 chains, the bound methods of
   ``CurvedLikelihood``, 15000 iterations, thin 10, files and a checkpoint
   a block into a temporary directory): iterations/s of its wall and
   between its drains (each drain and checkpoint timed after a device sync).
3. From the sampler's final state, in turns: path 1's configuration (a
   row every iteration) and the sampler's (a row every 10th).

If ``sample()`` runs near the turns next to it, its files add little; a
gap between the turns before and after is the host's drift.

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from ptmcmcsampler_torch import build_step, init_state  # noqa: E402
from ptmcmcsampler_torch.ladder import ladder_betas, temperature_ladder  # noqa: E402
from ptmcmcsampler_torch.models import CurvedLikelihood  # noqa: E402
from ptmcmcsampler_torch.ops import build  # noqa: E402


def turns(runners, state, iters, n):
    """``n`` rounds of each runner for ``iters`` iterations from ``state``;
    iterations/s of each turn, and the state after the last."""
    out = {name: [] for name in runners}
    for _ in range(n):
        for name, (run_block, thin) in runners.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = run_block(state, iters // thin)
            torch.cuda.synchronize()
            out[name].append(iters / (time.perf_counter() - t0))
    return out, state


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_sampler_turns: no CUDA device is available", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card, flush=True)
    build.build()
    dev = torch.device(cs.DEVICE)
    model = CurvedLikelihood()

    path1 = cs.headline_config()
    x0 = np.array([-0.1, -0.5])
    xs = torch.tensor(x0, dtype=torch.float32, device=dev)[None, :, None]
    xs = xs.expand(cs.T, cs.D, cs.C)
    _, betas = ladder_betas(temperature_ladder(cs.D, cs.T))
    state = init_state(path1, 7, x0, np.eye(cs.D), betas, model.lnlike(xs), model.lnprior(xs),
                       device=dev)
    path1_run = build_step(path1, model, device=dev)[1]
    for _ in range(cs.BURN_ITERS // cs.BLOCK):
        state, _ = path1_run(state, cs.BLOCK)
    before, state = turns({"path1_thin1": (path1_run, 1)}, state, args.iters, args.turns)
    del state

    root = tempfile.mkdtemp(prefix="sampler_turns_")
    try:
        with contextlib.redirect_stdout(sys.stderr):
            s = cs.curved_sampler(model, str(Path(root) / "chains"), seed=7)
            seconds = {}
            cs.time_drains(s, seconds)
            t0 = time.perf_counter()
            s.sample(x0.tolist(), cs.SAMPLER_ITERS, **cs.SAMPLER_KW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        runners = {"path1_thin1": (path1_run, 1),
                   "sampler_thin10": (build_step(s.config, model, device=dev)[1],
                                      s.config.thin)}
        after, _ = turns(runners, s.state, args.iters, args.turns)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    drains = sum(seconds["_drain_block"]) + sum(seconds["_save_checkpoint"])
    name, power = [v.strip() for v in card.split(",", 1)]
    print(json.dumps({
        "tool": "torch_sampler_turns",
        "iters_per_turn": args.iters,
        "path1_turns_before_sampler": before["path1_thin1"],
        "sampler_iters_per_sec": cs.SAMPLER_ITERS / wall,
        "sampler_iters_per_sec_between_drains": cs.SAMPLER_ITERS / (wall - drains),
        "turns_after_sampler": after,
        "card": name,
        "power_limit": power,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
