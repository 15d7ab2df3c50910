#!/usr/bin/env python3
"""Time this checkout's wide kernels against another checkout's whose wide
entries take the same arguments, on the same inputs, on one CUDA card, and
check that their outputs are equal bit for bit: that a change of the wide
layout (groups of 8 and 4 chains past D = 256, two tile stages past 788-D)
leaves the entries at D <= 256 as they were.

Usage, from the root of this checkout on a machine with a card and nvcc::

    python3 tools/torch_layout_ab.py --other PATH_TO_OTHER_CHECKOUT [--burn N]

The other checkout is any version of the port whose wide entries take the
structure argument (735f1ff and later; ``tools/torch_wide_ab.py`` compares
with the entries before it). Its ``csrc/*.cu`` are compiled with this
checkout's nvcc flags into a temporary directory, this checkout's as the
package builds them, all six ``nvcc`` at once; both builds' ptxas lines
are printed. The cases are ``tools/torch_wide_ab.py``'s: on the final
states of ``--burn`` iterations of path 1 and of path 2 on bench.py's
``gaussian`` (40-D), ``hierarchical`` (50-D) and ``gaussian200`` (200-D)
at 8 x 16384 chains, ``chees_step`` and ``chees_trajectory`` (the path's
identity factor, every chain at the longest length, a dense factor),
``nuts_tree`` at depth 10 (identity, dense, every tree to the cap) and
``hmc_step`` (identity, dense). Each time is CUDA events with the stream
held, in turns (this, other, other, this). Prints the card's name and power
limit, the ptxas lines, then one JSON line a case with both times, the
ratio, and the lanes whose outputs differ in any bit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

TOOLS = Path(__file__).resolve().parent
sys.path.insert(0, str(TOOLS))

import torch_wide_ab as ab  # noqa: E402

cs = ab.cs


def compare_workload(name, builds, burn):
    """Every case of the wide workload ``name`` on both builds, as
    ``tools/torch_wide_ab.py`` runs them."""
    dev = torch.device("cuda:0")
    model, x0 = cs.wide_workload(name)
    d, functor = model.ndim, model.cuda_functor
    prm = model.cuda_params(dev)
    reps = ab.REPS[name]
    # Path 1's final state: the ChEES cases.
    cfg = cs.wide_config(d, burn)
    state = ab.run_path(f"{name} path 1", cfg, model, x0, burn, dev)
    gen = torch.Generator(device=dev).manual_seed(99)
    ss = state.stepsize
    eps, tlen = ss.chees_eps.contiguous(), ss.chees_tlen.contiguous()
    u = torch.rand((cs.T, cs.C), generator=gen, device=dev) * (1.0 - 1e-3) + 1e-3
    r0 = torch.randn((cs.T, d, cs.C), generator=gen, device=dev)
    eps_tc, nsteps = cs.step_lengths(u, eps, tlen, cs.HMC_EPS, cfg.chees_max_steps)
    longest = int(nsteps.max())
    for case in ("identity", "capped", "dense"):
        chol, chol_inv, st = ab.factors(model, "identity" if case == "capped" else case, state,
                                        dev)
        ins = (state.x, r0, u, state.betas, eps, tlen, chol, chol_inv, prm)
        label = {"workload": name, "kernel": "chees_step", "case": case, "structure": st}
        if case != "capped":
            ab.compare(label, builds, lambda k: k.chees_step(
                functor, ins, cs.HMC_EPS, cfg.chees_max_steps, st), reps,
                {"mean_nsteps": float(nsteps.float().mean()), "max_nsteps": longest})
        q0 = ab.common.matvec(chol_inv.T, state.x, st).contiguous()
        steps = torch.full_like(nsteps, longest) if case == "capped" else nsteps
        tins = (q0, r0, state.betas, eps_tc, steps, chol, prm)
        ab.compare(dict(label, kernel="chees_trajectory"), builds,
                   lambda k: k.chees_trajectory(functor, tins, st), reps,
                   {"max_nsteps": longest, "mean_nsteps": float(steps.float().mean())})
    del state, r0, u, q0, tins, ins
    torch.cuda.empty_cache()
    # Path 2's final state: the NUTS and HMC cases.
    cfg = cs.wide_nuts_config(d, burn)
    state = ab.run_path(f"{name} path 2", cfg, model, x0, burn, dev)
    r0n, expo, dirs, accu, key, r_eps = ab.draw_nuts(gen, cs.T, d, cs.C, cs.NUTS_DEPTH, dev)
    eps_n = state.stepsize.epsilon.contiguous()
    for case in ("identity", "dense", "capped"):
        chol, chol_inv, st = ab.factors(model, "identity" if case == "capped" else case, state,
                                        dev)
        if case == "capped":
            xc = torch.tensor(x0, dtype=torch.float32, device=dev)[None, :, None]
            q0 = (chol_inv.T @ xc).expand(cs.T, d, cs.C).contiguous()
            e = torch.full((cs.T, cs.C), cs.WIDE_CAPPED_EPS, device=dev)
        else:
            q0 = ab.common.matvec(chol_inv.T, state.x, st).contiguous()
            e = eps_n
        nins = (q0, r0n, state.betas, e, r_eps, expo, dirs, accu, key, chol, prm)
        ab.compare({"workload": name, "kernel": "nuts_tree", "case": case, "structure": st},
                   builds, lambda k: k.nuts_tree(functor, nins, cs.NUTS_DEPTH, st),
                   1 if case == "capped" else ab.NUTS_REPS[name])
        if case == "capped":
            continue
        hkey = torch.randint(0, 2**32, (2,), generator=gen, device=dev, dtype=torch.int64)
        hins = (state.x, state.betas, hkey, chol, chol_inv, prm)
        ab.compare({"workload": name, "kernel": "hmc_step", "case": case, "structure": st},
                   builds, lambda k: k.hmc_step(functor, hins, cs.HMC_EPS, cs.HMC_NMIN,
                                                cs.HMC_NMAX, st), reps)
    del state, nins, q0
    torch.cuda.empty_cache()


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", required=True, help="root of the other checkout")
    parser.add_argument("--burn", type=int, default=300, help="iterations of each path")
    parser.add_argument("--workloads", default="gaussian,hierarchical,gaussian200")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_layout_ab: no CUDA device is available", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        procs = ab.start_build(Path(args.other) / "ptmcmcsampler_torch" / "csrc", tmp)
        logs = ab.build.build()
        this_ptxas = {}
        for log in logs.values():
            this_ptxas.update(ab.wide_ptxas(log))
        this_libs = {name: ctypes.CDLL(str(ab.build.library_path(name)))
                     for name in ab.SOURCES}
        other_libs, other_ptxas = ab.finish_build(procs)
        cs.log(f"both checkouts' three sources built in {time.time() - t0:.1f}s")
        print(json.dumps({"ptxas": {"this": this_ptxas or "not measured (built before)",
                                    "other": other_ptxas}}), flush=True)
        builds = {"this": ab.Kernels(this_libs, True), "other": ab.Kernels(other_libs, True)}
        for name in args.workloads.split(","):
            compare_workload(name, builds, args.burn)
    return 0


if __name__ == "__main__":
    sys.exit(main())
