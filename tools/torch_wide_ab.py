#!/usr/bin/env python3
"""Time this checkout's wide kernels against another checkout's on the same
inputs, on one CUDA card, and check that their outputs are equal bit for bit.

Usage, from the root of this checkout on a machine with a card and nvcc::

    python3 tools/torch_wide_ab.py --other PATH_TO_OTHER_CHECKOUT [--burn N]

The other checkout is a version of the port whose wide entries take no
structure argument (the wide layout of ab94cd0, before the factor's
structure tag): its ``csrc/*.cu`` are compiled with this checkout's nvcc
flags into a temporary directory and bound with ctypes, while this
checkout's are built as the package builds them (``ops/build.py``, which
the paths then reuse), all six ``nvcc`` at once. Both builds' ptxas
reports are printed.

For each of bench.py's wide workloads (``gaussian`` 40-D,
``hierarchical`` 50-D, ``gaussian200`` 200-D, at 8 x 16384 chains) it
runs path 1 (SCAM/AM/DE/ChEES) and path 2 (SCAM/AM/DE/NUTS/HMC) for
``--burn`` iterations from bench.py's start (``chip_smoke.py``'s
configurations, half of them burn-in), then times on the final states:

* ``chees_step`` and ``chees_trajectory`` on path 1's adapted step sizes
  and lengths: ``identity`` (the path's factor, tag "diagonal"),
  ``capped`` (every chain at the largest length), ``dense``
  (``chip_smoke.wide_inputs``' mixed factor);
* ``nuts_tree`` on path 2's step sizes, depth 10: ``identity``, ``dense``
  and ``capped`` (every tree to the depth cap from bench.py's start at a
  step size of 1e-6);
* ``hmc_step`` at path 2's settings: ``identity`` and ``dense`` (the break
  test ends nearly every trajectory after one step, so there is no longer
  case).

Each time is CUDA events with the stream held, in turns (this, other,
other, this). Prints the card's name and
power limit, the ptxas lines, then one JSON line a case with both times,
the ratio, and the lanes whose outputs differ in any bit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from ptmcmcsampler_torch import build_step, init_state  # noqa: E402
from ptmcmcsampler_torch.ladder import ladder_betas, temperature_ladder  # noqa: E402
from ptmcmcsampler_torch.ops import build, common  # noqa: E402
from ptmcmcsampler_torch.ops.nuts import wide_scratch_floats  # noqa: E402
from ptmcmcsampler_torch.proposals.nuts import draw_nuts  # noqa: E402

SOURCES = ("chees_trajectory", "nuts_tree", "hmc_trajectory")
REPS = {"gaussian": 20, "hierarchical": 20, "gaussian200": 3}
NUTS_REPS = {"gaussian": 5, "hierarchical": 3, "gaussian200": 2}


def wide_ptxas(log):
    """The wide kernels' lines of a ptxas report."""
    return {k: v for k, v in cs.ptxas_info(log).items() if "Wide" in k}


def start_build(src_dir, out_dir):
    """Start building the three sources of ``src_dir`` into ``out_dir``, one
    nvcc each, all at once; ``finish_build`` waits for them."""
    procs = {}
    for name in SOURCES:
        lib = Path(out_dir) / f"lib{name}-other.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
               str(Path(src_dir) / f"{name}.cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    return procs


def finish_build(procs):
    """``{source: CDLL}`` and the ptxas report of ``start_build``'s builds."""
    libs, ptxas = {}, {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"other: nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
        ptxas.update(wide_ptxas(log))
    return libs, ptxas


class Kernels:
    """One build's wide entries with a uniform call: ``structured`` says
    whether they take the structure argument (this checkout) or not."""

    def __init__(self, libs, structured):
        self.libs, self.structured = libs, structured

    def _fn(self, source, symbol, n_ptr, mid=()):
        fn = getattr(self.libs[source], symbol)
        n_int = (4 if self.structured else 3) + (1 if symbol.startswith("nuts") else 0)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptr[0] + list(mid) + [ctypes.c_void_p] * n_ptr[1] \
            + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        return fn

    def _dims(self, structure, *dims):
        code = (common.STRUCTURES.index(structure),) if self.structured else ()
        return code + dims

    @staticmethod
    def _call(fn, *args):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{fn.__name__}: CUDA error {err}")

    def chees_step(self, functor, ins, eps0, max_steps, structure):
        """ins: x, r0, u, beta, eps, tlen, chol, chol_inv, prm."""
        t, d, c = ins[0].shape
        fn = self._fn("chees_trajectory", f"chees_step_{functor}", (9, 6),
                      (ctypes.c_float, ctypes.c_int))
        outs = [torch.empty_like(ins[0]) for _ in range(4)] + [
            torch.empty((t, c), device=ins[0].device) for _ in range(2)]
        ptrs = [a.data_ptr() for a in ins] + [float(eps0), int(max_steps)] + [
            a.data_ptr() for a in outs] + list(self._dims(structure, d, t, c))

        def run():
            self._call(fn, *ptrs)
            return outs

        return run

    def chees_trajectory(self, functor, ins, structure):
        """ins: q0, p0, beta, eps, nsteps, chol, prm."""
        t, d, c = ins[0].shape
        fn = self._fn("chees_trajectory", f"chees_trajectory_{functor}", (10, 0))
        outs = [torch.empty_like(ins[0]), torch.empty_like(ins[0]),
                torch.empty((t, c), device=ins[0].device)]
        ptrs = [a.data_ptr() for a in ins] + [a.data_ptr() for a in outs] + list(
            self._dims(structure, d, t, c))

        def run():
            self._call(fn, *ptrs)
            return outs

        return run

    def nuts_tree(self, functor, ins, depth, structure):
        """ins: q0, r0, beta, eps, r_eps, expo, dirs, accu, key, chol, prm."""
        t, d, c = ins[0].shape
        fn = self._fn("nuts_tree", f"nuts_tree_{functor}", (19, 0))
        scratch = torch.empty(wide_scratch_floats(d, depth) * t * c, device=ins[0].device)
        outs = [torch.empty_like(ins[0])] + [torch.empty((t, c), device=ins[0].device)
                                             for _ in range(6)]
        ptrs = [a.data_ptr() for a in ins] + [scratch.data_ptr()] + [
            a.data_ptr() for a in outs] + list(self._dims(structure, d, t, c, depth))

        def run():
            self._call(fn, *ptrs)
            return outs

        run.keep = scratch
        return run

    def hmc_step(self, functor, ins, eps, nmin, nmax, structure):
        """ins: x, beta, key, chol, chol_inv, prm."""
        t, d, c = ins[0].shape
        fn = self._fn("hmc_trajectory", f"hmc_step_{functor}", (6, 2),
                      (ctypes.c_float, ctypes.c_int, ctypes.c_int))
        outs = [torch.empty_like(ins[0]), torch.empty((t, c), device=ins[0].device)]
        ptrs = [a.data_ptr() for a in ins] + [float(eps), int(nmin), int(nmax)] + [
            a.data_ptr() for a in outs] + list(self._dims(structure, d, t, c))

        def run():
            self._call(fn, *ptrs)
            return outs

        return run


def run_path(name, cfg, model, x0, iters, dev):
    """``iters`` iterations of ``cfg`` from bench.py's start; the state."""
    step, _ = build_step(cfg, model, device=dev)
    d, t, c = cfg.ndim, cfg.ntemps, cfg.nchains
    xs = torch.tensor(x0, dtype=torch.float32, device=dev)[None, :, None].expand(t, d, c)
    state = init_state(cfg, 7, x0, torch.eye(d).numpy(), ladder_betas(temperature_ladder(d, t))[1],
                       model.lnlike(xs), model.lnprior(xs), device=dev)
    t0 = time.time()
    for _ in range(iters):
        state = step(state)
    torch.cuda.synchronize()
    cs.log(f"{name}: {iters} iterations in {time.time() - t0:.1f}s")
    return state


def factors(model, case, state, dev):
    """The path's own factor pair and tag for ``identity``; else
    wide_inputs' factor of the kind ``case`` and its tag."""
    if case == "identity":
        return state.adapt.chol, state.adapt.chol_inv, state.adapt.structure
    gen = torch.Generator(device=dev).manual_seed(77)
    *_, chol, chol_inv = cs.wide_inputs(gen, dev, model, 256, 1, factor=case)
    return chol, chol_inv, cs.FACTOR_TAGS[case]


def compare(label, builds, make, reps, extra=None):
    """Time ``make(kernels)``'s run for each build in turns, check outputs."""
    runs = {who: make(k) for who, k in builds.items()}
    outs = {who: [o.clone() for o in run()] for who, run in runs.items()}
    torch.cuda.synchronize()
    times = {who: [] for who in runs}
    for who in ("this", "other", "other", "this"):
        times[who].append(cs.cuda_ms(runs[who], reps, hold_stream=True))
    line = {**label, "lanes_differ": {who: cs.lanes_differ(outs[who], outs["this"])
                                      for who in outs if who != "this"},
            **{f"{who}_ms": v for who, v in times.items()},
            "this_over_other": sum(times["this"]) / sum(times["other"])}
    line.update(extra or {})
    print(json.dumps(line), flush=True)
    del runs, outs


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", required=True, help="root of the other checkout")
    parser.add_argument("--burn", type=int, default=300, help="iterations of each path")
    parser.add_argument("--workloads", default="gaussian,hierarchical,gaussian200")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_wide_ab: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    print(cs.card_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        procs = start_build(Path(args.other) / "ptmcmcsampler_torch" / "csrc", tmp)
        logs = build.build()
        this_ptxas = {}
        for log in logs.values():
            this_ptxas.update(wide_ptxas(log))
        # Handles of their own, so that the wrappers' argument types stay theirs.
        this_libs = {name: ctypes.CDLL(str(build.library_path(name))) for name in SOURCES}
        other_libs, other_ptxas = finish_build(procs)
        cs.log(f"both checkouts' three sources built in {time.time() - t0:.1f}s")
        print(json.dumps({"ptxas": {"this": this_ptxas or "not measured (built before)",
                                    "other": other_ptxas}}), flush=True)
        builds = {"this": Kernels(this_libs, True), "other": Kernels(other_libs, False)}
        for name in args.workloads.split(","):
            model, x0 = cs.wide_workload(name)
            d, functor = model.ndim, model.cuda_functor
            prm = model.cuda_params(dev)
            reps = REPS[name]
            # Path 1's final state: the ChEES cases.
            cfg = cs.wide_config(d, args.burn)
            state = run_path(f"{name} path 1", cfg, model, x0, args.burn, dev)
            gen = torch.Generator(device=dev).manual_seed(99)
            ss = state.stepsize
            eps = ss.chees_eps.contiguous()
            tlen = ss.chees_tlen.contiguous()
            u = torch.rand((cs.T, cs.C), generator=gen, device=dev) * (1.0 - 1e-3) + 1e-3
            r0 = torch.randn((cs.T, d, cs.C), generator=gen, device=dev)
            eps_tc, nsteps = cs.step_lengths(u, eps, tlen, cs.HMC_EPS, cfg.chees_max_steps)
            longest = int(nsteps.max())
            for case in ("identity", "capped", "dense"):
                chol, chol_inv, st = factors(model, "identity" if case == "capped" else case,
                                             state, dev)
                ins = (state.x, r0, u, state.betas, eps, tlen, chol, chol_inv, prm)
                label = {"workload": name, "kernel": "chees_step", "case": case,
                         "structure": st}
                if case != "capped":
                    compare(label, builds, lambda k: k.chees_step(
                        functor, ins, cs.HMC_EPS, cfg.chees_max_steps, st), reps,
                        {"mean_nsteps": float(nsteps.float().mean()), "max_nsteps": longest})
                q0 = common.matvec(chol_inv.T, state.x, st).contiguous()
                steps = torch.full_like(nsteps, longest) if case == "capped" else nsteps
                tins = (q0, r0, state.betas, eps_tc, steps, chol, prm)
                compare(dict(label, kernel="chees_trajectory"), builds,
                        lambda k: k.chees_trajectory(functor, tins, st), reps,
                        {"max_nsteps": longest, "mean_nsteps": float(steps.float().mean())})
            del state, r0, u, q0, tins, ins
            torch.cuda.empty_cache()
            # Path 2's final state: the NUTS and HMC cases.
            cfg = cs.wide_nuts_config(d, args.burn)
            state = run_path(f"{name} path 2", cfg, model, x0, args.burn, dev)
            r0n, expo, dirs, accu, key, r_eps = draw_nuts(gen, cs.T, d, cs.C, cs.NUTS_DEPTH, dev)
            eps_n = state.stepsize.epsilon.contiguous()
            for case in ("identity", "dense", "capped"):
                chol, chol_inv, st = factors(model, "identity" if case == "capped" else case,
                                             state, dev)
                if case == "capped":
                    xc = torch.tensor(x0, dtype=torch.float32, device=dev)[None, :, None]
                    q0 = (chol_inv.T @ xc).expand(cs.T, d, cs.C).contiguous()
                    e = torch.full((cs.T, cs.C), cs.WIDE_CAPPED_EPS, device=dev)
                else:
                    q0 = common.matvec(chol_inv.T, state.x, st).contiguous()
                    e = eps_n
                nins = (q0, r0n, state.betas, e, r_eps, expo, dirs, accu, key, chol, prm)
                compare({"workload": name, "kernel": "nuts_tree", "case": case, "structure": st},
                        builds, lambda k: k.nuts_tree(functor, nins, cs.NUTS_DEPTH, st),
                        1 if case == "capped" else NUTS_REPS[name])
                if case == "capped":
                    continue
                hkey = torch.randint(0, 2**32, (2,), generator=gen, device=dev,
                                     dtype=torch.int64)
                hins = (state.x, state.betas, hkey, chol, chol_inv, prm)
                compare({"workload": name, "kernel": "hmc_step", "case": case, "structure": st},
                        builds, lambda k: k.hmc_step(functor, hins, cs.HMC_EPS, cs.HMC_NMIN,
                                                     cs.HMC_NMAX, st), reps)
            del state, nins, q0
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
