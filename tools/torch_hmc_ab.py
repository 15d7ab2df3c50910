#!/usr/bin/env python3
"""Time this checkout's fused HMC step against another checkout's HMC branch
on the same positions, on one CUDA card, and count the device operations of
an HMC iteration of path 2 in each checkout.

Usage, from the root of this checkout on a machine with a card and nvcc::

    python3 tools/torch_hmc_ab.py --other PATH_TO_OTHER_CHECKOUT

The other checkout's ``ptmcmcsampler_torch/csrc/hmc_trajectory.cu`` must
export ``hmc_trajectory_curved`` with this checkout's arguments (every
version of the port does). It is compiled with this checkout's nvcc flags
(``ops/build.py``) into a temporary directory and bound with ctypes. Its HMC
branch is rebuilt around it as that checkout's ``proposals/gradient.py``
ran it before the fused step: momenta by ``torch.randn``, lengths by
``torch.randint``, ``q0 = chol_inv^T x`` and ``x1 = chol^T q1`` by matmuls.
This checkout's branch draws a two-word key and calls ``hmc_step``. Both get
the same positions at the main path's shape (8 x 16384 chains, D = 2,
``chip_smoke.py`` ``hmc_step_inputs``) and the path's settings (eps 0.08,
lengths in [2, 50)). Cases:

* ``path``: positions around both modes of the curved target, where the
  break test ends every trajectory after one step;
* ``full_length``: every chain started outside the prior box, where it runs
  its whole drawn length.

In each case the two checkouts' trajectory entries get the same arrays (the
fused step's own draws, ``hmc_kernel_draws``) and must give equal outputs,
bit for bit; then each branch is timed by CUDA events with the stream held
(device time) and without (the call as the path makes it), in turns (this,
other, other, this).

Then, in a fresh process for each checkout, path 2's configuration
(``chip_smoke.py`` ``nuts_config``) at full width runs 20 HMC iterations
(``step(state, kind)``) to warm up and 50 under ``torch.profiler``: the
device operations of one HMC iteration.

Prints the card's name and power limit, then one JSON line a case and one
for the operation counts.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from ptmcmcsampler_torch.models import CurvedLikelihood  # noqa: E402
from ptmcmcsampler_torch.ops import build, hmc  # noqa: E402

EPS, NMIN, NMAX = cs.HMC_EPS, cs.HMC_NMIN, cs.HMC_NMAX
REPS = 50
OPS_WARMUP, OPS_ITERS = 20, 50

# Run in a fresh process with a checkout's root as argv[1]: the device
# operations of one HMC iteration of path 2, through the public API only.
OPS_SCRIPT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from ptmcmcsampler_torch import build_step, init_state
from ptmcmcsampler_torch.config import KIND_HMC
from ptmcmcsampler_torch.ladder import ladder_betas, temperature_ladder
from ptmcmcsampler_torch.models import CurvedLikelihood

warmup, iters = int(sys.argv[2]), int(sys.argv[3])
model, cfg, dev = CurvedLikelihood(), cs.nuts_config(), torch.device("cuda:0")
step, _ = build_step(cfg, model, device=dev)
x0 = np.array([-0.1, -0.5])
xs = torch.tensor(x0, dtype=torch.float32, device=dev)[None, :, None].expand(cs.T, cs.D, cs.C)
state = init_state(cfg, 7, x0, np.eye(cs.D), ladder_betas(temperature_ladder(cs.D, cs.T))[1],
                   model.lnlike(xs), model.lnprior(xs), device=dev)
kind = [j.kind for j in cfg.jumps].index(KIND_HMC)
for _ in range(warmup):
    state = step(state, kind)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for _ in range(iters):
        state = step(state, kind)
    torch.cuda.synchronize()
device = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA and cs._device_us(e) > 0]
print(json.dumps({"device_ops_per_hmc_iter": sum(e.count for e in device) / iters,
                  "device_ms_per_hmc_iter": sum(cs._device_us(e) for e in device) / 1e3 / iters,
                  "ops": {e.key: e.count / iters for e in device}}))
"""


def ptxas_lines(text):
    return [line.split(":", 1)[-1].strip() for line in text.splitlines()
            if "registers" in line or "spill" in line]


def other_kernel(checkout, tmp):
    """The other checkout's ``hmc_trajectory_curved`` as ``fn(q0, p0, beta,
    nsteps, chol) -> (q1, qxy)`` at step size EPS, and its ptxas lines."""
    src = Path(checkout) / "ptmcmcsampler_torch" / "csrc" / "hmc_trajectory.cu"
    lib = Path(tmp) / "libhmc_trajectory_other.so"
    out = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         check=True).stdout
    fn = ctypes.CDLL(str(lib)).hmc_trajectory_curved
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_float] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

    def run(q0, p0, beta, nsteps, chol):
        t, _, c = q0.shape
        q1, qxy = torch.empty_like(q0), torch.empty((t, c), device=q0.device)
        err = fn(q0.data_ptr(), p0.data_ptr(), beta.data_ptr(), nsteps.data_ptr(),
                 chol.data_ptr(), EPS, q1.data_ptr(), qxy.data_ptr(), t, c,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"other kernel launch failed: CUDA error {err}")
        return q1, qxy

    return run, ptxas_lines(out)


def hmc_iteration_ops(root):
    """Device operations of an HMC iteration in the checkout at ``root``."""
    env = {**os.environ, "PYTHONPATH": str(root)}
    out = subprocess.run(
        [sys.executable, "-c", OPS_SCRIPT, str(root), str(OPS_WARMUP), str(OPS_ITERS)],
        cwd=root, env=env, stdout=subprocess.PIPE, text=True, check=True, timeout=900,
    ).stdout
    return json.loads(out.strip().splitlines()[-1])


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", required=True, help="root of the other checkout")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_hmc_ab: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    model = CurvedLikelihood()
    print(cs.card_line(), flush=True)
    this_ptxas = (ptxas_lines(build.build(("hmc_trajectory",)).get("hmc_trajectory", ""))
                  or "built before this run (chip_smoke.py's kernels line has it)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    with tempfile.TemporaryDirectory() as tmp:
        other, other_ptxas = other_kernel(args.other, tmp)
        print(json.dumps({"other": args.other, "this_ptxas": this_ptxas,
                          "other_ptxas": other_ptxas}), flush=True)
        for case, outside in (("path", 0.0), ("full_length", 1.0)):
            inp = cs.hmc_step_inputs(gen, dev, cs.C, outside)
            x, betas, key, chol, chol_inv = inp
            t, d, c = x.shape

            # The two trajectory entries on the same arrays: the fused
            # step's own draws, the start whitened by a matmul.
            p0, nsteps = hmc.hmc_kernel_draws(key, t, d, c, NMIN, NMAX, model)
            q0 = (chol_inv.T @ x).contiguous()
            mine = hmc.hmc_trajectories(q0, p0, betas, nsteps, chol, EPS, model)
            theirs = other(q0, p0, betas, nsteps, chol)
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(mine, theirs))

            def this_branch():
                k = torch.randint(0, 2**32, (2,), generator=gen, device=dev, dtype=torch.int64)
                return hmc.hmc_step(x, betas, k, chol, chol_inv, EPS, NMIN, NMAX, model)

            def other_branch():
                p = torch.randn((t, d, c), generator=gen, device=dev)
                n = torch.randint(NMIN, NMAX, (t, c), generator=gen, device=dev,
                                  dtype=torch.int32)
                q1, qxy = other((chol_inv.T @ x).contiguous(), p, betas, n, chol)
                return chol.T @ q1, qxy

            times = {f"{who}_{how}": [] for who in ("this", "other") for how in ("device", "call")}
            for who, fn in (("this", this_branch), ("other", other_branch),
                            ("other", other_branch), ("this", this_branch)):
                times[f"{who}_device"].append(cs.cuda_ms(fn, REPS, hold_stream=True))
                times[f"{who}_call"].append(cs.cuda_ms(fn, REPS))
            print(json.dumps({
                "case": case, "trajectory_entries_equal": equal,
                "mean_nsteps_drawn": float(nsteps.float().mean()),
                "max_nsteps_drawn": int(nsteps.max()), **times,
            }), flush=True)
            if not equal:
                raise SystemExit(f"case {case}: the two trajectory entries' outputs differ")
    ops = {"this": hmc_iteration_ops(ROOT), "other": hmc_iteration_ops(Path(args.other))}
    print(json.dumps({"case": "hmc_iteration_ops",
                      **{f"{who}_{k}": v for who, r in ops.items() for k, v in r.items()
                         if k != "ops"},
                      "this_ops": ops["this"]["ops"], "other_ops": ops["other"]["ops"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
