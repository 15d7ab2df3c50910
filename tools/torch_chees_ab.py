#!/usr/bin/env python3
"""Time this checkout's ChEES trajectory kernel, which groups each block's
lanes by trajectory length, against another checkout's, on the same inputs,
on one CUDA card; and count the device operations of a ChEES iteration of
path 1 in each checkout.

Usage, from the root of this checkout on a machine with a card and nvcc::

    python3 tools/torch_chees_ab.py --other PATH_TO_OTHER_CHECKOUT

The other checkout's ``ptmcmcsampler_torch/csrc/chees_trajectory.cu`` must
export ``chees_trajectory_curved`` with this checkout's arguments (every
version of the port does). It is compiled with this checkout's nvcc flags
(``ops/build.py``) into a temporary directory and bound with ctypes. Both
kernels get the same inputs at the main path's shape (8 x 16384 chains,
D = 2): positions around both modes of the curved target
(``chip_smoke.py`` ``trajectory_inputs``), fresh momenta and jitter, and
lengths ``clamp(ceil(u * tlen / eps), 1, 256)`` as proposals/chees.py draws
them. Their outputs are compared bit for bit. Cases, each timed by CUDA
events with the stream held, in turns (this, other, other, this):

* ``adapted``: path 1's adapted step sizes and lengths per rung
  (``ADAPTED_EPS``, ``ADAPTED_TLEN``);
* ``capped_batch``: every chain at the adapted case's largest length over
  the whole batch: the time of a step when every lane is busy;
* ``capped_warp``: the same for one warp alone (T = 1, C = 32): the
  latency of one thread's step.

Then, in a fresh process for each checkout, path 1's configuration
(``chip_smoke.py`` ``headline_config``) at full width runs 20 ChEES
iterations (``step(state, kind)``) to warm up and 50 under
``torch.profiler``: the device operations of one ChEES iteration.

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
from ptmcmcsampler_torch.ops import build  # noqa: E402
from ptmcmcsampler_torch.ops.chees import chees_trajectories, lane_efficiency  # noqa: E402

# Path 1's adapted ChEES step sizes and trajectory lengths per rung, from
# chip_smoke.py's path-1 line on an H100 (PERF.md).
ADAPTED_EPS = (0.12727, 0.17786, 0.23267, 0.29113, 0.36826, 0.47559, 0.99904, 2.5707)
ADAPTED_TLEN = (1.6299, 1.3731, 2.3238, 3.8093, 5.6766, 8.2598, 4.7753, 5.3697)
MAX_STEPS = 256
REPS = {"adapted": 50, "capped_batch": 20, "capped_warp": 50}
OPS_WARMUP, OPS_ITERS = 20, 50

# Run in a fresh process with a checkout's root as argv[1]: the device
# operations of one ChEES iteration of path 1, through the public API only.
OPS_SCRIPT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from ptmcmcsampler_torch import build_step, init_state
from ptmcmcsampler_torch.config import KIND_CHEES
from ptmcmcsampler_torch.ladder import ladder_betas, temperature_ladder
from ptmcmcsampler_torch.models import CurvedLikelihood

warmup, iters = int(sys.argv[2]), int(sys.argv[3])
model, cfg, dev = CurvedLikelihood(), cs.headline_config(), torch.device("cuda:0")
step, _ = build_step(cfg, model, device=dev)
x0 = np.array([-0.1, -0.5])
xs = torch.tensor(x0, dtype=torch.float32, device=dev)[None, :, None].expand(cs.T, cs.D, cs.C)
state = init_state(cfg, 7, x0, np.eye(cs.D), ladder_betas(temperature_ladder(cs.D, cs.T))[1],
                   model.lnlike(xs), model.lnprior(xs), device=dev)
kind = [j.kind for j in cfg.jumps].index(KIND_CHEES)
for _ in range(warmup):
    state = step(state, kind)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for _ in range(iters):
        state = step(state, kind)
    torch.cuda.synchronize()
device = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA and cs._device_us(e) > 0]
print(json.dumps({"device_ops_per_chees_iter": sum(e.count for e in device) / iters,
                  "device_ms_per_chees_iter": sum(cs._device_us(e) for e in device) / 1e3 / iters,
                  "ops": {e.key: e.count / iters for e in device}}))
"""


def other_kernel(checkout, tmp):
    """The other checkout's trajectory kernel as ``prepare(inputs) -> run``,
    where ``run()`` launches it and returns its outputs, and its ptxas
    lines."""
    src = Path(checkout) / "ptmcmcsampler_torch" / "csrc" / "chees_trajectory.cu"
    lib = Path(tmp) / "libchees_trajectory_other.so"
    out = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         check=True).stdout
    regs = [line.split(":", 1)[-1].strip() for line in out.splitlines()
            if "registers" in line or "spill" in line]
    fn = ctypes.CDLL(str(lib)).chees_trajectory_curved
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

    def prepare(inp):
        q0, p0, beta, eps, nsteps, chol = inp
        t, _, c = q0.shape
        q1, p1 = torch.empty_like(q0), torch.empty_like(p0)
        logp1 = torch.empty((t, c), device=q0.device)
        ptrs = [a.data_ptr() for a in (q0, p0, beta, eps, nsteps, chol, q1, p1, logp1)]

        def run():
            err = fn(*ptrs, t, c, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"other kernel launch failed: CUDA error {err}")
            return q1, p1, logp1

        run.keep = (q1, p1, logp1)  # the buffers stay alive while run may launch
        return run

    return prepare, regs


def cases(dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    q0, p0, betas, _, _, chol = cs.trajectory_inputs(gen, dev, 1)
    eps = torch.tensor(ADAPTED_EPS, device=dev)[:, None].expand(cs.T, cs.C).contiguous()
    tlen = torch.maximum(torch.tensor(ADAPTED_TLEN, device=dev)[:, None], eps)
    u = torch.rand((cs.T, cs.C), generator=gen, device=dev) * (1.0 - 1e-3) + 1e-3
    nsteps = torch.clamp(torch.ceil(u * tlen / eps), 1, MAX_STEPS).to(torch.int32)
    longest = int(nsteps.max())
    yield "adapted", (q0, p0, betas, eps, nsteps, chol)
    for name, t, c in (("capped_batch", cs.T, cs.C), ("capped_warp", 1, 32)):
        yield name, (q0[:t, :, :c].contiguous(), p0[:t, :, :c].contiguous(),
                     betas[:t].contiguous(), eps[:t, :c].contiguous(),
                     torch.full((t, c), longest, dtype=torch.int32, device=dev), chol)


def chees_iteration_ops(root):
    """Device operations of a ChEES iteration in the checkout at ``root``."""
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
        print("torch_chees_ab: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    model = CurvedLikelihood()
    print(cs.card_line(), flush=True)
    build.build(("chees_trajectory",))
    with tempfile.TemporaryDirectory() as tmp:
        prepare, regs = other_kernel(args.other, tmp)
        print(json.dumps({"other": args.other, "other_ptxas": regs}), flush=True)
        for name, inp in cases(dev):
            def this():
                return chees_trajectories(*inp, model)

            that = prepare(inp)
            mine, theirs = this(), that()
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(mine, theirs))
            times = {"this": [], "other": []}
            for who, fn in (("this", this), ("other", that), ("other", that), ("this", this)):
                times[who].append(cs.cuda_ms(fn, REPS[name], hold_stream=True))
            nsteps = inp[4]
            steps = int(nsteps.max())
            print(json.dumps({
                "case": name, "outputs_equal": equal, "max_nsteps": steps,
                "mean_nsteps": float(nsteps.float().mean()),
                "lane_efficiency_unsorted": lane_efficiency(nsteps, grouped=False),
                "lane_efficiency_sorted": lane_efficiency(nsteps, grouped=True),
                "this_ms": times["this"], "other_ms": times["other"],
                "this_us_per_step": [1e3 * m / steps for m in times["this"]],
                "other_us_per_step": [1e3 * m / steps for m in times["other"]],
            }), flush=True)
            if not equal:
                raise SystemExit(f"case {name}: the two kernels' outputs differ")
    ops = {"this": chees_iteration_ops(ROOT), "other": chees_iteration_ops(Path(args.other))}
    print(json.dumps({"case": "chees_iteration_ops",
                      **{f"{who}_{k}": v for who, r in ops.items() for k, v in r.items()
                         if k != "ops"},
                      "this_ops": ops["this"]["ops"], "other_ops": ops["other"]["ops"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
