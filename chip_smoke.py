#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA
card and ``nvcc``; it imports nothing of JAX or of ``ptmcmcsampler_tpu``.
Phases, in order; any failure exits non-zero:

1. Card and build: print the card's name and power limit, build every
   CUDA kernel from ``ptmcmcsampler_torch/csrc`` with ``nvcc`` for sm_90a.
2. Kernel vs plain: the ChEES trajectory kernel against its plain PyTorch
   version on the card, at the main path's shape (8 x 16384 chains, D=2):
   * ``nsteps <= 32``: q1 and p1 within rtol = atol = 1e-4 (SHORT_TOL), and
     equal -inf masks of logp1;
   * ``nsteps <= 256``: the distributions of the energy error |dH| must
     agree: two-sample Kolmogorov-Smirnov distance below KS_TOL = 0.01 and
     -inf shares within 1e-3. Long trajectories on the stiff flank of the
     banana ridge are chaotic, so pointwise agreement there holds only while
     kernel and plain version round identically (the kernel is built with
     --fmad=false for that); the run logs the pointwise error too.
3. Main path at full width: the bench's headline configuration (8 x 16384
   chains, SCAM/AM/DE/ChEES at 10/10/10/20, tskip=5, cov_update=1000,
   de_size=2000, hmc_stepsize=0.08, 3000 burn-in + 12000 timed iterations
   in blocks of 1000) through ``build_step``/``run_block``. The ChEES kernel
   must launch once per ChEES iteration; the bench's moment gate must pass
   on every 8th cold chain (2048 of 16384). Prints one JSON line of results.
4. Profile: 100 more main-path iterations under ``torch.profiler``; prints
   one JSON line with the device-busy share and the largest device times.
5. Kernels line: each kernel's launches on the main path, error against the
   plain version, device time (CUDA events, after warm-up, on inputs taken
   from the main path's final state), the time of a wrapper call, the plain
   version's time and the bound.
6. Last line: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SHORT_TOL = 1e-4
KS_TOL = 0.01
NEGINF_SHARE_TOL = 1e-3

T, C, D = 8, 16384, 2
BURN_ITERS, TIMED_ITERS, BLOCK = 3000, 12000, 1000
GATE_STRIDE = 8  # moment gate on cold chains 0, 8, 16, ...: 2048 of 16384
PROFILE_ITERS = 100

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor f32 op/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Per chain and call: q0, p0, q1, p1 (4 * D floats), eps, nsteps, logp1.
BYTES_PER_CHAIN = 4 * (4 * D + 3)
# Per leapfrog step of the curved model (csrc/chees_trajectory.cu): about 70
# float operations plus 4 transcendental ones, counted as one each.
OPS_PER_STEP = 74


def log(msg):
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps, hold_stream=False):
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events.

    With ``hold_stream`` a spin kernel keeps the stream busy while the host
    enqueues all calls, so the events time the device work back to back and
    not the host's pace between launches.
    """
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if hold_stream:
        torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ks_distance(a, b):
    a, b = np.sort(a), np.sort(b)
    grid = np.concatenate([a, b])
    return float(np.max(np.abs(
        np.searchsorted(a, grid, side="right") / len(a)
        - np.searchsorted(b, grid, side="right") / len(b)
    )))


def trajectory_inputs(gen, dev, max_nsteps):
    """Synthetic kernel inputs at the main path's shape: positions around
    both modes of the curved target, a non-trivial mass matrix, per-rung
    step sizes like the adapted ones, nsteps uniform on [1, max_nsteps]."""
    from ptmcmcsampler_torch.ladder import ladder_betas, temperature_ladder

    mode = torch.where(torch.rand((T, 1, C), generator=gen, device=dev) < 0.5, -1.0, 2.0)
    x = 0.3 * torch.randn((T, D, C), generator=gen, device=dev)
    x[:, 1:] += mode
    chol = torch.linalg.cholesky(torch.tensor([[0.6, 0.15], [0.15, 0.9]], device=dev)).contiguous()
    q0 = (torch.linalg.inv(chol).T @ x).contiguous()
    p0 = torch.randn((T, D, C), generator=gen, device=dev)
    betas = torch.tensor(ladder_betas(temperature_ladder(D, T))[1], dtype=torch.float32, device=dev)
    eps = (0.1 * 1.3 ** torch.arange(T, device=dev, dtype=torch.float32))[:, None].expand(T, C)
    nsteps = torch.randint(1, max_nsteps + 1, (T, C), generator=gen, device=dev, dtype=torch.int32)
    return q0, p0, betas, eps.contiguous(), nsteps, chol


def phase_kernel_vs_plain(model):
    from ptmcmcsampler_torch.ops.chees import chees_trajectories, chees_trajectories_plain

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    max_err = 0.0
    for max_nsteps in (32, 256):
        args = trajectory_inputs(gen, dev, max_nsteps)
        q1, p1, lp1 = chees_trajectories(*args, model)
        q1p, p1p, lp1p = chees_trajectories_plain(*args, model)
        torch.cuda.synchronize()
        if not (torch.isfinite(q1).all() and torch.isfinite(p1).all()):
            raise SystemExit("kernel returned non-finite positions or momenta")
        for name, a, b in (("q1", q1, q1p), ("p1", p1, p1p)):
            err = (a - b).abs()
            max_err = max(max_err, float(err.max()))
            bad = int((err > SHORT_TOL + SHORT_TOL * b.abs()).sum())
            log(f"nsteps<={max_nsteps} {name}: max |kernel - plain| = {float(err.max()):.3e}, "
                f"{bad} of {a.numel()} outside rtol=atol={SHORT_TOL}")
            if max_nsteps <= 32 and bad:
                raise SystemExit(f"kernel {name} disagrees with the plain version")
        same_mask = torch.equal(torch.isneginf(lp1), torch.isneginf(lp1p))
        log(f"nsteps<={max_nsteps} logp1 -inf masks equal: {same_mask}")
        if max_nsteps <= 32 and not same_mask:
            raise SystemExit("kernel logp1 -inf mask differs from the plain version")
        if max_nsteps > 32:
            q0, p0, betas = args[0], args[1], args[2]
            lp0, _ = model.value_grad(args[5].T @ q0, betas[:, None])
            k0 = 0.5 * (p0 * p0).sum(1)

            def energy_error(lp1_, p1_):
                dh = ((lp1_ - 0.5 * (p1_ * p1_).sum(1)) - (lp0 - k0)).abs()
                return dh.flatten().cpu().numpy()

            dh_k, dh_p = energy_error(lp1, p1), energy_error(lp1p, p1p)
            fin_k, fin_p = np.isfinite(dh_k), np.isfinite(dh_p)
            ks = ks_distance(dh_k[fin_k], dh_p[fin_p])
            share = abs(fin_k.mean() - fin_p.mean())
            log(f"nsteps<=256 |dH|: KS distance {ks:.4f}, finite share kernel "
                f"{fin_k.mean():.5f} plain {fin_p.mean():.5f}, median |dH| kernel "
                f"{np.median(dh_k[fin_k]):.4e} plain {np.median(dh_p[fin_p]):.4e}")
            if ks >= KS_TOL or share > NEGINF_SHARE_TOL:
                raise SystemExit("kernel energy-error distribution differs from the plain version")
    return max_err


def headline_config():
    from ptmcmcsampler_torch import SamplerConfig, build_default_jumps

    burn = BURN_ITERS // 2
    return SamplerConfig(
        ndim=D, ntemps=T, nchains=C, groups=(tuple(range(D)),),
        jumps=build_default_jumps(
            SCAMweight=10, AMweight=10, DEweight=10, CHEESweight=20, burn=burn, have_grads=True
        ),
        tskip=5, cov_update=1000, burn=burn, thin=1, de_size=2000, hmc_stepsize=0.08,
    )


def phase_main_path(model, card):
    from ptmcmcsampler_torch import build_step, init_state
    from ptmcmcsampler_torch.config import KIND_CHEES
    from ptmcmcsampler_torch.diagnostics import moment_gate, split_rhat
    from ptmcmcsampler_torch.ladder import ladder_betas, temperature_ladder
    from ptmcmcsampler_torch.ops.chees import chees_trajectories

    dev = torch.device("cuda", 0)
    cfg = headline_config()
    _, run_block = build_step(cfg, model, device=dev)
    _, betas = ladder_betas(temperature_ladder(D, T))
    x0 = np.array([-0.1, -0.5])
    xs = torch.tensor(x0, dtype=torch.float32, device=dev)[None, :, None].expand(T, D, C)
    state = init_state(
        cfg, 7, x0, np.eye(D), betas, model.lnlike(xs), model.lnprior(xs), device=dev
    )

    chees_trajectories.launches = 0
    t0 = time.time()
    for b in range(BURN_ITERS // BLOCK):
        state, out = run_block(state, BLOCK)
        torch.cuda.synchronize()
        log(f"burn-in block {b + 1} at {time.time() - t0:.1f}s")
    cold = []
    t1 = time.time()
    for b in range(TIMED_ITERS // BLOCK):
        state, out = run_block(state, BLOCK)
        cold.append(out.x[:, 0, :, ::GATE_STRIDE].clone())  # [BLOCK, D, C / stride]
        torch.cuda.synchronize()
        log(f"timed block {b + 1} at {time.time() - t1:.1f}s")
    elapsed = time.time() - t1
    launches = chees_trajectories.launches

    j_chees = [j.kind for j in cfg.jumps].index(KIND_CHEES)
    chees_iters = int(state.counters.jump_proposed[j_chees, 0, 0])
    log(f"ChEES kernel launches {launches}, ChEES iterations {chees_iters}")
    if launches == 0 or launches != chees_iters:
        raise SystemExit("the main path did not launch the ChEES kernel once per ChEES iteration")
    if not (torch.isfinite(state.x).all() and state.x.shape == (T, D, C)):
        raise SystemExit("main path state is not finite or has the wrong shape")

    chains = torch.cat(cold).permute(2, 0, 1).cpu().numpy()  # [Csub, N, D]
    target, _ = model.posterior_moments()
    ok, max_z, ess = moment_gate(chains, target)
    rhat_max = float(np.nanmax(split_rhat(chains)))
    ctr = state.counters
    acc = (ctr.jump_accepted[:, 0].sum(-1).double()
           / ctr.jump_proposed[:, 0].sum(-1).clamp(min=1).double()).tolist()
    name, power = [s.strip() for s in card.split(",", 1)]
    result = {
        "phase": "main_path",
        "iters_per_sec": TIMED_ITERS / elapsed,
        "ess_per_sec": float(ess.min()) / elapsed,
        "ess_min_dim": float(ess.min()),
        "ess_chains_used": int(chains.shape[0]),
        "moments_ok": ok,
        "moments_max_z": max_z,
        "rhat_max": rhat_max,
        "elapsed_sec": elapsed,
        "burn_sec": t1 - t0,
        "cold_acceptance": dict(zip(cfg.jump_names(), acc)),
        "chees_eps": state.stepsize.chees_eps[:, 0].tolist(),
        "chees_tlen": state.stepsize.chees_tlen[:, 0].tolist(),
        "chees_launches": launches,
        "card": name,
        "power_limit": power,
    }
    print(json.dumps(result), flush=True)
    if not ok:
        raise SystemExit(f"moment gate failed on the main path (max z {max_z})")
    return state, run_block, launches


def _device_us(event):
    return getattr(event, "self_device_time_total", None) or getattr(
        event, "self_cuda_time_total", 0.0
    )


def phase_profile(state, run_block, iters=PROFILE_ITERS):
    """Device-busy share and the largest device times over ``iters`` more
    main-path iterations, with the profiler on (which slows the host)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        state, _ = run_block(state, iters)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.time() - t0)
    # Device-side events only (kernels, copies, fills): the CPU-side aten
    # entries carry the same device time again.
    device = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0
    ]
    device_us = sum(_device_us(e) for e in device)
    top = sorted(device, key=_device_us, reverse=True)[:8]
    result = {
        "phase": "profile",
        "iters": iters,
        "wall_ms_per_iter": wall_us / 1e3 / iters,
        "device_busy_share": device_us / wall_us if device_us else "not measured",
        "device_ms_per_iter": device_us / 1e3 / iters if device_us else "not measured",
        "device_ops_per_iter": sum(e.count for e in device) / iters if device else "not measured",
        "top_device_ms_per_iter": [[e.key, _device_us(e) / 1e3 / iters] for e in top],
    }
    print(json.dumps(result), flush=True)
    return state


def phase_kernels_line(model, state, launches, max_err):
    """Time the kernel and its plain version on inputs from the main path's
    final state: the adapted step sizes and trajectory lengths, fresh
    momenta and jitter, drawn as proposals/chees.py draws them."""
    from ptmcmcsampler_torch.ops.chees import chees_trajectories, chees_trajectories_plain

    dev = state.x.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    chol, chol_inv = state.adapt.chol, state.adapt.chol_inv
    ss = state.stepsize
    eps = ss.chees_eps.contiguous()
    tlen = torch.maximum(ss.chees_tlen, eps)
    u = torch.rand((T, C), generator=gen, device=dev) * (1.0 - 1e-3) + 1e-3
    max_steps = headline_config().chees_max_steps
    nsteps = torch.clamp(torch.ceil(u * tlen / eps), 1, max_steps).to(torch.int32)
    q0 = (chol_inv.T @ state.x).contiguous()
    p0 = torch.randn((T, D, C), generator=gen, device=dev)
    args = (q0, p0, state.betas, eps, nsteps, chol, model)

    kernel_ms = cuda_ms(lambda: chees_trajectories(*args), 50, hold_stream=True)
    wrapper_ms = cuda_ms(lambda: chees_trajectories(*args), 50)
    plain_ms = cuda_ms(lambda: chees_trajectories_plain(*args), 5)
    steps = int(nsteps.sum())
    bytes_moved = BYTES_PER_CHAIN * T * C + 4 * (T + D * D)
    ops = OPS_PER_STEP * (steps + T * C)  # + the starting gradient
    bytes_ms = 1e3 * bytes_moved / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / F32_OPS_PER_S
    log(f"kernel {kernel_ms:.4f} ms, wrapper call {wrapper_ms:.4f} ms, plain {plain_ms:.3f} ms, mean nsteps "
        f"{steps / (T * C):.2f}, max {int(nsteps.max())}")
    return {
        "name": "chees_trajectory",
        "route": "cuda",
        "source": "ptmcmcsampler_torch/csrc/chees_trajectory.cu",
        "replaces": "ptmcmcsampler_tpu/ops/chees_pallas.py:41",
        "launches": launches,
        "max_abs_err": max_err,
        "max_err": max_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "wrapper_ms": wrapper_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "mean_nsteps": steps / (T * C),
    }


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from ptmcmcsampler_torch.models import CurvedLikelihood
    from ptmcmcsampler_torch.ops import build

    card = card_line()
    print(card, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    log(f"nvcc: {nvcc}")
    t0 = time.time()
    for name, text in build.build().items():
        log(f"built {name} in {time.time() - t0:.1f}s:\n{text.strip()}")

    model = CurvedLikelihood()
    max_err = phase_kernel_vs_plain(model)
    state, run_block, launches = phase_main_path(model, card)
    state = phase_profile(state, run_block)
    kernels = [phase_kernels_line(model, state, launches, max_err)]

    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
