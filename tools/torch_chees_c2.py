#!/usr/bin/env python3
"""Does the ChEES step size on the 200-D correlated Gaussian collapse in
the JAX package during burn-in, as it does in the port? (ROADMAP C2.)

Usage, from the root of the repository, on the CPU (both packages)::

    python3 tools/torch_chees_c2.py [--seeds 4] [--burn 400] [--chains 64] \\
        [--max-steps 16] [--every 50]

Both packages run path 1's cycle (SCAM/AM/DE/ChEES at 10/10/10/20 and
bench.py's cadences, ``chip_smoke.wide_config``; adaptation on for all
``--burn`` iterations; ``chees_max_steps`` cut to ``--max-steps`` in both)
on ``CorrelatedGaussian(ndim=200, seed=1)`` from bench.py's start (its
mean), 2 temperatures x ``--chains`` chains, the JAX package through its
XLA ChEES jump (``use_pallas`` off, its CPU default), the port through its
plain versions. Each of ``--seeds`` seeds starts both. Every ``--every``
iterations each rung's ChEES step size (``chees_eps``, one value a rung) is
read. Prints one JSON line a checkpoint: per package and temperature the
mean and standard deviation over seeds of log10 eps; then a summary line:
per temperature, the geometric means' ratio (port / JAX) at the end, its
log10, and Welch's t of log eps between the packages. A collapse that is
the model's shows in both packages alike; one that is the port's shows as
a large |t| with the port's step size far below the JAX package's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def jax_run(seed, args, reads):
    """The JAX package's log10 chees_eps per rung at each read."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from ptmcmcsampler_tpu import config as jc
    from ptmcmcsampler_tpu import models as jm
    from ptmcmcsampler_tpu.kernel import build_step
    from ptmcmcsampler_tpu.ladder import ladder_betas, temperature_ladder
    from ptmcmcsampler_tpu.state import init_state

    model = jm.CorrelatedGaussian(ndim=200, seed=1)
    d, t, c = model.ndim, 2, args.chains
    cfg = jc.SamplerConfig(**config_fields(jc, d, t, c, args))

    def func_grad(x, beta):
        ll, gll = model.lnlikefn_grad(x)
        lp, glp = model.lnpriorfn_grad(x)
        return beta * ll + lp, beta * gll + glp

    _, run_block = build_step(cfg, model.lnlikefn, model.lnpriorfn, func_grad)
    _, betas = ladder_betas(temperature_ladder(d, t))
    xs = jnp.broadcast_to(jnp.asarray(model.mu, jnp.float32), (t, c, d))
    ll0 = jax.vmap(jax.vmap(model.lnlikefn))(xs)
    lp0 = jax.vmap(jax.vmap(model.lnpriorfn))(xs)
    state = init_state(cfg, jax.random.PRNGKey(seed), np.asarray(model.mu), np.eye(d), betas,
                       ll0, lp0)
    out = []
    for _ in range(reads):
        state, _ = run_block(state, args.every)
        out.append(np.log10(np.asarray(state.stepsize.chees_eps)[:, 0]))
    return np.array(out)


def port_run(seed, args, reads):
    """The port's log10 chees_eps per rung at each read."""
    import torch

    from ptmcmcsampler_torch import SamplerConfig, build_step, init_state
    from ptmcmcsampler_torch import config as tc
    from ptmcmcsampler_torch.ladder import ladder_betas, temperature_ladder
    from ptmcmcsampler_torch.models import CorrelatedGaussian

    torch.set_num_threads(4)
    model = CorrelatedGaussian(ndim=200, seed=1)
    d, t, c = model.ndim, 2, args.chains
    cfg = SamplerConfig(**config_fields(tc, d, t, c, args))
    _, run_block = build_step(cfg, model, device="cpu")
    _, betas = ladder_betas(temperature_ladder(d, t))
    xs = torch.tensor(model.mu, dtype=torch.float32)[None, :, None].expand(t, d, c)
    state = init_state(cfg, seed, np.asarray(model.mu), np.eye(d), betas, model.lnlike(xs),
                       model.lnprior(xs), device="cpu")
    out = []
    for _ in range(reads):
        state, _ = run_block(state, args.every)
        out.append(np.log10(state.stepsize.chees_eps[:, 0].numpy()))
    return np.array(out)


def config_fields(config_module, d, t, c, args):
    """Path 1's configuration (chip_smoke.wide_config) with adaptation over
    every iteration and the step cap cut."""
    return dict(
        ndim=d, ntemps=t, nchains=c, groups=(tuple(range(d)),),
        jumps=config_module.build_default_jumps(
            SCAMweight=10, AMweight=10, DEweight=10, CHEESweight=20, burn=args.burn,
            have_grads=True),
        tskip=5, cov_update=1000, burn=args.burn, thin=1, de_size=2000, hmc_stepsize=0.08,
        chees_max_steps=args.max_steps,
    )


def welch_t(a, b):
    va, vb = a.var(ddof=1) / len(a), b.var(ddof=1) / len(b)
    return float((a.mean() - b.mean()) / np.sqrt(max(va + vb, 1e-30)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--burn", type=int, default=400)
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--max-steps", type=int, default=16)
    ap.add_argument("--every", type=int, default=50)
    args = ap.parse_args()
    reads = args.burn // args.every
    t0 = time.time()
    runs = {"jax": [], "port": []}
    for seed in range(args.seeds):
        runs["jax"].append(jax_run(seed, args, reads))
        runs["port"].append(port_run(seed, args, reads))
        print(f"seed {seed} done at {time.time() - t0:.0f}s", file=sys.stderr, flush=True)
    logs = {k: np.array(v) for k, v in runs.items()}  # [seed, read, T]
    for r in range(reads):
        line = {"iteration": (r + 1) * args.every}
        for pkg, a in logs.items():
            line[pkg] = {"mean_log10_eps": a[:, r].mean(0).tolist(),
                         "sd_log10_eps": a[:, r].std(0, ddof=1).tolist()}
        print(json.dumps(line), flush=True)
    end = {pkg: a[:, -1] for pkg, a in logs.items()}  # [seed, T]
    first = {pkg: a[:, 0] for pkg, a in logs.items()}
    summary = {"settings": vars(args), "seconds": time.time() - t0, "by_temperature": []}
    for t in range(end["jax"].shape[1]):
        summary["by_temperature"].append({
            "temperature_index": t,
            "log10_eps_first_read": {p: float(first[p][:, t].mean()) for p in first},
            "log10_eps_end": {p: float(end[p][:, t].mean()) for p in end},
            "ratio_port_over_jax_end": float(10 ** (end["port"][:, t].mean()
                                                    - end["jax"][:, t].mean())),
            "welch_t_log_eps_end": welch_t(end["port"][:, t], end["jax"][:, t]),
        })
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
