"""No-U-Turn sampler jump for the whole ``[T, C]`` batch.

Parity target: ``NUTSJump`` (nutsjump.py:379-840), as the JAX package runs it
through its fused tree kernel (``ptmcmcsampler_tpu/ops/nuts_pallas.py``
``make_nuts_pallas``): slice-sampling NUTS per Hoffman & Gelman (2011)
Algorithm 6, one tree per chain, with all randomness drawn up front as
arrays, and dual-averaging step-size adaptation per chain.

* The trees run in :func:`ptmcmcsampler_torch.ops.nuts.nuts_trees`: the
  hand-written CUDA kernel on the card, its plain version on the CPU.
* Step sizes start at ``epsilon <= 0`` (the state's initial -1) and are set
  by ``find_reasonable_epsilon`` at a chain's first NUTS call, unless
  ``nuts_force_epsilon`` fixes them.
* ``qxy = logp0 - logp_prop``, so the outer MH step always accepts
  (nutsjump.py:837-840).
* Dual averaging uses the reference constants gamma=0.05, t0=10,
  kappa=0.75 (nutsjump.py:414-420) and its update equations (:804-816),
  with ``epsilon = epsilonbar`` after burn-in.

No host read per iteration: whether any lane still needs its step size
initialised is read from the device at most once for each step-size tensor
the branch did not produce itself (the state's first, or one loaded from
elsewhere); the tensors it produces have every lane set. A lane whose step
size underflows to 0 in dual averaging (an exponent below about -103) is
therefore not searched again, where the JAX package searches it at its next
call.
"""

from __future__ import annotations

import torch

from ..ops.nuts import nuts_trees
from .gradient import find_reasonable_epsilon, make_whitened_funcs

GAMMA = 0.05
T0 = 10.0
KAPPA = 0.75


def make_nuts(config, model):
    forward, backward, fgw = make_whitened_funcs(model.value_grad)
    depth = config.nuts_max_depth
    delta = config.nuts_delta
    force_eps = config.nuts_force_epsilon
    nburn = config.burn

    def core(x, betas, it, ctx, ss, r0, expo, dirs, accu, resu, r_eps, need=None):
        """Deterministic NUTS step.

        ``r0 [T, D, C]`` standard-normal momenta; ``expo [T, C]`` Exp(1)
        slice draws; ``dirs [depth, T, C]`` doubling directions (+-1);
        ``accu [depth, T, C]`` and ``resu [2**depth - 1, T, C]`` uniforms;
        ``r_eps [T, D, C]`` the step-size search's momenta (read only if a
        lane needs it). ``need``: whether any lane has ``epsilon <= 0``, or
        None to read it from the device. Returns ``(q, qxy, ss)``.
        """
        t, _, c = x.shape
        q0 = forward(ctx, x).contiguous()
        eps_state = ss["epsilon"]
        if force_eps is not None:
            epsilon = torch.full_like(eps_state, force_eps)
            mu = torch.log(10.0 * epsilon)
        else:
            if need is None:
                need = bool((eps_state <= 0).any())
            if need:
                logp_s, grad_s = fgw(ctx, q0, betas[:, None])
                eps_init = find_reasonable_epsilon(fgw, ctx, betas, q0, grad_s, logp_s, r_eps)
                fresh = eps_state <= 0
                epsilon = torch.where(fresh, eps_init, eps_state)
                mu = torch.where(fresh, torch.log(10.0 * epsilon), ss["mu"])
            else:
                epsilon, mu = eps_state, ss["mu"]

        q_prop, logp0, logp_prop, alpha, nalpha, _ = nuts_trees(
            q0, r0.contiguous(), betas, epsilon.contiguous(), expo.contiguous(),
            dirs.contiguous(), accu.contiguous(), resu.contiguous(),
            ctx.chol.contiguous(), model,
        )
        qxy = logp0 - logp_prop
        qxy = torch.where(torch.isnan(qxy), float("-inf"), qxy)

        # Dual averaging (nutsjump.py:804-816), per chain.
        new_ss = dict(ss)
        ncalls = ss["ncalls"] + 1.0
        new_ss["ncalls"] = ncalls
        new_ss["mu"] = mu
        if force_eps is not None:
            new_ss["epsilon"] = epsilon
            new_ss["epsilonbar"] = epsilon
        else:
            eta = 1.0 / (ncalls + T0)
            hbar = (1.0 - eta) * ss["hbar"] + eta * (delta - alpha / torch.clamp(nalpha, min=1.0))
            new_ss["hbar"] = hbar
            if it <= nburn:  # a host integer comparison
                eps_burn = torch.exp(mu - torch.sqrt(ncalls) / GAMMA * hbar)
                eta2 = ncalls ** -KAPPA
                new_ss["epsilon"] = eps_burn
                new_ss["epsilonbar"] = torch.exp(
                    (1.0 - eta2) * torch.log(torch.clamp(ss["epsilonbar"], min=1e-30))
                    + eta2 * torch.log(eps_burn)
                )
            else:
                new_ss["epsilon"] = ss["epsilonbar"]
        return backward(ctx, q_prop), qxy, new_ss

    produced = [None]  # the last step-size tensor this branch returned

    def nuts(rng, x, betas, it, ctx, ss):
        t, d, c = x.shape
        dev = x.device

        def uniform(*shape):
            return torch.rand(shape, generator=rng, device=dev)

        r0 = torch.randn((t, d, c), generator=rng, device=dev)
        expo = torch.empty((t, c), device=dev).exponential_(generator=rng)
        dirs = torch.where(uniform(depth, t, c) < 0.5, -1.0, 1.0)
        accu = uniform(depth, t, c)
        resu = uniform((1 << depth) - 1, t, c)
        need = False
        if force_eps is None and ss["epsilon"] is not produced[0]:
            need = bool((ss["epsilon"] <= 0).any())  # once per foreign tensor
        r_eps = torch.randn((t, d, c), generator=rng, device=dev) if need else None
        q, qxy, new_ss = core(x, betas, it, ctx, ss, r0, expo, dirs, accu, resu, r_eps,
                              need=need)
        produced[0] = new_ss["epsilon"]
        return q, qxy, new_ss

    nuts.core = core
    return nuts
