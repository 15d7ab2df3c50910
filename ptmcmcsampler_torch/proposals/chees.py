"""ChEES-HMC: adaptive-trajectory HMC for batched chains.

Every chain runs a whitened leapfrog trajectory of its own jittered length
``ceil(u_c * tlen / eps)`` (``u ~ U[1e-3, 1)``, capped at
``chees_max_steps``), with one step size per temperature. The MH correction
is ``qxy = K0 - K1``, so the outer tempered accept equals the Hamiltonian
error. During burn-in, ``log eps`` follows dual averaging toward
``chees_delta`` and ``log tlen`` an Adam ascent on the ChEES criterion
(Hoffman, Radul & Sountsov); after burn-in both freeze, so the kernel is a
fixed Markov kernel. The per-chain part of a step (step size and length,
whitening, trajectory, kinetic energies, ``qxy``, acceptance, the end point
mapped back) runs in :func:`ptmcmcsampler_torch.ops.chees.chees_step`: one
launch of the hand-written CUDA kernel on the card, its plain version on
the CPU. The per-rung adaptation, which needs means over the chains, stays
in PyTorch.

The chees_* step-size entries are per-temperature values replicated along
the chain axis.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.chees import chees_step
from ..parallel.mesh import gather_many
from ..utils import block_of
from .nuts import GAMMA, KAPPA, T0  # dual averaging, shared with NUTS
# Adam constants for the trajectory-length ascent (ChEES paper defaults).
B1 = 0.9
B2 = 0.999
ADAM_EPS = 1e-8


def make_chees(config, model):
    max_steps = config.chees_max_steps
    delta = config.chees_delta
    lr = config.chees_lr
    nburn = config.burn
    eps0 = config.hmc_stepsize
    mu0 = float(np.log(np.float32(10.0) * np.float32(eps0)))  # log(10 eps0), in f32

    def step(x, betas, ctx, ss, r0, u):
        """The per-chain part: ``(x1, q0, z1, r1, qxy, alpha)``."""
        return chees_step(
            x, r0, u, betas, ss["chees_eps"], ss["chees_tlen"], eps0, max_steps,
            ctx.chol.contiguous(), ctx.chol_inv.contiguous(), model, ctx.structure,
        )

    def core(x, betas, it, ctx, ss, r0, u):
        """Deterministic ChEES step: ``r0 [T, D, C]`` standard-normal momenta
        and ``u [T, C]`` jitter in ``[1e-3, 1)``. Returns ``(q, qxy, ss)``.
        On a sharded batch (``ctx.block``) the adaptation's per-rung means
        over the chains run on the gathered rows (``parallel.mesh.gather_many``),
        the unsharded function on the unsharded arrays, and the batch keeps
        its block of the result."""
        x1, q0, z1, r1, qxy, alpha = step(x, betas, ctx, ss, r0, u)
        blk = block_of(ctx, x)
        if not blk.sharded:
            return x1, qxy, adapt(it, ss, q0, z1, r1, alpha, u)
        xd, tc = ("T", x.shape[1], "C"), ("T", "C")
        fields = [f for f in ss if f.startswith("chees_")]
        got = gather_many(blk, [(ss[f], tc) for f in fields]
                          + [(a, xd) for a in (q0, z1, r1)] + [(a, tc) for a in (alpha, u)])
        whole = dict(zip(fields, got))
        new = adapt(it, whole, *got[len(fields):])
        return x1, qxy, {f: blk.take(new[f], tc) if f in whole else v for f, v in ss.items()}

    def adapt(it, ss, q0, z1, r1, alpha, u):
        """The per-rung step-size and length adaptation of a ChEES step,
        from its trajectories' starts ``q0``, ends ``z1`` and end momenta
        ``r1 [T, D, C]``, acceptance ``alpha`` and jitter ``u [T, C]``."""
        t, _, c = q0.shape
        # The step size and length the trajectories used, per rung.
        eps_prev = ss["chees_eps"][:, 0]
        tlen_t = torch.maximum(ss["chees_tlen"][:, 0], torch.where(eps_prev > 0, eps_prev, eps0))

        in_burn = it <= nburn  # a host integer comparison

        # ---- step-size dual averaging toward delta, per temperature ----
        ncalls = ss["chees_count"][:, 0] + 1.0  # [T]
        mean_alpha = torch.mean(alpha, dim=1)
        mu_prev = ss["chees_mu"][:, 0]
        mu = torch.where(mu_prev == 0.0, mu0, mu_prev)
        eta = 1.0 / (ncalls + T0)
        hbar = (1.0 - eta) * ss["chees_hbar"][:, 0] + eta * (delta - mean_alpha)
        eps_burn = torch.exp(mu - torch.sqrt(ncalls) / GAMMA * hbar)
        eta2 = ncalls ** -KAPPA
        had_calls = ss["chees_count"][:, 0] > 0
        epsbar_prev = torch.where(
            had_calls, torch.clamp(ss["chees_epsbar"][:, 0], min=1e-30), eps0
        )
        epsbar = torch.exp(
            (1.0 - eta2) * torch.log(epsbar_prev)
            + eta2 * torch.log(torch.clamp(eps_burn, min=1e-30))
        )
        new_eps = eps_burn if in_burn else epsbar_prev  # [T]

        # ---- ChEES gradient ascent on log trajectory length ----
        q1m = z1 - torch.mean(z1, dim=2, keepdim=True)  # centred over chains
        q0m = q0 - torch.mean(q0, dim=2, keepdim=True)
        d1 = torch.sum(q1m * q1m, dim=1)
        d0 = torch.sum(q0m * q0m, dim=1)
        per_chain = u * (d1 - d0) * torch.sum(q1m * r1, dim=1)  # [T, C]
        finite = torch.isfinite(per_chain)
        w = torch.where(finite, alpha, 0.0)
        per_chain = torch.where(finite, per_chain, 0.0)
        grad_t = torch.sum(w * per_chain, dim=1) / torch.clamp(torch.sum(w, dim=1), min=1e-6)
        m_t = B1 * ss["chees_m"][:, 0] + (1.0 - B1) * grad_t
        v_t = B2 * ss["chees_v"][:, 0] + (1.0 - B2) * grad_t * grad_t
        mhat = m_t / (1.0 - B1 ** ncalls)
        vhat = v_t / (1.0 - B2 ** ncalls)
        step = lr * mhat / (torch.sqrt(vhat) + ADAM_EPS)
        log_tlen = torch.log(torch.clamp(tlen_t, min=1e-10))
        new_tlen = torch.exp(log_tlen + step) if in_burn else torch.exp(log_tlen)
        new_tlen = torch.minimum(torch.maximum(new_tlen, new_eps), new_eps * max_steps)

        def rep(v):  # [T] -> [T, C]
            return v[:, None].expand(t, c).contiguous()

        def freeze(new, old):
            """Adaptation moves only during burn-in; afterwards the kernel is
            a fixed Markov kernel, so detailed balance holds exactly."""
            return new if in_burn else old

        new_ss = dict(ss)
        new_ss["chees_eps"] = rep(freeze(new_eps, torch.where(had_calls, epsbar_prev, eps0)))
        new_ss["chees_epsbar"] = rep(freeze(epsbar, epsbar_prev))
        new_ss["chees_hbar"] = rep(freeze(hbar, ss["chees_hbar"][:, 0]))
        new_ss["chees_mu"] = rep(mu)
        new_ss["chees_count"] = rep(freeze(ncalls, ss["chees_count"][:, 0]))
        new_ss["chees_m"] = rep(freeze(m_t, ss["chees_m"][:, 0]))
        new_ss["chees_v"] = rep(freeze(v_t, ss["chees_v"][:, 0]))
        new_ss["chees_tlen"] = rep(new_tlen)
        return new_ss

    def draws(rng, x, blk):
        """The momenta ``r0 [T, D, C]`` and jitter ``u [T, C]`` of block ``blk``."""
        r0 = blk.draw(torch.randn, rng, ("T", x.shape[1], "C"), x.device)
        u = blk.draw(torch.rand, rng, ("T", "C"), x.device) * (1.0 - 1e-3) + 1e-3
        return r0, u

    def chees(rng, x, betas, it, ctx, ss):
        return core(x, betas, it, ctx, ss, *draws(rng, x, block_of(ctx, x)))

    def local(rng, x, betas, ctx, ss):
        """The per-chain part of a ChEES step on a piece of a ``per_chain``
        rotation slice (``ctx.block``, ``utils.Block.piece``), whose
        adaptation needs the slice's chains on every rank: ``(q, qxy,
        stats)``, ``stats`` the ``(q0, z1, r1, alpha, u)`` that
        :func:`adapt` reads. A piece of no chains only draws."""
        r0, u = draws(rng, x, block_of(ctx, x))
        if x.shape[2] == 0:
            t, d = x.shape[:2]
            empty = x.new_empty((t, 0))
            return x, empty, (x, x, x, empty, empty)
        x1, q0, z1, r1, qxy, alpha = step(x, betas, ctx, ss, r0, u)
        return x1, qxy, (q0, z1, r1, alpha, u)

    chees.core = core
    chees.local = local
    chees.adapt = adapt
    return chees
