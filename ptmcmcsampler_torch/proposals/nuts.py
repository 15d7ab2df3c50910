"""No-U-Turn sampler jump for the whole ``[T, C]`` batch.

Parity target: ``NUTSJump`` (nutsjump.py:379-840), as the JAX package runs it
through its fused tree kernel (``ptmcmcsampler_tpu/ops/nuts_pallas.py``
``make_nuts_pallas``): slice-sampling NUTS per Hoffman & Gelman (2011)
Algorithm 6, one tree per chain, with all randomness drawn up front, and
dual-averaging step-size adaptation per chain.

* The trees run in :func:`ptmcmcsampler_torch.ops.nuts.nuts_trees`: the
  hand-written CUDA kernel on the card, its plain version on the CPU.
* Every call searches the step size of each lane whose step size is
  ``<= 0`` with ``find_reasonable_epsilon``, as ``make_nuts_pallas`` does
  (nuts_pallas.py:497-515): at a chain's first NUTS call (the state's
  initial -1), and after a dual-averaged step size underflows to 0 (an
  exponent below about -103). The search runs inside the tree kernel, so no
  host read decides it; those lanes restart dual averaging at
  ``mu = log(10 * epsilon)``. ``nuts_force_epsilon`` fixes the step sizes
  instead.
* ``qxy = logp0 - logp_prop``, so the outer MH step always accepts
  (nutsjump.py:837-840).
* Dual averaging uses the reference constants gamma=0.05, t0=10,
  kappa=0.75 (nutsjump.py:414-420) and its update equations (:804-816),
  with ``epsilon = epsilonbar`` after burn-in.

The reservoir's uniforms are not drawn as an array: the branch draws a
two-word Philox key on the device and the kernel computes each leaf's
uniform from it (``ops.nuts.nuts_uniforms`` materialises them for the plain
version).

A depth past 10, ``nuts_force_trajlen`` and the trajectory capture
(``capture``, the step's ``trajectory.TrajCapture``, which each call
overwrites with the tree of chain (T0, C0)) take the tree kernel's general
entry (``ops.nuts.nuts_trees`` picks it from them); the config fixes all
three, so the choice is no part of a graph's key.
"""

from __future__ import annotations

import torch

from ..ops.nuts import nuts_trees
from ..utils import Block, block_of, exponential
from .gradient import make_whitened_funcs

GAMMA = 0.05
T0 = 10.0
KAPPA = 0.75


def draw_nuts(rng, t, d, c, depth, device, block=None):
    """What one NUTS call draws from ``rng``, on ``device``: momenta ``r0``
    and the step-size search's momenta ``r_eps`` ``[T, D, C]`` (standard
    normal), Exp(1) slice draws ``expo [T, C]``, doubling directions ``dirs``
    (+-1) and accept uniforms ``accu`` ``[depth, T, C]``, and the reservoir's
    Philox key ``[2]`` (int64 words in ``[0, 2**32)``). Nothing is read to
    the host. With a ``block`` (``utils.Block``) each is its block of the
    unsharded draw. Returns ``(r0, expo, dirs, accu, key, r_eps)``."""
    blk = Block(t, c) if block is None else block
    r0 = blk.draw(torch.randn, rng, ("T", d, "C"), device)
    expo = blk.draw(exponential, rng, ("T", "C"), device)
    dirs = torch.where(blk.draw(torch.rand, rng, (depth, "T", "C"), device) < 0.5, -1.0, 1.0)
    accu = blk.draw(torch.rand, rng, (depth, "T", "C"), device)
    key = torch.randint(0, 2**32, (2,), generator=rng, device=device, dtype=torch.int64)
    r_eps = blk.draw(torch.randn, rng, ("T", d, "C"), device)
    return r0, expo, dirs, accu, key, r_eps


def make_nuts(config, model, capture=None):
    forward, backward, _ = make_whitened_funcs(model.value_grad)
    depth = config.nuts_max_depth
    delta = config.nuts_delta
    force_eps = config.nuts_force_epsilon
    nburn = config.burn
    tree_kw = dict(force_trajlen=config.nuts_force_trajlen, capture=capture)

    def core(x, betas, it, ctx, ss, r0, expo, dirs, accu, draws, r_eps):
        """Deterministic NUTS step.

        ``r0 [T, D, C]`` standard-normal momenta; ``expo [T, C]`` Exp(1)
        slice draws; ``dirs [depth, T, C]`` doubling directions (+-1);
        ``accu [depth, T, C]`` uniforms; ``draws`` the reservoir's Philox
        key (int64 ``[2]``) or, on the CPU, its uniforms ``[2**depth - 1, T,
        C]``; ``r_eps [T, D, C]`` the step-size search's momenta (read by
        lanes with ``epsilon <= 0``). Returns ``(q, qxy, ss)``. A batch of no
        chains (a rank's empty part of a ``per_chain`` slice) launches
        nothing.
        """
        if x.shape[2] == 0:
            return x, x.new_empty((x.shape[0], 0)), ss
        q0 = forward(ctx, x).contiguous()
        blk = block_of(ctx, x)
        eps_state = ss["epsilon"]
        if force_eps is not None:
            eps_in, r_search = torch.full_like(eps_state, force_eps), None
        else:
            eps_in, r_search = eps_state, r_eps.contiguous()
        q_prop, logp0, logp_prop, alpha, nalpha, _, epsilon = nuts_trees(
            q0, r0.contiguous(), betas, eps_in.contiguous(), expo.contiguous(),
            dirs.contiguous(), accu.contiguous(), draws.contiguous(),
            ctx.chol.contiguous(), model, r_eps=r_search, structure=ctx.structure, **tree_kw,
            n0=blk.n0, c_total=blk.nchains,
        )
        if force_eps is not None:
            mu = torch.log(10.0 * epsilon)
        else:
            mu = torch.where(eps_state <= 0, torch.log(10.0 * epsilon), ss["mu"])
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

    def nuts(rng, x, betas, it, ctx, ss):
        t, d, c = x.shape
        return core(x, betas, it, ctx, ss,
                    *draw_nuts(rng, t, d, c, depth, x.device, block_of(ctx, x)))

    nuts.core = core
    return nuts
