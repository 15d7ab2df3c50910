"""Gradient jumps: whitened leapfrog dynamics, MALA, HMC and the step-size
search of NUTS, batched over the whole ``[T, D, C]`` block.

Whitening goes through the Cholesky factor of the mass-matrix inverse, as
the reference's ``set_cf``/``forward``/``backward``/``func_grad_white``
(nutsjump.py:51-90): ``q = chol_inv^T x``, ``x = chol^T q``, and the
whitened gradient is ``chol @ grad``.

* ``make_mala`` (nutsjump.py:182-235): a one-eigenvector Langevin step with
  the corrected forward/backward density ratio of the JAX package
  (``ptmcmcsampler_tpu/proposals/gradient.py`` make_mala).
* ``make_hmc`` (nutsjump.py:238-291): fixed step size, trajectory length
  drawn from ``[hmc_nminsteps, hmc_nmaxsteps)``, the reference's break test
  (which ends nearly every trajectory after one step, see ops/hmc.py), and
  the kinetic-energy correction as ``qxy``. The whole per-chain step runs in
  :func:`ptmcmcsampler_torch.ops.hmc.hmc_step`: the branch draws only a
  two-word Philox key, from which the kernel draws each chain's momenta and
  length.
* ``find_reasonable_epsilon`` (nutsjump.py:435-463), every lane at once.

Each jump has a deterministic ``core`` that takes its randomness as
arguments and a drawing wrapper with the branch signature of
:mod:`ptmcmcsampler_torch.proposals.base`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.common import log_hamiltonian as loghamiltonian  # nutsjump.py:96-101
from ..ops.hmc import hmc_step
from ..utils import block_of


def make_whitened_funcs(value_grad):
    """Whitened-space helpers around a tempered ``value_grad(x, beta)``
    (``x [T, D, C]``, ``beta`` broadcastable to ``[T, C]``)."""

    def forward(ctx, x):
        return ctx.chol_inv.T @ x

    def backward(ctx, q):
        return ctx.chol.T @ q

    def func_grad_white(ctx, q, beta):
        fv, fg = value_grad(backward(ctx, q), beta)
        return fv, ctx.chol @ fg

    return forward, backward, func_grad_white


def leapfrog(func_grad_white, ctx, beta, theta, r, grad, epsilon):
    """One leapfrog step in whitened coordinates (nutsjump.py:149-169);
    ``epsilon`` broadcasts against ``theta``."""
    rprime = r + 0.5 * epsilon * grad
    thetaprime = theta + epsilon * rprime
    logpprime, gradprime = func_grad_white(ctx, thetaprime, beta)
    rprime = rprime + 0.5 * epsilon * gradprime
    return thetaprime, rprime, gradprime, logpprime


def make_mala(config, model):
    forward, backward, fgw = make_whitened_funcs(model.value_grad)
    ndim = config.ndim
    cdt = np.float32(2.4) / np.sqrt(np.float32(ndim))  # cd, rounded to f32

    def core(x, betas, ctx, ind, dist):
        """``ind`` long ``[T, C]`` in ``[0, ndim)``: the whitened axis of the
        step; ``dist`` standard normal ``[T, C]``. Returns ``(q, qxy)``."""
        beta = betas[:, None]
        q0 = forward(ctx, x)
        _, grad0 = fgw(ctx, q0, beta)
        # Whitened space: eigenvectors are the identity, eigenvalues 1
        # (nutsjump.py:193-198).
        vec = torch.nn.functional.one_hot(ind, ndim).to(x.dtype).movedim(-1, 1)  # [T, D, C]
        cd2 = float(cdt * cdt)

        def drift(q, grad):
            return q + 0.5 * vec * cd2 * torch.sum(vec * grad, dim=1, keepdim=True) / 2.0

        mq0 = drift(q0, grad0)
        q1 = mq0 + dist[:, None, :] * vec * float(cdt)
        _, grad1 = fgw(ctx, q1, beta)
        mq1 = drift(q1, grad1)
        # The Gaussian proposal's forward/backward correction with its 1/cd^2
        # normalisation, which the reference omits (nutsjump.py:233).
        qxy = 0.5 * (
            torch.sum((mq0 - q1) ** 2, dim=1) - torch.sum((mq1 - q0) ** 2, dim=1)
        ) / cd2
        qxy = torch.where(torch.isnan(qxy), float("-inf"), qxy)
        return backward(ctx, q1), qxy

    def mala(rng, x, betas, it, ctx, ss):
        blk = block_of(ctx, x)
        ind = blk.draw(torch.randint, rng, ("T", "C"), x.device, 0, ndim)
        dist = blk.draw(torch.randn, rng, ("T", "C"), x.device)
        q, qxy = core(x, betas, ctx, ind, dist)
        return q, qxy, ss

    mala.core = core
    return mala


def make_hmc(config, model):
    nmin, nmax = config.hmc_nminsteps, config.hmc_nmaxsteps
    eps = float(config.hmc_stepsize)

    def core(x, betas, ctx, draws):
        """``draws``: the Philox key of the momenta and lengths (int64
        ``[2]``) or, on the CPU, the draws as arrays ``(p0 [T, D, C]
        standard-normal momenta, nsteps [T, C] int32 lengths)``. Returns
        ``(q, qxy)``: the end point mapped back to the original space and
        ``(joint1 - joint0) - (logp1 - logp0)``, so the outer MH ratio equals
        the Hamiltonian error. A sharded batch (``ctx.block``) draws under
        its chains' unsharded counter words; a batch of no chains launches
        nothing."""
        if x.shape[2] == 0:
            return x, x.new_empty((x.shape[0], 0))
        blk = block_of(ctx, x)
        return hmc_step(x, betas, draws, ctx.chol.contiguous(), ctx.chol_inv.contiguous(), eps,
                        nmin, nmax, model, ctx.structure, n0=blk.n0, c_total=blk.nchains)

    def hmc(rng, x, betas, it, ctx, ss):
        key = torch.randint(0, 2**32, (2,), generator=rng, device=x.device, dtype=torch.int64)
        q, qxy = core(x, betas, ctx, key)
        return q, qxy, ss

    hmc.core = core
    return hmc


def _bad(logp, grad):
    """Lanes where logp or any gradient component is inf or NaN."""
    return ~torch.isfinite(logp) | ~torch.all(torch.isfinite(grad), dim=1)


def find_reasonable_epsilon(fgw, ctx, beta, theta0, grad0, logp0, r0, max_iters=64):
    """The step-size doubling heuristic (nutsjump.py:435-463) for every lane
    of the batch at once.

    ``theta0, grad0, r0 [T, D, C]`` (``r0`` standard normal), ``logp0
    [T, C]``, ``beta [T]``. The JAX package's two per-lane while loops become
    loops over masked lanes, each bounded by ``max_iters`` and left early once
    no lane is still searching (which reads the device). It is the plain
    version of the NUTS tree kernel's search (``ops/nuts.py``), run on the
    CPU. Returns ``eps [T, C]``.
    """
    b = beta[:, None]

    def lf(eps):
        return leapfrog(fgw, ctx, b, theta0, r0, grad0, eps[:, None, :])

    one = torch.ones_like(logp0)
    # Shrink until logp and grad are finite (nutsjump.py:446-451): k halves
    # from 2 while the leapfrog at k is bad; lanes that start good keep k = 1.
    _, _, gradp, logpp = lf(one)
    bad0 = _bad(logpp, gradp)
    k = 2.0 * one
    bad = bad0
    for _ in range(max_iters):
        if not bool(bad.any()):
            break
        k = torch.where(bad, k * 0.5, k)
        _, _, gradp, logpp = lf(k)
        bad = bad & _bad(logpp, gradp)
    k = torch.where(bad0, k, one)

    epsilon = 0.5 * k
    joint0 = loghamiltonian(logp0, r0)

    def accept_prob(eps):
        _, rprime, _, logpprime = lf(eps)
        ap = torch.exp(loghamiltonian(logpprime, rprime) - joint0)
        return torch.where(torch.isnan(ap), 0.0, ap)

    ap = accept_prob(epsilon)
    a = torch.where(ap > 0.5, 1.0, -1.0)
    going = torch.pow(ap, a) > torch.pow(2.0, -a)
    for _ in range(max_iters):
        if not bool(going.any()):
            break
        epsilon = torch.where(going, epsilon * torch.pow(2.0, a), epsilon)
        ap = torch.where(going, accept_prob(epsilon), ap)
        going = going & (torch.pow(ap, a) > torch.pow(2.0, -a))
    return torch.clamp(epsilon, min=1e-8)

