"""ChEES trajectory kernel and fused ChEES step: wrappers, plain versions
and binding.

``chees_trajectories`` runs, for every chain of the ``[T, C]`` batch, a
whitened leapfrog trajectory of its own length ``nsteps`` with its own step
size, and returns the end point ``(q1, p1, logp1)``. It is the port of
``ptmcmcsampler_tpu/ops/chees_pallas.py::_chees_kernel``.

``chees_step`` is the per-chain part of a ChEES step around the same
trajectory (``proposals/chees.py``): the step size and jittered length from
the step-size state, the whitening, the trajectory, the kinetic energies,
``qxy``, the acceptance probability and the end point mapped back. It is
the same kernel with its prologue and epilogue, so a ChEES iteration pays
one launch for all of it.

* On a CUDA tensor each wrapper launches the hand-written kernel in
  ``csrc/chees_trajectory.cu`` or raises: a model without a device functor
  for it, a wrong shape, type or layout, or a failed launch all raise. The
  curved model (D = 2) runs one thread a chain with its vectors in
  registers; the wide models (``correlated_gaussian``,
  ``interval_gaussian``, ``hierarchical_gaussian``, any D up to
  ``common.WIDE_MAX_D``, and a registered user functor at its dims, from its
  own library: ``ops/user.py``) run the wide layout, groups of
  ``common.wide_group(D)`` chains (64 down to 4) with their vectors in
  shared memory, and take the model's constants (``model.cuda_params``).
  Both order each block's 256 chains by length.
* On a CPU tensor it runs its plain version, the same function written as a
  loop of masked PyTorch steps in the kernel's operation order. The tests
  hold it to the JAX package, and ``chip_smoke.py`` holds the kernel to it
  on the card.

``chees_trajectories.launches`` and ``chees_step.launches`` count the
kernel's launches through each entry.
"""

from __future__ import annotations

import ctypes

import torch

from . import common

# The kernel's block, and its warps: each block orders its chains by length
# (csrc/chees_trajectory.cu), lengths of SORT_BINS - 1 or more sharing a bin.
BLOCK = 256
WARP = 32
SORT_BINS = 256


def _trajectories_plain(q0, p0, beta, eps, nsteps, chol, model, structure):
    """``(q1, p1, logp1, logp0)``: the kernel's trajectory and its first
    evaluation. Each chain stops at its own ``nsteps``: the loop runs to the
    largest and masks the rest, which equals the Pallas kernel's masked loop
    exactly."""
    eps_b = eps[:, None, :]
    half = 0.5 * eps_b
    fgw = common.whitened(model, chol, beta[:, None], structure)

    logp0, g = fgw(q0)
    q, p, logp = q0, p0, logp0
    for i in range(int(nsteps.max())):  # a host read: CPU tensors only
        take = nsteps > i
        take_d = take[:, None, :]
        ph = p + half * g
        qn = q + eps_b * ph
        logpn, gn = fgw(qn)
        pn = ph + half * gn
        q = torch.where(take_d, qn, q)
        p = torch.where(take_d, pn, p)
        g = torch.where(take_d, gn, g)
        logp = torch.where(take, logpn, logp)
    return q, p, torch.where(torch.isnan(logp), float("-inf"), logp), logp0


def chees_trajectories_plain(q0, p0, beta, eps, nsteps, chol, model, structure="dense"):
    """Plain PyTorch version of the trajectory entry (same arguments and
    results). Raises if ``chol`` has nonzeros outside ``structure``."""
    common.check_structure("chees_trajectories", structure, chol)
    structure = common.kernel_structure(model, structure)
    return _trajectories_plain(q0, p0, beta, eps, nsteps, chol, model, structure)[:3]


def chees_trajectories(q0, p0, beta, eps, nsteps, chol, model, structure="dense"):
    """End points of whitened leapfrog trajectories, one per chain.

    Args:
      q0, p0: ``[T, D, C]`` f32 whitened positions and momenta.
      beta:   ``[T]`` f32 inverse temperatures.
      eps:    ``[T, C]`` f32 step sizes.
      nsteps: ``[T, C]`` int32 trajectory lengths, >= 1.
      chol:   ``[D, D]`` f32 Cholesky factor of the mass-matrix inverse.
      model:  gives ``value_grad`` (plain version), ``cuda_functor`` and,
              for a wide functor, ``cuda_params``.
      structure: the factor's structure tag (``common.STRUCTURES``), worked
              out where the factor was made; the wide entries skip the terms
              it zeroes, the curved one multiplies every term.
    Returns:
      ``(q1 [T, D, C], p1 [T, D, C], logp1 [T, C])``; a NaN ``logp1`` is -inf.
    """
    if common.check_device("chees_trajectories", q0):
        return chees_trajectories_plain(q0, p0, beta, eps, nsteps, chol, model, structure)
    t, d, c = q0.shape
    functor = common.cuda_functor("chees", model, d, "chees_trajectories")
    f32 = torch.float32
    common.check_args("chees_trajectories", q0.device, {
        "q0": (q0, (t, d, c), f32), "p0": (p0, (t, d, c), f32),
        "beta": (beta, (t,), f32), "eps": (eps, (t, c), f32),
        "nsteps": (nsteps, (t, c), torch.int32), "chol": (chol, (d, d), f32),
    })
    if t * c >= 2**31:
        raise ValueError("chees_trajectories: more than 2**31 - 1 chains")
    q1 = torch.empty_like(q0)
    p1 = torch.empty_like(p0)
    logp1 = torch.empty((t, c), dtype=f32, device=q0.device)
    ptrs, dims = (q0, p0, beta, eps, nsteps, chol), (t, c)
    if functor != "curved":  # a wide entry: the model's constants, the structure, D
        ptrs += (common.cuda_params("chees_trajectories", model, functor, q0.device),)
        dims = (common.structure_code("chees_trajectories", structure), d, t, c)
    ptrs += (q1, p1, logp1)
    fn = common.entry(
        "chees_trajectory", functor, f"chees_trajectory_{functor}",
        [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * len(dims) + [ctypes.c_void_p],
    )
    common.launch("chees_trajectory", fn, q0.device, *(a.data_ptr() for a in ptrs), *dims)
    chees_trajectories.launches += 1
    return q1, p1, logp1


chees_trajectories.launches = 0


def chees_step_plain(x, r0, u, beta, eps, tlen, eps0, max_steps, chol, chol_inv, model,
                     structure="dense"):
    """Plain PyTorch version of the fused step (same arguments and results).

    Every product over ``D`` is an ordered sum (``common.matvec``,
    ``common.rdot``), not ``torch.matmul``, so that it rounds as the kernel.
    Raises if a factor has nonzeros outside ``structure``.
    """
    common.check_structure("chees_step", structure, chol, chol_inv)
    structure = common.kernel_structure(model, structure)
    eps_tc = torch.where(eps > 0, eps, eps0)
    tlen_tc = torch.maximum(tlen, eps_tc)
    nsteps = torch.clamp(torch.ceil(u * tlen_tc / eps_tc), 1, max_steps).to(torch.int32)
    q0 = common.matvec(chol_inv.T, x, structure)
    z1, r1, logp1, logp0 = _trajectories_plain(q0, r0, beta, eps_tc, nsteps, chol, model,
                                               structure)
    k0 = 0.5 * common.rdot(r0, r0)
    k1 = 0.5 * common.rdot(r1, r1)
    denergy = (logp1 - k1) - (logp0 - k0)
    denergy = torch.where(torch.isnan(denergy), float("-inf"), denergy)
    qxy = k0 - k1
    qxy = torch.where(torch.isnan(qxy), float("-inf"), qxy)
    alpha = torch.clamp(torch.exp(denergy), max=1.0)
    return common.matvec(chol.T, z1, structure), q0, z1, r1, qxy, alpha


def chees_step(x, r0, u, beta, eps, tlen, eps0, max_steps, chol, chol_inv, model,
               structure="dense"):
    """The per-chain part of a ChEES step, one trajectory a chain.

    Args:
      x:        ``[T, D, C]`` f32 positions.
      r0:       ``[T, D, C]`` f32 standard-normal momenta.
      u:        ``[T, C]`` f32 jitter in ``[1e-3, 1)``.
      beta:     ``[T]`` f32 inverse temperatures.
      eps:      ``[T, C]`` f32 step sizes (``chees_eps``); ``<= 0`` takes ``eps0``.
      tlen:     ``[T, C]`` f32 trajectory lengths (``chees_tlen``), at least eps.
      eps0:     the fallback step size, a Python float (``hmc_stepsize``).
      max_steps: the cap on a trajectory's steps, a Python int.
      chol, chol_inv: ``[D, D]`` f32 Cholesky factor of the mass-matrix
                inverse and its inverse.
      model:    gives ``value_grad`` (plain version), ``cuda_functor`` and,
                for a wide functor, ``cuda_params``.
      structure: the factors' structure tag (``common.STRUCTURES``), worked
                out where they were made (``state.AdaptState.structure``).
    Returns:
      ``(x1, q0, z1, r1, qxy, alpha)``: ``x1 = chol^T z1`` the proposal,
      ``q0 = chol_inv^T x`` the whitened start, ``(z1, r1)`` the end point
      (``[T, D, C]``), ``qxy = k0 - k1`` and ``alpha = min(1, exp(dH))``
      (``[T, C]``, NaN mapped to -inf before ``exp``).
    """
    if common.check_device("chees_step", x):
        return chees_step_plain(x, r0, u, beta, eps, tlen, eps0, max_steps, chol, chol_inv,
                                model, structure)
    t, d, c = x.shape
    functor = common.cuda_functor("chees", model, d, "chees_step")
    f32 = torch.float32
    common.check_args("chees_step", x.device, {
        "x": (x, (t, d, c), f32), "r0": (r0, (t, d, c), f32), "u": (u, (t, c), f32),
        "beta": (beta, (t,), f32), "eps": (eps, (t, c), f32), "tlen": (tlen, (t, c), f32),
        "chol": (chol, (d, d), f32), "chol_inv": (chol_inv, (d, d), f32),
    })
    if t * c >= 2**31:
        raise ValueError("chees_step: more than 2**31 - 1 chains")
    if not 1 <= max_steps < 2**31:
        raise ValueError(f"chees_step: max_steps {max_steps} is not in [1, 2**31)")
    points = torch.empty((4, t, d, c), dtype=f32, device=x.device)
    scalars = torch.empty((2, t, c), dtype=f32, device=x.device)
    x1, q0, z1, r1 = points.unbind(0)
    qxy, alpha = scalars.unbind(0)
    ins = (x, r0, u, beta, eps, tlen, chol, chol_inv)
    outs = (x1, q0, z1, r1, qxy, alpha)
    dims = (t, c)
    if functor != "curved":  # a wide entry: the model's constants, the structure, D
        ins += (common.cuda_params("chees_step", model, functor, x.device),)
        dims = (common.structure_code("chees_step", structure), d, t, c)
    fn = common.entry(
        "chees_trajectory", functor, f"chees_step_{functor}",
        [ctypes.c_void_p] * len(ins) + [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 6
        + [ctypes.c_int] * len(dims) + [ctypes.c_void_p],
    )
    common.launch(
        "chees_step", fn, x.device, *(a.data_ptr() for a in ins), float(eps0), int(max_steps),
        *(a.data_ptr() for a in outs), *dims,
    )
    chees_step.launches += 1
    return x1, q0, z1, r1, qxy, alpha


chees_step.launches = 0


def lane_efficiency(nsteps, grouped=True, lanes=WARP):
    """Share of the lane-steps a batch issues that do work: ``sum(nsteps) /
    (lanes * sum over units of the unit's largest nsteps)``, a unit being
    ``lanes`` consecutive threads (a warp of the curved kernel, or a group
    of the wide layout, ``lanes=common.wide_group(D)``, which steps together).

    ``nsteps [T, C]`` in the kernel's lane order: chain ``n = t*C + c`` in
    block ``n // 256``, lanes past ``T*C`` at length 0. ``grouped`` orders
    each block by length as the kernel does (a top bin of ``SORT_BINS - 1``
    and more; within a bin the kernel's order follows its shared atomics,
    this keeps index order); ``grouped=False`` is chain ``n`` on thread ``n``.
    """
    n = nsteps.reshape(-1).to(torch.int64).cpu()
    pad = (-n.numel()) % BLOCK
    units = torch.cat([n, n.new_zeros(pad)]).view(-1, BLOCK)
    if grouped:
        order = torch.argsort(units.clamp(0, SORT_BINS - 1), dim=1, stable=True)
        units = torch.gather(units, 1, order)
    issued = lanes * units.reshape(-1, lanes).max(dim=1).values.sum()
    return float(n.sum()) / float(issued)
