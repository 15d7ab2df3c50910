"""ChEES trajectory kernel: wrapper, plain version and binding.

``chees_trajectories`` runs, for every chain of the ``[T, C]`` batch, a
whitened leapfrog trajectory of its own length ``nsteps`` with its own step
size, and returns the end point ``(q1, p1, logp1)``. It is the port of
``ptmcmcsampler_tpu/ops/chees_pallas.py::_chees_kernel``.

* On a CUDA tensor the wrapper launches the hand-written kernel in
  ``csrc/chees_trajectory.cu`` (one thread per chain) or raises: a model
  without a device functor, a wrong shape, type or layout, or a failed
  launch all raise.
* On a CPU tensor it runs ``chees_trajectories_plain``, the same function
  written as a loop of masked PyTorch steps. The tests hold it to the JAX
  package, and ``chip_smoke.py`` holds the kernel to it on the card.

``chees_trajectories.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import common


def chees_trajectories_plain(q0, p0, beta, eps, nsteps, chol, model):
    """Plain PyTorch version of the kernel (same arguments and results).

    Each chain stops at its own ``nsteps``: the loop runs to the largest and
    masks the rest, which equals the Pallas kernel's masked loop exactly.
    """
    eps_b = eps[:, None, :]
    half = 0.5 * eps_b
    fgw = common.whitened(model, chol, beta[:, None])

    logp, g = fgw(q0)
    q, p = q0, p0
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
    return q, p, torch.where(torch.isnan(logp), float("-inf"), logp)


def chees_trajectories(q0, p0, beta, eps, nsteps, chol, model):
    """End points of whitened leapfrog trajectories, one per chain.

    Args:
      q0, p0: ``[T, D, C]`` f32 whitened positions and momenta.
      beta:   ``[T]`` f32 inverse temperatures.
      eps:    ``[T, C]`` f32 step sizes.
      nsteps: ``[T, C]`` int32 trajectory lengths, >= 1.
      chol:   ``[D, D]`` f32 Cholesky factor of the mass-matrix inverse.
      model:  gives ``value_grad`` (plain version) and ``cuda_functor``.
    Returns:
      ``(q1 [T, D, C], p1 [T, D, C], logp1 [T, C])``; a NaN ``logp1`` is -inf.
    """
    if common.check_device("chees_trajectories", q0):
        return chees_trajectories_plain(q0, p0, beta, eps, nsteps, chol, model)
    t, d, c = q0.shape
    functor = common.cuda_functor("ChEES trajectory", model, d)
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
    fn = common.entry(
        "chees_trajectory", f"chees_trajectory_{functor}",
        [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    )
    ptrs = (q0, p0, beta, eps, nsteps, chol, q1, p1, logp1)
    common.launch("chees_trajectory", fn, q0.device, *(a.data_ptr() for a in ptrs), t, c)
    chees_trajectories.launches += 1
    return q1, p1, logp1


chees_trajectories.launches = 0
