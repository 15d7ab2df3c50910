"""HMC trajectory kernel: wrapper, plain version and binding.

``hmc_trajectories`` runs, for every chain of the ``[T, C]`` batch, a
whitened leapfrog trajectory with one fixed step size to the chain's own
length ``nsteps``, leaving it at the break test ``(joint1 - 1000) < joint0``,
and returns the end position and the kinetic-energy correction ``qxy``. It
is the port of ``ptmcmcsampler_tpu/ops/hmc_pallas.py::_trajectory_kernel``.
The break test is the reference's (nutsjump.py:285-287), as the JAX package
keeps it; it holds unless a step raises the joint by 1000 or more, so nearly
every trajectory ends after its first step.

* On a CUDA tensor the wrapper launches the hand-written kernel in
  ``csrc/hmc_trajectory.cu`` (one thread per chain) or raises.
* On a CPU tensor it runs ``hmc_trajectories_plain``, the same function as
  masked PyTorch steps, which the tests hold to the JAX package and
  ``chip_smoke.py`` holds the kernel to on the card.

``hmc_trajectories.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import common


def hmc_trajectories_plain(q0, p0, beta, nsteps, chol, eps, model):
    """Plain PyTorch version of the kernel (same arguments and results).

    The loop runs to the largest ``nsteps`` and masks each chain past its
    own length or its break, as the Pallas kernel's masked loop.
    """
    e = torch.tensor(eps, dtype=torch.float32, device=q0.device)
    half = 0.5 * e
    fgw = common.whitened(model, chol, beta[:, None])

    logp0, g = fgw(q0)
    joint0 = common.log_hamiltonian(logp0, p0)
    q, p, logp, joint = q0, p0, logp0, joint0
    alive = torch.ones_like(logp0, dtype=torch.bool)
    for i in range(int(nsteps.max())):  # a host read: CPU tensors only
        take = alive & (nsteps > i)
        take_d = take[:, None, :]
        ph = p + half * g
        qn = q + e * ph
        logpn, gn = fgw(qn)
        pn = ph + half * gn
        jn = common.log_hamiltonian(logpn, pn)
        stop = (jn - 1000.0) < joint0
        q = torch.where(take_d, qn, q)
        p = torch.where(take_d, pn, p)
        g = torch.where(take_d, gn, g)
        logp = torch.where(take, logpn, logp)
        joint = torch.where(take, jn, joint)
        alive = alive & ~(take & stop)
    qxy = (joint - joint0) - (logp - logp0)
    return q, torch.where(torch.isnan(qxy), float("-inf"), qxy)


def hmc_trajectories(q0, p0, beta, nsteps, chol, eps, model):
    """End positions and MH corrections of fixed-step HMC trajectories.

    Args:
      q0, p0: ``[T, D, C]`` f32 whitened positions and momenta.
      beta:   ``[T]`` f32 inverse temperatures.
      nsteps: ``[T, C]`` int32 trajectory lengths.
      chol:   ``[D, D]`` f32 Cholesky factor of the mass-matrix inverse.
      eps:    the step size, a Python float (``hmc_stepsize``).
      model:  gives ``value_grad`` (plain version) and ``cuda_functor``.
    Returns:
      ``(q1 [T, D, C], qxy [T, C])`` with ``qxy = (joint1 - joint0) -
      (logp1 - logp0)``, NaN mapped to -inf.
    """
    if common.check_device("hmc_trajectories", q0):
        return hmc_trajectories_plain(q0, p0, beta, nsteps, chol, eps, model)
    t, d, c = q0.shape
    functor = common.cuda_functor("HMC trajectory", model, d)
    f32 = torch.float32
    common.check_args("hmc_trajectories", q0.device, {
        "q0": (q0, (t, d, c), f32), "p0": (p0, (t, d, c), f32),
        "beta": (beta, (t,), f32), "nsteps": (nsteps, (t, c), torch.int32),
        "chol": (chol, (d, d), f32),
    })
    if t * c >= 2**31:
        raise ValueError("hmc_trajectories: more than 2**31 - 1 chains")
    q1 = torch.empty_like(q0)
    qxy = torch.empty((t, c), dtype=f32, device=q0.device)
    fn = common.entry(
        "hmc_trajectory", f"hmc_trajectory_{functor}",
        [ctypes.c_void_p] * 5 + [ctypes.c_float] + [ctypes.c_void_p] * 2
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    )
    common.launch(
        "hmc_trajectory", fn, q0.device,
        q0.data_ptr(), p0.data_ptr(), beta.data_ptr(), nsteps.data_ptr(), chol.data_ptr(),
        float(eps), q1.data_ptr(), qxy.data_ptr(), t, c,
    )
    hmc_trajectories.launches += 1
    return q1, qxy


hmc_trajectories.launches = 0
