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

from . import build

# Device functors compiled into csrc/chees_trajectory.cu, by the name a model
# gives in ``cuda_functor``, with the dimension each is compiled for.
FUNCTOR_NDIM = {"curved": 2}


def _matvec(m, v):
    """``m @ v`` for ``m [D, D]``, ``v [T, D, C]``, summed over k in order with
    one rounding per product and per sum, as the kernel does."""
    out = m[None, :, 0, None] * v[:, 0:1]
    for k in range(1, m.shape[1]):
        out = out + m[None, :, k, None] * v[:, k:k + 1]
    return out


def chees_trajectories_plain(q0, p0, beta, eps, nsteps, chol, model):
    """Plain PyTorch version of the kernel (same arguments and results).

    Each chain stops at its own ``nsteps``: the loop runs to the largest and
    masks the rest, which equals the Pallas kernel's masked loop exactly.
    """
    eps_b = eps[:, None, :]
    half = 0.5 * eps_b
    beta_b = beta[:, None]

    def fgw(q):
        val, g = model.value_grad(_matvec(chol.T, q), beta_b)
        return val, _matvec(chol, g)

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


def _function(functor):
    lib = build.load("chees_trajectory")
    fn = getattr(lib, f"chees_trajectory_{functor}")
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


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
    if q0.device.type == "cpu":
        return chees_trajectories_plain(q0, p0, beta, eps, nsteps, chol, model)
    if q0.device.type != "cuda":
        raise ValueError(f"chees_trajectories: unsupported device {q0.device}")
    functor = getattr(model, "cuda_functor", None)
    if functor not in FUNCTOR_NDIM:
        raise NotImplementedError(
            f"model {type(model).__name__} has no CUDA device functor for the "
            "ChEES trajectory kernel (csrc/chees_trajectory.cu)"
        )
    t, d, c = q0.shape
    if d != FUNCTOR_NDIM[functor]:
        raise ValueError(f"functor {functor!r} is compiled for D={FUNCTOR_NDIM[functor]}, got {d}")
    expect = {
        "q0": (q0, (t, d, c), torch.float32), "p0": (p0, (t, d, c), torch.float32),
        "beta": (beta, (t,), torch.float32), "eps": (eps, (t, c), torch.float32),
        "nsteps": (nsteps, (t, c), torch.int32), "chol": (chol, (d, d), torch.float32),
    }
    for name, (a, shape, dtype) in expect.items():
        if tuple(a.shape) != shape or a.dtype != dtype or a.device != q0.device:
            raise ValueError(
                f"chees_trajectories: {name} is {tuple(a.shape)} {a.dtype} on {a.device}, "
                f"expected {shape} {dtype} on {q0.device}"
            )
        if not a.is_contiguous():
            raise ValueError(f"chees_trajectories: {name} is not contiguous")
    if t * c >= 2**31:
        raise ValueError("chees_trajectories: more than 2**31 - 1 chains")
    q1 = torch.empty_like(q0)
    p1 = torch.empty_like(p0)
    logp1 = torch.empty((t, c), dtype=torch.float32, device=q0.device)
    fn = _function(functor)
    stream = torch.cuda.current_stream(q0.device).cuda_stream
    with torch.cuda.device(q0.device):
        err = fn(
            q0.data_ptr(), p0.data_ptr(), beta.data_ptr(), eps.data_ptr(),
            nsteps.data_ptr(), chol.data_ptr(), q1.data_ptr(), p1.data_ptr(),
            logp1.data_ptr(), t, c, stream,
        )
    chees_trajectories.launches += 1
    if err != 0:
        raise RuntimeError(f"chees_trajectory kernel launch failed: CUDA error {err}")
    return q1, p1, logp1


chees_trajectories.launches = 0
