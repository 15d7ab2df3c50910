"""HMC trajectory kernel and fused HMC step: wrappers, plain versions, the
step's draws and binding.

``hmc_trajectories`` runs, for every chain of the ``[T, C]`` batch, a
whitened leapfrog trajectory with one fixed step size to the chain's own
length ``nsteps``, leaving it at the break test ``(joint1 - 1000) < joint0``,
and returns the end position and the kinetic-energy correction ``qxy``. It
is the port of ``ptmcmcsampler_tpu/ops/hmc_pallas.py::_trajectory_kernel``.
The break test is the reference's (nutsjump.py:285-287), as the JAX package
keeps it; it holds unless a step raises the joint by 1000 or more, so nearly
every trajectory ends after its first step.

``hmc_step`` is the whole per-chain HMC step around the same trajectory
(``proposals/gradient.py`` make_hmc): the whitening ``q0 = chol_inv^T x``,
the momenta and length drawn from a two-word Philox key, the trajectory and
the end point mapped back, ``x1 = chol^T q1``. It is the same kernel with
its prologue and epilogue, so an HMC iteration pays one launch for all of
it, and no momentum or length array exists on the path.

* Draws: chain ``n = t*C + c`` takes Philox4x32-10 at counters ``(j, n,
  STREAM_HMC, 0)`` (``csrc/philox.cuh``); momentum pair ``m`` comes from
  words ``2m, 2m + 1`` by Box-Muller, the length from word ``2 ceil(D/2)``
  as ``nmin + (w * (nmax - nmin) >> 32)`` (``csrc/hmc_trajectory.cu`` has
  the layout). ``hmc_draws`` computes them in PyTorch: ``nsteps`` bit for
  bit, ``p0`` up to the rounding of ``log``, ``sin`` and ``cos`` between
  math libraries.
* On a CUDA tensor each wrapper launches the hand-written kernel in
  ``csrc/hmc_trajectory.cu`` or raises: a model without a device functor, a
  wrong shape, type or layout, array draws for the fused step, or a failed
  launch all raise. The curved model (D = 2) runs one chain a thread; the
  wide models (``correlated_gaussian``, ``interval_gaussian``,
  ``hierarchical_gaussian``, any D up to ``common.WIDE_MAX_D``, and a
  registered user functor at its dims: ``ops/user.py``) run the wide
  layout, a group of ``common.wide_group(D)`` chains a block (64 down to 4) with
  their vectors in shared memory, and take the model's constants
  (``model.cuda_params``).
* On a CPU tensor it runs its plain version: the same function as masked
  PyTorch steps in the kernel's operation order, the fused step's whitening
  and back-mapping as ordered sums (``common.matvec``). The tests hold the
  plain versions to the JAX package, and ``chip_smoke.py`` holds the kernel
  to them on the card.

``hmc_trajectories.launches`` and ``hmc_step.launches`` count the kernel's
launches through each entry.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import common

# The Philox stream of the HMC draws: word 2 of the counter, != 0 so that it
# never meets the NUTS reservoir's counters (r, n, 0, 0).
STREAM_HMC = 1
TWO_PI_F32 = float(torch.tensor(2.0 * math.pi, dtype=torch.float32))


def hmc_trajectories_plain(q0, p0, beta, nsteps, chol, eps, model, structure="dense"):
    """Plain PyTorch version of the kernel (same arguments and results).

    The loop runs to the largest ``nsteps`` and masks each chain past its
    own length or its break, as the Pallas kernel's masked loop. Raises if
    ``chol`` has nonzeros outside ``structure``.
    """
    common.check_structure("hmc_trajectories", structure, chol)
    e = torch.tensor(eps, dtype=torch.float32, device=q0.device)
    half = 0.5 * e
    fgw = common.whitened(model, chol, beta[:, None], common.kernel_structure(model, structure))

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


def hmc_trajectories(q0, p0, beta, nsteps, chol, eps, model, structure="dense"):
    """End positions and MH corrections of fixed-step HMC trajectories.

    Args:
      q0, p0: ``[T, D, C]`` f32 whitened positions and momenta.
      beta:   ``[T]`` f32 inverse temperatures.
      nsteps: ``[T, C]`` int32 trajectory lengths.
      chol:   ``[D, D]`` f32 Cholesky factor of the mass-matrix inverse.
      eps:    the step size, a Python float (``hmc_stepsize``).
      model:  gives ``value_grad`` (plain version), ``cuda_functor`` and,
              for a wide functor, ``cuda_params``.
      structure: the factor's structure tag (``common.STRUCTURES``); the
              wide entries skip the terms it zeroes.
    Returns:
      ``(q1 [T, D, C], qxy [T, C])`` with ``qxy = (joint1 - joint0) -
      (logp1 - logp0)``, NaN mapped to -inf.
    """
    if common.check_device("hmc_trajectories", q0):
        return hmc_trajectories_plain(q0, p0, beta, nsteps, chol, eps, model, structure)
    t, d, c = q0.shape
    functor = common.cuda_functor("hmc", model, d, "hmc_trajectories")
    f32 = torch.float32
    common.check_args("hmc_trajectories", q0.device, {
        "q0": (q0, (t, d, c), f32), "p0": (p0, (t, d, c), f32),
        "beta": (beta, (t,), f32), "nsteps": (nsteps, (t, c), torch.int32),
        "chol": (chol, (d, d), f32),
    })
    _check_batch("hmc_trajectories", t, c)
    q1 = torch.empty_like(q0)
    qxy = torch.empty((t, c), dtype=f32, device=q0.device)
    ins, dims = (q0, p0, beta, nsteps, chol), (t, c)
    if functor != "curved":  # a wide entry: the model's constants, the structure, D
        ins += (common.cuda_params("hmc_trajectories", model, functor, q0.device),)
        dims = (common.structure_code("hmc_trajectories", structure), d, t, c)
    fn = common.entry(
        "hmc_trajectory", functor, f"hmc_trajectory_{functor}",
        [ctypes.c_void_p] * len(ins) + [ctypes.c_float] + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * len(dims) + [ctypes.c_void_p],
    )
    common.launch(
        "hmc_trajectory", fn, q0.device, *(a.data_ptr() for a in ins), float(eps),
        q1.data_ptr(), qxy.data_ptr(), *dims,
    )
    hmc_trajectories.launches += 1
    return q1, qxy


hmc_trajectories.launches = 0


def _check_batch(fn_name, t, c, n0=0, c_total=None):
    """Checks a launch's batch and counter words; returns ``c_total``
    (``C`` for None)."""
    c_total = c if c_total is None else int(c_total)
    if t * c >= 2**31 or not 0 <= n0 <= 2**32 - t * c_total:
        raise ValueError(f"{fn_name}: more than 2**31 - 1 chains, or counters past 2**32")
    if t > 65535:
        raise ValueError(f"{fn_name}: more than 65535 temperatures (the grid's y extent)")
    return c_total


def _check_lengths(fn_name, nmin, nmax):
    if not 0 <= nmin < nmax < 2**31:
        raise ValueError(f"{fn_name}: lengths [{nmin}, {nmax}) need 0 <= nmin < nmax < 2**31")


def hmc_draws(key, t, d, c, nmin, nmax, n0=0, c_total=None):
    """The momenta and lengths the fused step draws under ``key`` for the
    block of chains ``n0`` and ``c_total`` place in the unsharded batch (the
    counter words, ``common.chain_counters``; 0 and None unsharded).

    ``key``: int64 ``[2]``, words in ``[0, 2**32)``. Returns ``(p0 [T, D, C]
    f32, nsteps [T, C] int32)`` on the key's device, without reading the key
    to the host: ``nsteps`` bit for bit as the kernel draws it, ``p0`` up to
    the rounding of ``log``, ``sin`` and ``cos`` in this library and CUDA's.
    """
    _check_lengths("hmc_draws", nmin, nmax)
    pairs = (d + 1) // 2
    chains = common.chain_counters(t, c, n0, c_total, key.device)
    words = []
    for j in range((2 * pairs + 4) // 4):  # Philox calls a chain
        words += common.philox4x32((j, chains, STREAM_HMC, 0), (key[0], key[1]))
    p = []
    for m in range(pairs):
        u1 = ((words[2 * m] >> 8) + 1).to(torch.float32) * 2.0**-24
        u2 = (words[2 * m + 1] >> 8).to(torch.float32) * 2.0**-24
        r = torch.sqrt(-2.0 * torch.log(u1))
        theta = TWO_PI_F32 * u2
        p += [r * torch.cos(theta), r * torch.sin(theta)]
    p0 = torch.stack(p[:d]).view(d, t, c).transpose(0, 1).contiguous()
    nsteps = nmin + ((words[2 * pairs] * (nmax - nmin)) >> 32)
    return p0, nsteps.to(torch.int32).view(t, c)


def hmc_step_plain(x, beta, draws, chol, chol_inv, eps, nmin, nmax, model, structure="dense",
                   n0=0, c_total=None):
    """Plain PyTorch version of the fused step (the arguments and results of
    ``hmc_step``). ``draws`` is the key, or the draws as arrays ``(p0 [T, D,
    C] f32, nsteps [T, C] int32)``; the key's are ``hmc_draws(key)``. Raises
    if a factor has nonzeros outside ``structure``."""
    common.check_structure("hmc_step", structure, chol, chol_inv)
    kept = common.kernel_structure(model, structure)
    t, d, c = x.shape
    if isinstance(draws, torch.Tensor):
        p0, nsteps = hmc_draws(draws, t, d, c, nmin, nmax, n0, c_total)
    else:
        p0, nsteps = draws
    q0 = common.matvec(chol_inv.T, x, kept)
    q1, qxy = hmc_trajectories_plain(q0, p0, beta, nsteps, chol, eps, model, structure)
    return common.matvec(chol.T, q1, kept), qxy


def hmc_step(x, beta, draws, chol, chol_inv, eps, nmin, nmax, model, structure="dense", n0=0,
             c_total=None):
    """The per-chain part of an HMC step, one trajectory a chain.

    Args:
      x:        ``[T, D, C]`` f32 positions.
      beta:     ``[T]`` f32 inverse temperatures.
      draws:    the Philox key of the momenta and lengths, int64 ``[2]`` with
                words in ``[0, 2**32)``; or, on the CPU only, the draws as
                arrays ``(p0 [T, D, C] f32, nsteps [T, C] int32)``.
      chol, chol_inv: ``[D, D]`` f32 Cholesky factor of the mass-matrix
                inverse and its inverse.
      eps:      the step size, a Python float (``hmc_stepsize``).
      nmin, nmax: the lengths' range ``[nmin, nmax)``, Python ints.
      model:    gives ``value_grad`` (plain version), ``cuda_functor`` and,
                for a wide functor, ``cuda_params``.
      structure: the factors' structure tag (``common.STRUCTURES``).
      n0, c_total: where the block lies in the unsharded batch (the draws'
                counter words, ``common.chain_counters``): 0 and None
                unsharded.
    Returns:
      ``(x1 [T, D, C], qxy [T, C])``: the end point mapped back, ``chol^T
      q1``, and ``qxy = (joint1 - joint0) - (logp1 - logp0)``, NaN mapped
      to -inf.
    """
    if common.check_device("hmc_step", x):
        return hmc_step_plain(x, beta, draws, chol, chol_inv, eps, nmin, nmax, model, structure,
                              n0, c_total)
    if not isinstance(draws, torch.Tensor):
        raise ValueError("hmc_step: on the card the draws are a Philox key (int64 [2]), "
                         "not arrays")
    t, d, c = x.shape
    functor = common.cuda_functor("hmc", model, d, "hmc_step")
    f32 = torch.float32
    common.check_args("hmc_step", x.device, {
        "x": (x, (t, d, c), f32), "beta": (beta, (t,), f32),
        "key": (draws, (2,), torch.int64), "chol": (chol, (d, d), f32),
        "chol_inv": (chol_inv, (d, d), f32),
    })
    c_total = _check_batch("hmc_step", t, c, n0, c_total)
    _check_lengths("hmc_step", nmin, nmax)
    out = torch.empty(t * (d + 1) * c, dtype=f32, device=x.device)
    x1 = out[:t * d * c].view(t, d, c)
    qxy = out[t * d * c:].view(t, c)
    ins, dims = (x, beta, draws, chol, chol_inv), (t, c)
    if functor != "curved":  # a wide entry: the model's constants, the structure, D
        ins += (common.cuda_params("hmc_step", model, functor, x.device),)
        dims = (common.structure_code("hmc_step", structure), d, t, c)
    fn = common.entry(
        "hmc_trajectory", functor, f"hmc_step_{functor}",
        [ctypes.c_void_p] * len(ins) + [ctypes.c_float, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * len(dims)
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    )
    common.launch(
        "hmc_step", fn, x.device, *(a.data_ptr() for a in ins), float(eps), int(nmin),
        int(nmax), x1.data_ptr(), qxy.data_ptr(), *dims, int(n0), c_total,
    )
    hmc_step.launches += 1
    return x1, qxy


hmc_step.launches = 0


def hmc_kernel_draws(key, t, d, c, nmin, nmax, model, n0=0, c_total=None):
    """The draws the fused step's kernel makes under a key on the card, from
    its own draw function (the arguments and results of ``hmc_draws``, and
    the model whose kernel draws): a test entry, to hold them against
    ``hmc_draws`` and to count the steps a batch takes."""
    if common.check_device("hmc_kernel_draws", key):
        raise ValueError("hmc_kernel_draws: the kernel runs on the card, not the CPU")
    functor = common.cuda_functor("hmc", model, d, "hmc_kernel_draws")
    common.check_args("hmc_kernel_draws", key.device, {"key": (key, (2,), torch.int64)})
    c_total = _check_batch("hmc_kernel_draws", t, c, n0, c_total)
    _check_lengths("hmc_kernel_draws", nmin, nmax)
    p0 = torch.empty((t, d, c), dtype=torch.float32, device=key.device)
    nsteps = torch.empty((t, c), dtype=torch.int32, device=key.device)
    dims = (t, c) if functor == "curved" else (d, t, c)
    fn = common.entry(
        "hmc_trajectory", functor, f"hmc_draws_{functor}",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * len(dims) + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    )
    common.launch("hmc_draws", fn, key.device, key.data_ptr(), int(nmin), int(nmax),
                  p0.data_ptr(), nsteps.data_ptr(), *dims, int(n0), c_total)
    return p0, nsteps
