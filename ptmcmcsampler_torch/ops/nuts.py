"""NUTS tree kernel: wrapper, plain version, reservoir uniforms and binding.

``nuts_trees`` builds, for every chain of the ``[T, C]`` batch, one
slice-sampling NUTS tree (Hoffman & Gelman Algorithm 6) in whitened
coordinates to at most ``max_depth`` doublings, from randomness drawn by the
caller, and returns the proposal and the tree's statistics. It is the port
of ``ptmcmcsampler_tpu/ops/nuts_pallas.py::_nuts_kernel``; the algorithm is
written out in ``csrc/nuts_tree.cu``.

* Two kinds of entry: the default ones (``csrc/nuts_tree.cu``) build trees
  to depth 10 (``config.NUTS_MAX_KERNEL_DEPTH``), as the Pallas kernel; the
  general ones (``csrc/nuts_general.cu``) to depth 30
  (``config.NUTS_MAX_DEPTH``), and also take a forced trajectory length
  (``force_trajlen``: the JAX package's ``nuts_force_trajlen``, which
  replaces the U-turn test by a leaf count) and the capture of lane (T0,
  C0)'s trajectory (``capture``, a ``trajectory.TrajCapture``). The wrapper
  picks the general entry for any of these, or where ``general=True``. Both
  compute the same function, so one plain version is the twin of both.

* Reservoir uniforms come from a two-word key: leaf row ``r`` of chain
  ``n`` takes word 0 of Philox4x32-10 at counter ``(r, n, 0, 0)``
  (``csrc/philox.cuh``), as ``(x >> 8) * 2**-24``, where ``n`` is the
  chain's index in the unsharded batch: ``n0 + t*c_total + c`` for local
  rung ``t`` and chain ``c`` (``n0 = 0``, ``c_total = C`` unsharded; a
  shard of rungs from ``t0`` and chains from ``c0`` passes ``n0 = t0 *
  c_total + c0``), so a sharded run draws what the unsharded one does.
  The kernel computes them as it goes; ``nuts_uniforms`` materialises the
  same array, bit for bit.
* Lanes with ``eps <= 0`` search their step size first
  (``find_reasonable_epsilon``) when the caller passes the search's momenta
  ``r_eps``.
* On a CUDA tensor the wrapper launches the hand-written kernel with the
  key, or raises. The curved model (D = 2) runs one thread a chain, each
  building its own tree; the wide models (``correlated_gaussian``,
  ``interval_gaussian``, ``hierarchical_gaussian``, any D up to
  ``common.WIDE_MAX_D``, and a registered user functor at its dims:
  ``ops/user.py``) run the wide layout, a group of ``common.wide_group(D)``
  chains a block (64 down to 4) stepping through the plain version's masked schedule
  together, with the model's constants (``model.cuda_params``) and a global
  scratch for the frontiers, checkpoints and subtree proposals, allocated
  here from PyTorch's caching allocator at every call.
* On a CPU tensor it runs ``nuts_trees_plain``: the same function as masked
  PyTorch steps over levels and leaves, with the kernel's operation order,
  fed the uniforms as an array (given, or materialised from the key). The
  tests hold it to the JAX package's interpreted Pallas kernel, and
  ``chip_smoke.py`` holds the kernel to it on the card.

``nuts_trees.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import NUTS_MAX_DEPTH, NUTS_MAX_KERNEL_DEPTH
from ..proposals.gradient import find_reasonable_epsilon
from . import common
from .common import philox4x32

_UNIFORMS_CHUNK = 1 << 24  # elements of int64 work per step of nuts_uniforms


def wide_scratch_floats(ndim, depth):
    """Floats of global scratch a chain of the wide kernel takes at dimension
    ``ndim`` and depth cap ``depth`` (csrc/nuts_tree.cu
    wide_scratch_per_chain): the two frontiers' position, momentum and
    gradient, ``depth`` checkpoint rows of position and momentum, and the
    subtree's proposal."""
    return (7 + 2 * depth) * ndim


def nuts_uniforms(key, depth, t, c, n0=0, c_total=None):
    """The ``[2**depth - 1, T, C]`` f32 reservoir uniforms the kernel draws
    under ``key`` (int64 ``[2]``, words in ``[0, 2**32)``) for the block of
    chains ``n0``, ``c_total`` place (``common.chain_counters``), bit for bit, on
    ``key``'s device, without reading the key to the host. The row (the
    leaf's index in the whole tree, below 2**30 at depth 30) and the chain
    are two counter words of their own, so no two (row, chain) pairs share a
    counter at any depth."""
    rows, n = (1 << depth) - 1, t * c
    dev = key.device
    chains = common.chain_counters(t, c, n0, c_total, dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    out = torch.empty((rows, n), dtype=torch.float32, device=dev)
    step = max(1, _UNIFORMS_CHUNK // max(n, 1))
    for r in range(0, rows, step):
        leaf = torch.arange(r, min(r + step, rows), dtype=torch.int64, device=dev)[:, None]
        x = philox4x32((leaf, chains, zero, zero), (key[0], key[1]))[0]
        out[r:r + step] = (x >> 8).to(torch.float32) * 2.0**-24
    return out.view(rows, t, c)


def nuts_trees_plain(q0, r0, beta, eps, expo, dirs, accu, resu, chol, model, r_eps=None,
                     structure="dense", force_trajlen=None, capture=None):
    """Plain PyTorch version of the kernel: the arguments and results of
    ``nuts_trees``, with the reservoir uniforms as the array ``resu``.
    Raises if ``chol`` has nonzeros outside ``structure``.

    Lanes are masked where their tree or subtree has stopped. The loops (and
    the step-size search's) stop early once every lane has stopped, which
    reads the device: it is a version for tests and the CPU, never on the
    sampler's path on the card. So does the capture of lane (T0, C0), which
    follows that lane on the host.

    With ``force_trajlen`` ``L``, a lane alive at doubling ``j`` has run
    ``2**j - 1`` leaves before it (every earlier subtree ran whole, or the
    tree stopped), so the JAX package's leaf counts are host integers: the
    subtree stops after an odd leaf ``k`` where ``2**j + k >= L``
    (``leaves_before + k + 1``), and the tree after the doubling where
    ``2**(j+1) - 1 >= L``, in place of the U-turn tests.
    """
    common.check_structure("nuts_trees", structure, chol)
    fgw = common.whitened(model, chol, beta[:, None], common.kernel_structure(model, structure))
    logp0, g0 = fgw(q0)
    if r_eps is not None:
        fresh = eps <= 0
        if bool(fresh.any()):
            found = find_reasonable_epsilon(lambda _ctx, q, _b: fgw(q), None, beta, q0, g0, logp0,
                                            r_eps)
            eps = torch.where(fresh, found, eps)
    joint0 = common.log_hamiltonian(logp0, r0)
    logu = joint0 - expo
    zm = zp = z_prop = q0
    rm = rp = r0
    gm = gp = g0
    logp_prop = logp0
    ntot = torch.ones_like(logp0)
    alpha = torch.zeros_like(logp0)
    nalpha = torch.zeros_like(logp0)
    alive = eps > 0
    rec = _Recorder(q0, capture)

    for j in range(dirs.shape[0]):
        if not bool(alive.any()):
            break
        v = dirs[j]
        vneg = v < 0
        vd = v[:, None, :]
        ve = vd * eps[:, None, :]
        hve = 0.5 * ve
        vneg_d = vneg[:, None, :]
        z = torch.where(vneg_d, zm, zp)
        r = torch.where(vneg_d, rm, rp)
        g = torch.where(vneg_d, gm, gp)
        zps = z
        lps = torch.full_like(logp0, float("-inf"))
        n_sub = torch.zeros_like(logp0)
        active = alive
        # Checkpoints (z, r) by stack row. The top follows the leaf index
        # alone, so it is a host integer; a row is read only by lanes that
        # were active when it was pushed, so the pushes need no mask.
        stack = [None] * (dirs.shape[0] + 1)
        top = 0
        rec.start_subtree()
        for k in range(1 << j):
            if not bool(active.any()):
                break
            rh = r + hve * g
            z1 = z + ve * rh
            logp1, g1 = fgw(z1)
            r1 = rh + hve * g1
            joint = common.log_hamiltonian(logp1, r1)
            valid = active & (logu < joint)
            diverged = (logu - 1000.0) >= joint

            n_sub = torch.where(valid, n_sub + 1.0, n_sub)
            take = valid & (resu[(1 << j) - 1 + k] < 1.0 / torch.clamp(n_sub, min=1.0))
            zps = torch.where(take[:, None, :], z1, zps)
            lps = torch.where(take, logp1, lps)
            alpha = torch.where(
                active, alpha + torch.clamp(torch.exp(joint - joint0), max=1.0), alpha
            )
            nalpha = torch.where(active, nalpha + 1.0, nalpha)

            rec.leaf(active, v, z1, take)
            turning = torch.zeros_like(active)
            if k % 2 == 0:
                stack[top] = (z1, r1)
                top += 1
            else:
                t_ones = ((k + 1) & -(k + 1)).bit_length() - 1
                if force_trajlen is not None:
                    turning = torch.full_like(active, (1 << j) + k >= force_trajlen)
                else:
                    for i in range(top - t_ones, top):
                        sz, sr = stack[i]
                        dzv = vd * (z1 - sz)
                        cont = (common.rdot(dzv, sr) >= 0) & (common.rdot(dzv, r1) >= 0)
                        turning = turning | ~cont
                top -= t_ones - 1

            active_d = active[:, None, :]
            z = torch.where(active_d, z1, z)
            r = torch.where(active_d, r1, r)
            g = torch.where(active_d, g1, g)
            active = active & ~diverged & ~turning

        upd_m = (alive & vneg)[:, None, :]
        upd_p = (alive & ~vneg)[:, None, :]
        zm, rm, gm = (torch.where(upd_m, a, b) for a, b in ((z, zm), (r, rm), (g, gm)))
        zp, rp, gp = (torch.where(upd_p, a, b) for a, b in ((z, zp), (r, rp), (g, gp)))
        accept = active & (accu[j] < n_sub / torch.clamp(ntot, min=1.0))
        rec.end_subtree(accept)
        z_prop = torch.where(accept[:, None, :], zps, z_prop)
        logp_prop = torch.where(accept, lps, logp_prop)
        ntot = ntot + n_sub
        if force_trajlen is not None:
            cont = torch.full_like(active, (2 << j) - 1 < force_trajlen)
        else:
            dz = zp - zm
            cont = (common.rdot(dz, rm) >= 0) & (common.rdot(dz, rp) >= 0)
        alive = alive & active & cont

    rec.write()
    return z_prop, logp0, logp_prop, alpha, nalpha, alive.to(logp0.dtype), eps


class _Recorder:
    """The plain version's capture of lane (T0, C0)'s trajectory into a
    ``trajectory.TrajCapture`` (nothing without one): the start on the plus
    branch with global index 0, then each leaf the lane runs with the next
    index, on the branch of its direction; the chosen sample's index is the
    last leaf the reservoir took in a subtree the tree accepted."""

    def __init__(self, q0, capture):
        self.capture = capture
        if capture is None:
            return
        self.branches = {True: [(q0[0, :, 0].clone(), 0)], False: []}  # plus, minus
        self.gind = self.used = self.sub_used = 0

    def start_subtree(self):
        if self.capture is not None:
            self.sub_used = self.used

    def leaf(self, active, v, z1, take):
        if self.capture is None or not bool(active[0, 0]):
            return
        self.gind += 1
        self.branches[bool(v[0, 0] > 0)].append((z1[0, :, 0].clone(), self.gind))
        if bool(take[0, 0]):
            self.sub_used = self.gind

    def end_subtree(self, accept):
        if self.capture is not None and bool(accept[0, 0]):
            self.used = self.sub_used

    def write(self):
        cap = self.capture
        if cap is None:
            return
        cap.zero_()
        for plus, (rows, inds) in ((True, (cap.plus, cap.ind_plus)),
                                   (False, (cap.minus, cap.ind_minus))):
            for i, (z, g) in enumerate(self.branches[plus]):
                rows[i] = z
                inds[i] = g
        lens = (len(self.branches[True]), len(self.branches[False]), self.used, 1)
        cap.meta.copy_(torch.tensor(lens, dtype=torch.int32))


def nuts_trees(q0, r0, beta, eps, expo, dirs, accu, draws, chol, model, r_eps=None,
               structure="dense", force_trajlen=None, capture=None, general=False, n0=0,
               c_total=None):
    """One NUTS tree per chain, from pre-drawn randomness.

    Args:
      q0, r0: ``[T, D, C]`` f32 whitened positions and momenta.
      beta:   ``[T]`` f32 inverse temperatures.
      eps:    ``[T, C]`` f32 step sizes.
      expo:   ``[T, C]`` f32 Exp(1) slice draws.
      dirs:   ``[depth, T, C]`` f32 doubling directions, +-1.
      accu:   ``[depth, T, C]`` f32 uniforms of the across-doubling accept.
      draws:  the reservoir's Philox key, int64 ``[2]`` with words in
              ``[0, 2**32)``; or, on the CPU only, its uniforms as an f32
              ``[2**depth - 1, T, C]`` array (level j reads rows
              ``[2**j - 1, 2**(j+1) - 1)``).
      chol:   ``[D, D]`` f32 Cholesky factor of the mass-matrix inverse.
      model:  gives ``value_grad`` (plain version), ``cuda_functor`` and,
              for a wide functor, ``cuda_params``.
      r_eps:  ``[T, D, C]`` f32 standard-normal momenta of the step-size
              search, or None. Given, a lane with ``eps <= 0`` first runs
              ``find_reasonable_epsilon`` and builds its tree with the step
              size found; without it, such a lane stays put.
      structure: the factor's structure tag (``common.STRUCTURES``), worked
              out where it was made; the wide entries skip the terms it
              zeroes.
      force_trajlen: None, or the leaf count a tree runs to in place of the
              U-turn test (see ``nuts_trees_plain``).
      capture: None, or a ``trajectory.TrajCapture`` of ``2**depth`` rows a
              branch on q0's device, which the call overwrites with lane
              (T0, C0)'s trajectory.
      general: launch the general entry even where the default one would do.
      n0, c_total: where the block lies in the unsharded batch (the
              reservoir's counter words, ``common.chain_counters``): 0 and None
              (``C``) unsharded.
    Returns:
      ``(q_prop [T, D, C], logp0, logp_prop, alpha, nalpha, alive, eps_used)``,
      the last six ``[T, C]`` f32; ``alive`` is 1 where the depth cap cut the
      tree; ``eps_used`` is the step size each tree used.
    """
    depth = dirs.shape[0]
    if not 1 <= depth <= NUTS_MAX_DEPTH:
        raise ValueError(f"nuts_trees: depth {depth} outside [1, {NUTS_MAX_DEPTH}]")
    general = (general or depth > NUTS_MAX_KERNEL_DEPTH or force_trajlen is not None
               or capture is not None)
    if common.check_device("nuts_trees", q0):
        resu = draws
        if draws.dtype == torch.int64:
            resu = nuts_uniforms(draws, depth, q0.shape[0], q0.shape[2], n0, c_total)
        return nuts_trees_plain(q0, r0, beta, eps, expo, dirs, accu, resu, chol, model, r_eps,
                                structure, force_trajlen, capture)
    t, d, c = q0.shape
    functor = common.cuda_functor("nuts", model, d, "nuts_trees")
    f32 = torch.float32
    expect = {
        "q0": (q0, (t, d, c), f32), "r0": (r0, (t, d, c), f32),
        "beta": (beta, (t,), f32), "eps": (eps, (t, c), f32), "expo": (expo, (t, c), f32),
        "dirs": (dirs, (depth, t, c), f32), "accu": (accu, (depth, t, c), f32),
        "key": (draws, (2,), torch.int64), "chol": (chol, (d, d), f32),
    }
    if r_eps is not None:
        expect["r_eps"] = (r_eps, (t, d, c), f32)
    if capture is not None:
        leaves, i32 = 1 << depth, torch.int32
        expect.update({
            "capture plus": (capture.plus, (leaves, d), f32),
            "capture minus": (capture.minus, (leaves, d), f32),
            "capture ind_plus": (capture.ind_plus, (leaves,), i32),
            "capture ind_minus": (capture.ind_minus, (leaves,), i32),
            "capture meta": (capture.meta, (4,), i32),
        })
    common.check_args("nuts_trees", q0.device, expect)
    c_total = c if c_total is None else int(c_total)
    if t * c >= 2**31 or not 0 <= n0 <= 2**32 - t * c_total:
        raise ValueError("nuts_trees: more than 2**31 - 1 chains, or counters past 2**32")
    q_prop = torch.empty_like(q0)
    outs = torch.empty((6, t, c), dtype=f32, device=q0.device).unbind(0)
    ins, dims = (q0, r0, beta, eps, r_eps, expo, dirs, accu, draws, chol), (t, c, depth)
    wide = functor != "curved"
    prm = common.cuda_params("nuts_trees", model, functor, q0.device) if wide else None
    scratch = None
    if wide:  # the frontiers, the checkpoints and the subtree's proposal
        scratch = torch.empty(wide_scratch_floats(d, depth) * t * c, dtype=f32, device=q0.device)
    code = common.structure_code("nuts_trees", structure)
    if general:
        if capture is not None:
            capture.zero_()
        cap = capture.tensors() if capture is not None else (None,) * 5
        ptrs = (*ins, prm, scratch, q_prop, *outs, *cap)
        fn = common.entry(
            "nuts_general", functor, f"nuts_general_{functor}",
            [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 5
            + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
        )
        trajlen = -1 if force_trajlen is None else max(int(force_trajlen), 0)
        common.launch(
            "nuts_general", fn, q0.device,
            *(None if a is None else a.data_ptr() for a in ptrs), code, d, t, c, depth, trajlen,
            int(n0), c_total,
        )
        nuts_trees.launches += 1
        nuts_trees.general_launches += 1
        return (q_prop, *outs)
    if wide:  # a wide entry: the constants, the scratch, the structure, D
        ins += (prm, scratch)
        dims = (code, d, t, c, depth)
    fn = common.entry(
        "nuts_tree", functor, f"nuts_tree_{functor}",
        [ctypes.c_void_p] * (len(ins) + 7) + [ctypes.c_int] * len(dims)
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    )
    common.launch(
        "nuts_tree", fn, q0.device,
        *(None if a is None else a.data_ptr() for a in (*ins, q_prop, *outs)), *dims, int(n0),
        c_total,
    )
    nuts_trees.launches += 1
    return (q_prop, *outs)


# Launches of the kernel's entries, all of them and the general ones.
nuts_trees.launches = 0
nuts_trees.general_launches = 0
