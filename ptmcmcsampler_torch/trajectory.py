"""NUTS trajectory capture and the ``trajectoryDir`` files.

Parity target: the reference's ``Trajectory`` buffer (nutsjump.py:294-376)
and its ``trajectoryDir`` / ``write_burnin`` dumps (nutsjump.py:400-433,
:818-835), as the JAX package's ``trajectory.py`` ports them: every NUTS
trajectory of the designated chain (temperature 0, chain 0) goes to text
files of its plus branch, its minus branch and the path from the start to
the sample the tree chose.

Here the NUTS tree kernel records the trajectory itself: its general entry
(``ops/nuts.py``) writes the leaves of lane (T0, C0) into the fixed buffers
of a :class:`TrajCapture` as it builds that lane's tree, so what is recorded
is the tree the sampler took (the JAX package re-runs the tree for it). The
buffers live beside the step's state and are written inside its CUDA
graphs; ``run_block`` copies them into each thinned row, and the host's
:class:`TrajectoryWriter` formats the rows with the reference's file names.
Positions are whitened, as the reference records them (nutsjump.py:523-527).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

# The fields of TrajCapture.meta, in order.
META = ("len_plus", "len_minus", "used_ind", "active")


@dataclasses.dataclass
class TrajCapture:
    """One NUTS trajectory of one chain, or rows of them (a leading axis).

    ``ind_*`` are the reference's global leapfrog-step indices
    (nutsjump.py:713-714, :522-527): the start sample has index 0 on the
    plus buffer, and every leaf takes the next index whichever branch it
    extends. Rows past a branch's length are 0.
    """

    plus: torch.Tensor  # [..., L, D] f32 whitened positions, plus branch (L = 2**depth)
    minus: torch.Tensor  # [..., L, D] f32, minus branch
    ind_plus: torch.Tensor  # [..., L] int32 global step index of each plus row
    ind_minus: torch.Tensor  # [..., L] int32
    # [..., 4] int32: the two branches' lengths, the global index of the
    # sample the tree chose, and 1 where a NUTS jump ran this iteration.
    meta: torch.Tensor

    def tensors(self):
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))

    def map(self, fn):
        """A capture of ``fn`` of each tensor."""
        return TrajCapture(*(fn(a) for a in self.tensors()))

    def zero_(self):
        for a in self.tensors():
            a.zero_()
        return self

    def row(self, r=None):
        """Row ``r`` (or the whole capture) as the host dict of numpy arrays
        that :class:`TrajectoryWriter` takes, with the JAX package's names."""
        pick = (lambda a: a) if r is None else (lambda a: a[r])
        out = {f.name: pick(getattr(self, f.name)).cpu().numpy()
               for f in dataclasses.fields(self) if f.name != "meta"}
        meta = pick(self.meta).cpu().numpy()
        out.update({name: meta[i] for i, name in enumerate(META)})
        out["active"] = bool(out["active"])
        return out


def empty_capture(config, device, rows=()) -> TrajCapture:
    """Zeroed capture buffers for ``config`` (``2**nuts_max_depth`` rows of
    ``ndim`` a branch) on ``device``, with leading dimensions ``rows``."""
    rows = tuple(rows)
    leaves, d = 1 << config.nuts_max_depth, config.ndim

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(rows + shape, dtype=dtype, device=device)

    i32 = torch.int32
    return TrajCapture(zeros(leaves, d), zeros(leaves, d), zeros(leaves, dtype=i32),
                       zeros(leaves, dtype=i32), zeros(len(META), dtype=i32))


class Trajectory:
    """Host-side view of one captured trajectory, with the query surface of
    the reference's buffer (``get_trajectory(which)``,
    ``get_used_trajectory(ind)``; nutsjump.py:294-376): two append-only
    sample lists, the lookups computed on demand. ``add_sample`` is for
    users who assemble a trajectory by hand."""

    def __init__(self, ndim, bufsize=None):
        del bufsize  # accepted for signature compatibility; lists grow
        self.ndim = int(ndim)
        self._branches = {"plus": [], "minus": []}  # lists of (theta, ind)

    def reset(self):
        self._branches = {"plus": [], "minus": []}

    def add_sample(self, theta, ind, which="plus"):
        self._branches[which].append((np.asarray(theta, np.float64), int(ind)))

    def length(self):
        return len(self._branches["plus"]) + len(self._branches["minus"])

    def _stack(self, which):
        samples = self._branches[which]
        if not samples:
            return np.zeros((0, self.ndim)), np.zeros((0,))
        thetas = np.stack([t for t, _ in samples])
        inds = np.asarray([i for _, i in samples], np.float64)
        return thetas, inds

    def get_trajectory(self, which="both"):
        """Branch positions and global step indices; ``both`` orders the
        minus branch outward end first, so the rows trace the path."""
        if which in ("plus", "minus"):
            return self._stack(which)
        plus, ip = self._stack("plus")
        minus, im = self._stack("minus")
        return (np.concatenate([minus[::-1], plus], axis=0),
                np.concatenate([im[::-1], ip]))

    def get_used_trajectory(self, ind):
        """The leapfrog path from the start to the sample of global step
        index ``ind``. The start heads the plus branch, so a minus-branch
        target is reached through the start and the minus prefix."""
        plus, ip = self._stack("plus")
        minus, im = self._stack("minus")
        hits_p = np.flatnonzero(ip == ind)
        if hits_p.size:
            return plus[: hits_p[0] + 1]
        hits_m = np.flatnonzero(im == ind)
        if hits_m.size:
            return np.concatenate([plus[:1], minus[: hits_m[0] + 1]], axis=0)
        raise ValueError("Index not found")


def capture_to_trajectory(cap: dict, ndim: int) -> Trajectory:
    """A host :class:`Trajectory` from a capture's arrays (``TrajCapture.row``)."""
    tr = Trajectory(ndim)
    plus = np.asarray(cap["plus"], np.float64)
    minus = np.asarray(cap["minus"], np.float64)
    ip = np.asarray(cap["ind_plus"])
    im = np.asarray(cap["ind_minus"])
    tr._branches["plus"] = [(plus[i], int(ip[i])) for i in range(int(cap["len_plus"]))]
    tr._branches["minus"] = [(minus[i], int(im[i])) for i in range(int(cap["len_minus"]))]
    return tr


class TrajectoryWriter:
    """Writes captured trajectories with the reference's file layout
    (nutsjump.py:818-835): in burn-in, and only with ``write_burnin``,
    ``burnin-{plus,minus,used}-NNNNNN.txt`` numbered by the iteration;
    afterwards ``{plus,minus,used}-NNNNNN.txt`` numbered from the end of
    burn-in."""

    def __init__(self, trajectory_dir, nburn, write_burnin=False):
        if os.path.isfile(trajectory_dir):
            raise IOError("Not a directory: {0}".format(trajectory_dir))
        os.makedirs(trajectory_dir, exist_ok=True)
        self.dir = trajectory_dir
        self.nburn = nburn
        self.write_burnin = write_burnin

    def write(self, it, cap):
        """``cap``: one iteration's capture as a host dict (``TrajCapture.row``)."""
        if not bool(cap["active"]):
            return
        if it <= self.nburn and not self.write_burnin:
            return
        if it <= self.nburn:
            names, num = ["burnin-plus", "burnin-minus", "burnin-used"], it
        else:
            names, num = ["plus", "minus", "used"], it - self.nburn
        tr = capture_to_trajectory(cap, cap["plus"].shape[-1])
        paths = [os.path.join(self.dir, "{0}-{1:06d}.txt".format(n, num)) for n in names]
        np.savetxt(paths[0], tr.get_trajectory("plus")[0])
        np.savetxt(paths[1], tr.get_trajectory("minus")[0])
        np.savetxt(paths[2], tr.get_used_trajectory(int(cap["used_ind"])))
