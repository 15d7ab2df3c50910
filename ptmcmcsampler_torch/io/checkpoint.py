"""Full-state checkpoints in the JAX package's format.

One ``.npz`` holds every array of the sampler state, keyed by its path name
(``"x"``, ``"adapt/cov"``, ``"counters/naccepted"``, ...; see
:func:`ptmcmcsampler_torch.state.state_to_numpy`) under the format key
``ptmcmc-ckpt-v2-pathkeys``; the caller's meta goes to a ``.json`` sidecar.
The ``.npz`` is written to a temporary file and moved into place with
``os.replace``, so a kill mid-write leaves the previous checkpoint whole.

Checkpoints move both ways between this package and ``ptmcmcsampler_tpu``:

* The JAX loader needs a ``key`` leaf (uint32 ``[2]``, a threefry key).
  The port writes two words the caller draws from its seed; they do not
  stand for the torch streams.
* The torch generators' states go under ``torch/rng`` and ``torch/host_rng``
  (uint8), with the device type they belong to under ``torch/device``. The
  JAX loader ignores paths its template lacks. Loaded on a device of that
  type, they are restored, so a resumed run continues exactly; otherwise (a
  JAX checkpoint, or a CPU checkpoint loaded on the card) the generators are
  seeded from ``seed``.
* Older layouts load as the JAX loader loads them: a missing ``*_lad``
  ladder-window counter is filled from its cumulative counter, and ``x``
  stored as ``[T, C, D]`` and the DE ring as ``[B, D]`` are transposed.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..state import state_from_numpy, state_shapes, state_to_numpy

_FORMAT_KEY = "__format__"
_FORMAT = "ptmcmc-ckpt-v2-pathkeys"


def save_checkpoint(path, state, meta=None, key=None, seconds=None):
    """Write ``state`` to ``path`` (and ``meta`` to ``path + ".json"``).

    ``key``: the two uint32 words of the ``key`` leaf (zeros if None).
    ``seconds``: a dict that the host seconds of the parts are added to:
    ``"checkpoint_arrays"`` (the state's arrays on the host),
    ``"checkpoint_savez"`` (``np.savez`` and the rename) and
    ``"checkpoint_meta"`` (the sidecar).
    """
    t0 = time.perf_counter()
    arrays = {_FORMAT_KEY: np.asarray(_FORMAT), **state_to_numpy(state)}
    arrays["key"] = np.zeros(2, np.uint32) if key is None else np.asarray(key, np.uint32)
    arrays["torch/rng"] = state.rng.get_state().numpy()
    arrays["torch/host_rng"] = state.host_rng.get_state().numpy()
    # The generators' device: the sampler checkpoints a host copy of a state
    # on the card, whose generators stay the card's.
    arrays["torch/device"] = np.asarray(state.rng.device.type)
    t1 = time.perf_counter()
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    t2 = time.perf_counter()
    if meta is not None:
        with open(path + ".json", "w") as f:
            json.dump(meta, f)
    if seconds is not None:
        for part, sec in (("checkpoint_arrays", t1 - t0), ("checkpoint_savez", t2 - t1),
                          ("checkpoint_meta", time.perf_counter() - t2)):
            seconds[part] = seconds.get(part, 0.0) + sec


def load_checkpoint(path, config, device="cuda", seed=0):
    """Restore a state of ``config`` on ``device`` from ``path``.

    Returns ``(state, meta, generators_restored)``: ``meta`` is the sidecar's
    dict (None without one); ``generators_restored`` says whether the torch
    generators continue the saved streams or were seeded from ``seed``. A
    file of another format, or one that lacks an array ``config`` needs or
    holds it in another shape, raises ``ValueError``.
    """
    with np.load(path) as data:
        if _FORMAT_KEY not in data or str(data[_FORMAT_KEY]) != _FORMAT:
            raise ValueError(
                "checkpoint uses an unrecognized (or legacy index-keyed) "
                "layout; refusing to guess leaf assignment"
            )
        stored = {k: data[k] for k in data.files if k != _FORMAT_KEY}
    for name, shape in state_shapes(config).items():
        base = name[: -len("_lad")] if name.endswith("_lad") else None
        if name not in stored and base in stored:
            stored[name] = stored[base]
        new = stored.get(name)
        if new is None or new.shape == shape:
            continue
        if name == "x" and new.ndim == 3 and shape == new.shape[:1] + new.shape[:0:-1]:
            stored[name] = np.moveaxis(new, 2, 1)
        elif name == "de/buf" and new.ndim == 2 and shape == new.shape[::-1]:
            stored[name] = new.T
    state = state_from_numpy(stored, config, device, seed)
    restored = "torch/rng" in stored and str(stored.get("torch/device")) == state.x.device.type
    if restored:
        state.rng.set_state(torch.from_numpy(stored["torch/rng"]))
        state.host_rng.set_state(torch.from_numpy(stored["torch/host_rng"]))
    meta = None
    if os.path.isfile(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return state, meta, restored
