"""The user's jumps: custom, prior-draw and auxiliary (reference
PTMCMCSampler.py:988-1028; the JAX package's ``proposals/cycle.py``
``_wrap_legacy``, ``KIND_PRIOR``, ``KIND_CUSTOM`` and ``build_aux_chain``).

A user's callable takes one chain. Its ``JumpSpec.protocol`` says how it is
batched over the ``T * C`` chains of ``x [T, D, C]``:

* ``"torch"``: ``torch.func.vmap(..., randomness="different")`` over the
  chains, on the state's device, in one batched call. Random draws use the
  generator passed in (the state's device generator, ``generator=rng``,
  ``device=rng.device``), and each chain gets its own. On the card this runs
  inside the step's CUDA graphs, so the callable must not read the device
  from the host (no ``.item()``, ``float(t)``, ``if t:``); the iteration
  number arrives as a 0-d int64 tensor on the device, which the runner
  writes before every iteration, so a replayed graph sees the true one.

  - custom: ``func(rng, x[D], it, beta) -> (q[D], log_qxy)``;
  - prior draw: ``draw(rng) -> q[D]``;
  - auxiliary: ``aux(rng, x[D], q[D], it, beta) -> (q[D], log_qxy)``.

  The reference's signatures without ``rng`` (``func(x, it, beta)``,
  ``aux(x, q, it, beta)``) are adapted to these when ``vmap`` batches them.

* ``"host"``: numpy callables, one call a chain on the host in float64, as
  the reference calls them and the JAX package's host callback does:
  ``func(x, it, beta)``, ``aux(x, q, it, beta)`` with ``it`` an int and
  ``beta`` a float, and ``draw(np_rng)`` with a ``numpy.random.Generator``
  seeded per chain from the state's generator. Such an iteration cannot be
  held in a CUDA graph: ``kernel.run_block`` runs it eagerly.

``q`` must be a torch tensor under ``"torch"`` (a numpy array is drawn once
on the host, so it is taken as the host protocol); ``log_qxy`` may be a
Python number. Results are f32 on ``x``'s device.

The prior draw's Hastings term is ``lnprior(x) - lnprior(q)`` from the
model's batched ``lnprior``: exact when ``draw`` samples that density (up
to a constant), which the caller asserts by registering the draw.

On a sharded batch (``ctx.block``, ``utils.Block``) a rank draws what the
unsharded run draws for its chains. ``vmap``'s draws are one batch over
every point of the unsharded ``[T * C]`` in point order, so under
``"torch"`` each rank evaluates the callable over the unsharded points
(the other ranks' points filled with zeros, their betas with ones) and keeps
its block's results: every rank runs the whole batch of the user's callable.
Under ``"host"`` a rank calls the user's callable for its own chains only,
the prior draw with its chains' seeds of the unsharded draw of seeds; a host
jump that draws from numpy's global state draws a stream of its own on each
rank, as the reference's MPI ranks do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import block_of


def _points(x):
    """``x [T, D, C]`` -> the chains' points ``[T * C, D]``."""
    return x.movedim(-1, -2).reshape(-1, x.shape[-2])


def _chains(points, t, c):
    """``[T * C, D]`` -> ``[T, D, C]``, contiguous as the other branches'
    results (the state's layout, which orders the plain versions' sums)."""
    return points.reshape(t, c, -1).movedim(-1, -2).contiguous()


def _point_betas(betas, c):
    """Each chain's ``beta``, ``[T * C]``."""
    return betas[:, None].expand(-1, c).reshape(-1)


def _pair(out, x):
    """A callable's ``(q, log_qxy)`` for the point ``x [D]``, f32."""
    q, lq = out
    if not isinstance(q, torch.Tensor):
        raise TypeError(f"a batched jump must return q as a torch tensor, not "
                        f"{type(q).__name__}")
    if not isinstance(lq, torch.Tensor):
        lq = x.new_full((), float(lq))
    return q.to(x.dtype).reshape(x.shape), lq.to(x.dtype).reshape(())


def _draw(draw, x):
    q = draw()
    if not isinstance(q, torch.Tensor):
        raise TypeError(f"a batched prior draw must return a torch tensor, not "
                        f"{type(q).__name__}")
    return q.to(x.dtype).reshape(x.shape)


def batch_jump(func):
    """``batched(rng, x [T, D, C], betas [T], it) -> (q [T, D, C], log_qxy
    [T, C])`` around ``func(rng, x[D], it, beta)``."""
    vpoint = torch.func.vmap(lambda rng, x, it, beta: _pair(func(rng, x, it, beta), x),
                             in_dims=(None, 0, None, 0), randomness="different")

    def batched(rng, x, betas, it):
        t, _, c = x.shape
        q, lq = vpoint(rng, _points(x), it, _point_betas(betas, c))
        return _chains(q, t, c), lq.reshape(t, c)

    return batched


def batch_aux(aux):
    """``batched(rng, x, q, betas, it) -> (q, log_qxy)`` around ``aux(rng,
    x[D], q[D], it, beta)``."""
    vpoint = torch.func.vmap(lambda rng, x, q, it, beta: _pair(aux(rng, x, q, it, beta), q),
                             in_dims=(None, 0, 0, None, 0), randomness="different")

    def batched(rng, x, q, betas, it):
        t, _, c = x.shape
        qn, lq = vpoint(rng, _points(x), _points(q), it, _point_betas(betas, c))
        return _chains(qn, t, c), lq.reshape(t, c)

    return batched


def batch_draw(draw):
    """``batched(rng, x [T, D, C]) -> q [T, D, C]``, one ``draw(rng)`` a chain."""
    vpoint = torch.func.vmap(lambda rng, x: _draw(lambda: draw(rng), x),
                             in_dims=(None, 0), randomness="different")

    def batched(rng, x):
        t, _, c = x.shape
        return _chains(vpoint(rng, _points(x)), t, c)

    return batched


def _host_pairs(outs, like, t, c):
    """Host ``(q, log_qxy)`` pairs, one a chain -> f32 ``(q, log_qxy)`` on
    ``like``'s device."""
    if not outs:  # no chains (a rank's empty part of a per_chain slice)
        return like.clone(), like.new_zeros((t, c))
    q = np.array([np.asarray(o[0], np.float64) for o in outs]).astype(np.float32)
    lq = np.array([np.asarray(o[1], np.float64).reshape(()) for o in outs]).astype(np.float32)
    q = torch.as_tensor(q, device=like.device)
    return _chains(q, t, c), torch.as_tensor(lq, device=like.device).reshape(t, c)


def _host(a):
    return a.detach().cpu().double().numpy()


def host_jump(func):
    """``batched(rng, x, betas, it)`` calling numpy ``func(x, it, beta)`` a
    chain, ``it`` the host iteration number."""

    def batched(rng, x, betas, it):
        t, _, c = x.shape
        pts, bs = _host(_points(x)), _host(_point_betas(betas, c))
        return _host_pairs([func(p, int(it), float(b)) for p, b in zip(pts, bs)], x, t, c)

    return batched


def host_aux(aux):
    """``batched(rng, x, q, betas, it)`` calling numpy ``aux(x, q, it, beta)``."""

    def batched(rng, x, q, betas, it):
        t, _, c = x.shape
        xs, qs, bs = _host(_points(x)), _host(_points(q)), _host(_point_betas(betas, c))
        return _host_pairs([aux(a, b, int(it), float(s)) for a, b, s in zip(xs, qs, bs)],
                           x, t, c)

    return batched


def host_draw(draw):
    """``batched(rng, x, block=None)``: ``draw(np.random.default_rng(seed))``
    a chain, each seed drawn from ``rng`` (as the JAX package seeds its
    callback from the chain's key); on a ``block`` (``utils.Block``) of the
    unsharded draw of seeds, for the block's chains only."""

    def batched(rng, x, block=None):
        t, d, c = x.shape
        block = block_of(None, x) if block is None else block
        seeds = block.draw(torch.randint, rng, ("T", "C"), x.device, 0, 2**31 - 1).reshape(-1)
        if seeds.numel() == 0:
            return x.clone()
        q = np.array([np.asarray(draw(np.random.default_rng(int(s))), np.float64).reshape(d)
                      for s in seeds.cpu().numpy()]).astype(np.float32)
        return _chains(torch.as_tensor(q, device=x.device), t, c)

    return batched


def probe(batched, ndim, device):
    """Whether ``batched(rng, x [T, D, C], betas [T], it)`` runs on two
    chains at zeros on ``device``: the protocol check. Any error of the
    user's code means it does not."""
    rng = torch.Generator(device=device)
    rng.manual_seed(0)
    x = torch.zeros((1, ndim, 2), dtype=torch.float32, device=device)
    betas = torch.ones(1, dtype=torch.float32, device=device)
    it = torch.zeros((), dtype=torch.int64, device=device)
    try:
        batched(rng, x, betas, it)
    except Exception:
        return False
    return True


def make_custom(spec):
    """The branch of a custom jump ``spec``."""
    if spec.protocol == "host":
        jump = host_jump(spec.fn)

        def custom(rng, x, betas, it, ctx, ss):
            q, qxy = jump(rng, x, betas, it)
            return q, qxy, ss
    else:
        jump = batch_jump(spec.fn)

        def custom(rng, x, betas, it, ctx, ss):
            blk, xd = block_of(ctx, x), ("T", x.shape[1], "C")
            q, qxy = jump(rng, blk.spread(x, xd), blk.spread(betas, ("T",), 1.0),
                          ctx.iteration)
            return blk.take(q, xd), blk.take(qxy, ("T", "C")), ss

    return custom


def make_prior_draw(spec, model):
    """The branch of a prior-draw jump ``spec``: ``q ~ draw``, ``qxy =
    lnprior(x) - lnprior(q)`` (the JAX package's ``KIND_PRIOR``)."""
    if spec.protocol == "host":
        draw = host_draw(spec.fn)

        def propose(rng, x, blk):
            return draw(rng, x, blk)
    else:
        draw = batch_draw(spec.fn)

        def propose(rng, x, blk):
            xd = ("T", x.shape[1], "C")
            return blk.take(draw(rng, blk.spread(x, xd)), xd)

    def prior_draw(rng, x, betas, it, ctx, ss):
        q = propose(rng, x, block_of(ctx, x))
        return q, model.lnprior(x) - model.lnprior(q), ss

    return prior_draw


def make_aux_chain(config):
    """``apply_aux(rng, x, q, qxy, betas, it, ctx) -> (q, qxy)``: the
    auxiliary jumps of ``config`` applied in turn to every proposal, their
    ``log_qxy`` summed into ``qxy`` (the JAX package's ``build_aux_chain``);
    a host jump gets the host ``it``, a batched one ``ctx.iteration``. None
    without auxiliary jumps."""
    if not config.aux_jumps:
        return None
    chain = [(spec.protocol, host_aux(spec.fn) if spec.protocol == "host"
              else batch_aux(spec.fn)) for spec in config.aux_jumps]

    def apply_aux(rng, x, q, qxy, betas, it, ctx):
        blk, xd = block_of(ctx, x), ("T", x.shape[1], "C")
        total = torch.zeros_like(qxy)
        for protocol, aux in chain:
            if protocol == "host":
                q, lq = aux(rng, x, q, betas, it)
            else:
                q, lq = aux(rng, blk.spread(x, xd), blk.spread(q, xd),
                            blk.spread(betas, ("T",), 1.0), ctx.iteration)
                q, lq = blk.take(q, xd), blk.take(lq, ("T", "C"))
            total = total + lq
        return q, qxy + total

    return apply_aux
