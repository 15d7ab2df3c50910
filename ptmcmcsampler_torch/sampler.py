"""The user-facing PTSampler (PyTorch port of ``ptmcmcsampler_tpu.sampler``).

The JAX package's constructor and ``sample()`` keywords (MIGRATION.md), its
chain files, checkpoint and resume, for one process on one device: the
whole ``[ntemps, nchains]`` batch advances in ``kernel.run_block`` blocks of
``isave // thin`` thinned rows, and after each block the host writes the
chain files and a checkpoint.

User callables take one point ``x [ndim]``, as the reference's do. They
reach ``build_step``, which wants a batched model, by one of three routes:

* **kernel**: ``logl``, ``logp``, ``logl_grad`` and ``logp_grad`` are the
  bound methods ``lnlikefn``, ``lnpriorfn``, ``lnlikefn_grad`` and
  ``lnpriorfn_grad`` of one object that also gives the batched ``lnlike``,
  ``lnprior`` and ``value_grad`` and names a ``cuda_functor``, and no
  ``*args``/``*kwargs`` are passed. The object goes to ``build_step`` whole,
  and on the card its gradient jumps launch the CUDA kernels compiled with
  that functor: a built-in one (the four models of ``models`` are such
  objects) or a user's, registered with ``register_functor``
  (``ops/user.py``), whose libraries are built when the sampler is made on
  the card. A jump whose kernel does not take the functor at the model's
  dimension (a wide functor beyond D = 1024, a user functor outside its
  registered dims) is refused on the card when ``sample()`` starts
  (:func:`card_refusal`); on the CPU every jump runs.
* **plain**: anything else that ``torch.func.vmap`` can batch: it runs
  batched on the device. The gradient jumps run the kernels' plain
  versions, which run only on the CPU: on the card a kernel wrapper
  launches its kernel or raises. So on the card this route is refused for a
  model with gradients (a user's model reaches the kernels by registering
  its functor); without gradients it runs there, since SCAM, AM and DE
  reach no kernel.
* **host**: the plain route where a callable cannot be batched (numpy):
  it runs on the host, one call a point, in float64. A CUDA graph cannot
  hold a host call, so ``run_block`` runs this route eagerly on the card.

On the card the other two routes replay CUDA graphs of the step
(``kernel.run_block``). ``sample()`` dispatches block k+1 before it drains
block k, as the JAX package does, unless ``neff`` is given.

The user's jumps (``addProposalToCycle``, ``addPriorDrawToCycle``,
``addAuxilaryJump``; protocols in ``proposals/custom.py``) change no route:
torch callables that ``torch.func.vmap`` batches run on the device, inside
the graphs on the card, beside the kernels; numpy ones run on the host, and
``run_block`` runs their iterations eagerly (every iteration, for an
auxiliary jump), the other iterations replaying their graphs.

Gradient jumps need both ``logl_grad`` and ``logp_grad``; without them they
are dropped, as in the JAX package.

The tempering ladder's settings are the JAX package's: ``swap_mode``
("sweep", the reference's, or "deo"; a resumed run keeps its checkpoint's),
``de_pair`` ("blocked", "rolled", "iid") and ``sample(adaptLadder=True,
ladderAdaptLag=, ladderAdaptTime=)``, the adaptive ladder in burn-in, which
leaves a ``hotChain``'s top rung out of its geometry. The adapted betas and
the ladder's window counters are state: the checkpoint holds them and a
resumed run continues from them.

The jump selection is the JAX package's: ``jump_select="shared"`` (one kind
an iteration for the whole batch) or ``"per_chain"`` (one a chain, the
reference's law), with ``per_chain_mode`` "auto", "rotation" or "stacked".
``sample(NUTSmaxdepth=)`` takes NUTS trees to depth 30, and
``sample(trajectoryDir=, write_burnin=)`` writes the NUTS trajectories of
the cold chain 0 in the reference's files (``trajectory.py``), as the JAX
package does, with ``jump_select="shared"`` only.

Multi-process runs are the JAX package's too (ROADMAP A12), one process a
device as ``torchrun --nproc_per_node=N`` starts them: with a process group
joined (``parallel.initialize_distributed``), each rank holds its block of
the rungs and chains of a ``parallel.PTMesh`` (``mesh=``, or by default the
rungs split over the ranks where ``ntemps`` tiles them, else the chains),
runs its block eagerly with the collectives between the device work
(``kernel.build_step(mesh=)``), and writes the files of the rows it owns:
the owner of chain 0 of a rung its chain file, every rank its part of the
all-chain sidecar (chains split) or its rungs' sidecars (rungs split);
process 0 the jump files, ``cov.npy`` and the checkpoint, gathered whole
(a one-process run loads it). A ``neff`` stop is voted by the owner of the
cold chain 0 and agreed by all. A temperature-sharded mesh swaps by DEO
unless ``swap_mode="sweep"`` is asked for. ``trajectoryDir`` stays refused
there, as in the JAX package.

The JAX package's TPU dispatch keywords (``rng_impl``, ``use_pallas``,
``nuts_impl``, ``nuts_pass1_depth``) are accepted and ignored.
"""

from __future__ import annotations

import inspect
import json
import os
import sys
import time

import numpy as np
import torch

from . import diagnostics, utils
from .config import (KIND_CHEES, KIND_CUSTOM, KIND_HMC, KIND_NUTS, KIND_PRIOR, JumpSpec,
                     SamplerConfig, build_default_jumps)
from .io.chainfile import ChainWriter
from .io.checkpoint import load_checkpoint, save_checkpoint
from .kernel import BlockOutput, build_step
from .ladder import ladder_betas, temperature_ladder
from .ops import common, user
from .parallel import distributed
from .parallel.mesh import PTMesh, any_rank, barrier, gather_many, shard_state, unshard_state
from .proposals import custom
from .state import clone_generator, init_state, map_state
from .trajectory import TrajectoryWriter

_FUNCTOR_METHODS = ("lnlikefn", "lnpriorfn", "lnlikefn_grad", "lnpriorfn_grad")
_BATCHED_METHODS = ("lnlike", "lnprior", "value_grad")


def card_refusal(device_type, functor, jumps, ndim):
    """Why the kernel route cannot run the jumps ``jumps`` (``JumpSpec``s)
    of a model with device functor ``functor`` at ``ndim`` on a device of
    type ``device_type``, or None if it can. On the card each jump of a
    kernel kind (ChEES, HMC, NUTS) launches its kernel or raises, so a kind
    whose kernel has no entry for the functor at that D is refused before
    any iteration runs. MALA and the user's custom and prior-draw jumps are
    plain PyTorch (or numpy on the host); the CPU runs every kernel's plain
    version."""
    if device_type != "cuda":
        return None
    for jump in jumps:
        if jump.kind in (KIND_CHEES, KIND_HMC, KIND_NUTS):
            why = common.kernel_refusal(functor, jump.kind, ndim)
            if why is not None:
                return f"{jump.name}: {why}"
    return None


def _points(x):
    """``x [..., D, C]`` -> ``(points [N, D], shape [..., C])``."""
    return x.movedim(-1, -2).reshape(-1, x.shape[-2]), x.shape[:-2] + x.shape[-1:]


def _f32(v, like):
    """A user callable's result as an f32 tensor on ``like``'s device."""
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(v, device=like.device)
    return v.to(torch.float32)


def _wrap_fn(f, args, kwargs, ndim, device, grad=False):
    """Batch a user callable ``f(x[ndim], *args, **kwargs)`` over ``x [..., D, C]``.

    ``f`` returns a scalar, or ``(value, gradient[ndim])`` with ``grad``.
    Returns ``(batched, traceable)``: ``batched(x)`` gives ``[..., C]`` (and
    ``[..., D, C]``) float32 on ``x``'s device. ``traceable`` says whether
    ``torch.func.vmap`` batches ``f`` (probed once, on a batch of zeros);
    if not, ``batched`` copies the points to the host once and calls ``f``
    on each in float64, as ``_function_wrapper`` does (PTMCMCSampler.py:1072-1086).
    """

    def point(x):
        out = f(x, *args, **kwargs)
        if grad:
            v, g = out
            return _f32(v, x).reshape(()), _f32(g, x).reshape((ndim,))
        return _f32(out, x).reshape(())

    vpoint = torch.func.vmap(point)

    def unflatten(out, shape):
        if grad:
            v, g = out
            return v.reshape(shape), g.reshape(shape + (ndim,)).movedim(-1, -2)
        return out.reshape(shape)

    def traced(x):
        pts, shape = _points(x)
        return unflatten(vpoint(pts), shape)

    def host(x):
        pts, shape = _points(x)
        outs = [f(p, *args, **kwargs) for p in pts.detach().cpu().numpy().astype(np.float64)]
        cols = [torch.as_tensor(np.array([np.asarray(o, np.float64) for o in col])
                                .astype(np.float32), device=x.device)
                for col in (zip(*outs) if grad else [outs])]
        return unflatten(cols if grad else cols[0], shape)

    try:  # any error of the user's code under vmap means: not batchable
        probe = vpoint(torch.zeros((2, ndim), dtype=torch.float32, device=device))
        ok = (probe[0] if grad else probe).shape == (2,)
    except Exception:
        ok = False
    return (traced, True) if ok else (host, False)


class _BatchedModel:
    """The batched model ``build_step`` takes, around wrapped user callables
    (no ``cuda_functor``: its gradient jumps run only on the CPU)."""

    def __init__(self, lnlike, lnprior, lnlike_grad=None, lnprior_grad=None):
        self.lnlike = lnlike
        self.lnprior = lnprior
        self._grads = (lnlike_grad, lnprior_grad)

    def value_grad(self, x, beta):
        """``(beta*ll + lp, beta*grad ll + grad lp)``, the JAX package's
        ``_func_grad`` (nutsjump.py:71-76); ``beta`` broadcasts against
        ``[..., C]``."""
        llg, lpg = self._grads
        ll, gll = llg(x)
        lp, glp = lpg(x)
        beta = torch.as_tensor(beta, device=x.device)
        beta_d = beta.unsqueeze(-2) if beta.dim() else beta
        return beta * ll + lp, beta_d * gll + glp


def _nparams(func):
    """The number of parameters of ``func``'s signature, 0 if it has none
    to read (the protocols tell the torch-native jumps by it, as the JAX
    package does)."""
    try:
        return len(inspect.signature(func).parameters)
    except (TypeError, ValueError):
        return 0


def _functor_model(callables, extra_args):
    """The object behind the four callables when they take the kernel route
    (see the module docstring), else None."""
    if any(extra_args) or not all(inspect.ismethod(f) for f in callables):
        return None
    owner = callables[0].__self__
    if any(f.__self__ is not owner or f.__name__ != name
           for f, name in zip(callables, _FUNCTOR_METHODS)):
        return None
    if getattr(owner, "cuda_functor", None) is None:
        return None
    if not all(callable(getattr(owner, name, None)) for name in _BATCHED_METHODS):
        return None
    return owner


class PTSampler:
    """Parallel-tempering MCMC sampler on one CUDA card (or the CPU).

    The constructor signature of the reference (PTMCMCSampler.py:75-93) and
    the JAX package's extensions (``ntemps``, ``nchains``, ``dtype``,
    ``jump_select``, ``swap_mode``, ``adapt_from``, ``de_pair``,
    ``de_block``, ...; MIGRATION.md), plus ``device``: the card unless the
    caller passes ``device="cpu"``. The chosen model route is ``route``,
    ``"kernel"``, ``"plain"`` or ``"host"``. ``block_stats`` is the last
    ``sample()`` call's ``run_block.stats`` (graphs, replays, eager
    iterations).
    """

    def __init__(
        self,
        ndim,
        logl,
        logp,
        cov,
        groups=None,
        loglargs=None,
        loglkwargs=None,
        logpargs=None,
        logpkwargs=None,
        logl_grad=None,
        logp_grad=None,
        comm=None,
        outDir="./chains",
        verbose=True,
        resume=False,
        seed=None,
        ntemps=1,
        nchains=1,
        dtype=np.float32,
        jump_select="shared",
        swap_mode=None,
        adapt_from="cold",
        mesh=None,
        temp_axis="temp",
        chain_axis="chain",
        rng_impl="threefry2x32",
        use_pallas=None,
        nuts_impl="auto",
        host_history_bytes=2 * 1024**3,
        de_pair="blocked",
        de_block=8,
        per_chain_mode="auto",
        nuts_pass1_depth=4,
        device="cuda",
    ):
        # MPI shim and the TPU dispatch keywords: accepted, without effect here.
        del comm, rng_impl, use_pallas, nuts_impl, nuts_pass1_depth
        if mesh is not None and not isinstance(mesh, PTMesh):
            raise TypeError("mesh= takes a ptmcmcsampler_torch.parallel.PTMesh "
                            "(make_pt_mesh, make_temp_mesh): one process a shard")
        self.mesh = mesh
        self.temp_axis, self.chain_axis = temp_axis, chain_axis
        self._multi = False  # a multi-process run; sample() decides
        self._owns_cold = True  # this process drains the cold chain 0
        if distributed.process_count() > 1:  # each rank its card
            device = distributed.rank_device(device)
        if np.dtype(dtype) != np.float32:
            raise ValueError(f"dtype={np.dtype(dtype)}: the port runs in float32 only "
                             "(its state and kernels are float32)")
        self.ndim = int(ndim)
        self.ntemps = int(ntemps)
        self.nchains = int(nchains)
        self.device = utils.resolve_device(device, "PTSampler")
        self.outDir = outDir
        self.verbose = verbose
        self.resume = resume
        self.jump_select = jump_select
        self.per_chain_mode = per_chain_mode
        self.de_pair = de_pair
        self.de_block = int(de_block)
        self.swap_mode = swap_mode
        self.adapt_from = adapt_from

        have_grads = logl_grad is not None and logp_grad is not None
        model = None
        if have_grads:
            model = _functor_model((logl, logp, logl_grad, logp_grad),
                                   (loglargs, loglkwargs, logpargs, logpkwargs))
        self._have_grads = have_grads
        if model is not None:
            self.route = "kernel"
            self._logl_traceable = self._logp_traceable = True
            self._model = model
            route = f"kernel (functor {model.cuda_functor!r})"
            if self.device.type == "cpu":
                route += ", its plain versions on the CPU"
            else:  # a user functor's libraries: built and loaded before any capture
                user.prepare(model, self.device)
        else:
            if have_grads and self.device.type == "cuda":
                raise NotImplementedError(
                    "on the card the gradient jumps run only through the CUDA kernels. They "
                    "take the bound methods lnlikefn, lnpriorfn, lnlikefn_grad and "
                    "lnpriorfn_grad, with no extra arguments, of a model object that also "
                    "gives the batched lnlike, lnprior and value_grad and names its device "
                    "functor in cuda_functor: a built-in one (csrc/models.cuh) or one "
                    "registered with ptmcmcsampler_torch.register_functor (the model's value "
                    "and gradient of one chain in CUDA C++, its constants from cuda_params; "
                    "README). These callables are not such methods. Pass "
                    'device="cpu", or leave out logl_grad/logp_grad to sample on the card '
                    "without gradient jumps")
            self.route = "plain"
            route = f"plain PyTorch on {self.device}"
            self._model = self._wrap_callables(
                logl, logp, logl_grad if have_grads else None,
                logp_grad if have_grads else None,
                loglargs or [], loglkwargs or {}, logpargs or [], logpkwargs or {},
            )
            if not all(getattr(self, f"_{what}_traceable", True)
                       for what in ("logl", "logp", "logl_grad", "logp_grad")):
                self.route = "host"
                route = (f"host callables from plain PyTorch on {self.device}; run_block "
                         "runs eagerly (a CUDA graph cannot hold a host call)")
        if self.verbose:
            print(f"Model route: {route}")

        self.groups = (
            tuple(tuple(int(i) for i in g) for g in groups)
            if groups is not None
            else (tuple(range(self.ndim)),)
        )
        self.cov0 = np.array(cov, dtype=np.float64)

        if seed is None:
            seed = int(np.random.SeedSequence().generate_state(1)[0])
        # Each sample() call seeds its generators from the next child of this
        # sequence, as the JAX package splits its key.
        self._seeds = np.random.SeedSequence(int(seed))
        # The checkpoint's JAX key leaf; it does not stand for the torch streams.
        self._key_words = np.random.SeedSequence(int(seed)).generate_state(2)

        self._custom_jumps = []
        self._aux_jumps = []
        self.state = None
        self.block_stats = None
        # Host seconds of the drains' and checkpoints' parts in the last
        # sample(), summed: "to_host" (the rows and counters copied from the
        # device), "format" and "write" (the chain files' rows), "sidecar"
        # (the all-chain rows), "cov_jumps" (cov.npy and the jump files),
        # "wait" (the overlapped loop's wait for a block's host copies), and
        # save_checkpoint's "checkpoint_*" parts.
        self.io_seconds = {}
        self.ladder = None
        self._chain_host = []  # cold chain 0 thinned history ([rows, D] blocks)
        # ALL cold chains ([rows, C, D] blocks) — a bounded in-RAM window of
        # the most recent thinned rows (the full history lives on disk in the
        # chain_all_<T>.bin sidecar). `_chains_host_row0` is the global
        # thinned-row index of the window's first retained row.
        self._chains_host = []
        self._chains_host_row0 = 0
        self._host_history_bytes = int(host_history_bytes)
        self._lnlike_host = []
        self._lnprob_host = []

        os.makedirs(self.outDir, exist_ok=True)

    def _wrap_callables(self, logl, logp, logl_grad, logp_grad, largs, lkw, pargs, pkw):
        """The plain route's batched model around the user callables."""
        wrapped = {}
        for what, f, args, kwargs, grad in (
            ("logl", logl, largs, lkw, False),
            ("logp", logp, pargs, pkw, False),
            ("logl_grad", logl_grad, largs, lkw, True),
            ("logp_grad", logp_grad, pargs, pkw, True),
        ):
            if f is None:
                wrapped[what] = None
                continue
            wrapped[what], traceable = _wrap_fn(f, args, kwargs, self.ndim, self.device, grad)
            setattr(self, f"_{what}_traceable", traceable)
            if not traceable:
                self._warn_host_callback(what)
        return _BatchedModel(wrapped["logl"], wrapped["logp"], wrapped["logl_grad"],
                             wrapped["logp_grad"])

    # ---------------------------------------------------------------- jumps

    def _warn_host_callback(self, what):
        """One loud line when a user callable runs on the host: correct, but
        every evaluation pays ntemps x nchains Python calls and a device
        round trip. Verbose-gated like the reference's warnings."""
        if not self.verbose:
            return
        print(
            "WARNING: %s is not traceable by torch.func.vmap; it will run on the "
            "host, one call a point - every iteration pays up to "
            "ntemps*nchains = %d host calls. Rewrite it with torch operations "
            "for batched sampling." % (what, self.ntemps * self.nchains)
        )

    def _protocol(self, batched, what):
        """``"torch"`` if ``batched`` (a ``proposals/custom.py`` batch of the
        user's callable) runs on the device, else ``"host"``, with the
        warning."""
        if custom.probe(batched, self.ndim, self.device):
            return "torch"
        self._warn_host_callback(what)
        return "host"

    def addProposalToCycle(self, func, weight, name=None):  # noqa: N802 (reference casing)
        """Register a custom jump (reference PTMCMCSampler.py:988-1014).

        Protocols (``proposals/custom.py``):
          * torch-native: ``func(rng, x, it, beta) -> (q, log_qxy)``, ``rng``
            the sampler's device generator and ``it`` a 0-d device tensor;
          * reference: ``func(x, it, beta) -> (q, log_qxy)``, batched on the
            device if ``torch.func.vmap`` batches it, else run on the host
            (numpy, float64, one call a chain).
        """
        if weight == 0:
            return
        name = name or getattr(func, "__name__", f"custom{len(self._custom_jumps)}")
        if _nparams(func) >= 4:
            fn, protocol = func, "torch"
        else:
            def fn(rng, x, it, beta, _f=func):
                return _f(x, it, beta)

            protocol = self._protocol(custom.batch_jump(fn), f"custom jump {name!r}")
            if protocol == "host":
                fn = func
        self._custom_jumps.append(JumpSpec(name, KIND_CUSTOM, weight, fn=fn, protocol=protocol))

    def addPriorDrawToCycle(self, draw, weight, name="DrawFromPrior"):  # noqa: N802
        """Register a prior-draw (independence) jump: propose ``q ~ prior``.

        ``draw`` is torch-native ``draw(rng) -> q[ndim]`` (``rng`` the
        sampler's device generator) or a numpy ``draw(np_rng) -> q[ndim]``
        taking a ``numpy.random.Generator`` (run on the host). The Hastings
        correction ``logp(x) - logp(q)`` assumes ``draw`` samples the
        density of the sampler's ``logp`` (up to a constant). BASELINE.json
        config 4; the reference has no built-in.
        """
        if weight == 0:
            return
        batched = custom.batch_draw(draw)
        protocol = self._protocol(lambda rng, x, betas, it: batched(rng, x),
                                  f"prior draw {name!r}")
        self._custom_jumps.append(JumpSpec(name, KIND_PRIOR, weight, fn=draw,
                                           protocol=protocol))

    def addAuxilaryJump(self, func, name=None):  # noqa: N802
        """Register an auxiliary jump applied after every proposal (reference
        PTMCMCSampler.py:1017-1028). Protocols: torch-native ``func(rng, x,
        q, it, beta) -> (q, log_qxy)``, or the reference's ``func(x, q, it,
        beta)`` (batched on the device if ``vmap`` batches it, else on the
        host, which makes every iteration eager)."""
        name = name or getattr(func, "__name__", f"aux{len(self._aux_jumps)}")
        if _nparams(func) >= 5:
            fn, protocol = func, "torch"
        else:
            def fn(rng, x, q, it, beta, _f=func):
                return _f(x, q, it, beta)

            batched = custom.batch_aux(fn)
            protocol = self._protocol(lambda rng, x, betas, it: batched(rng, x, x, betas, it),
                                      f"auxiliary jump {name!r}")
            if protocol == "host":
                fn = func
        self._aux_jumps.append(JumpSpec(name, KIND_CUSTOM, 1, fn=fn, protocol=protocol))

    def randomizeProposalCycle(self):  # noqa: N802 (reference casing)
        """Drop-in no-op (reference PTMCMCSampler.py:1031-1045): the
        reference's ``_jump`` draws a uniform index into the unshuffled cycle
        (:1058-1059), so the shuffle is distributionally irrelevant; here the
        weighted draw of ``proposals/cycle.py`` plays that role."""

    # --------------------------------------------------------------- sample

    def _build_config(self, weights, burn, tskip, cov_update, thin, hmc_kwargs,
                      mass_adapt=False, nuts_max_depth=10, ladder_kwargs=None,
                      nuts_trajectory=False):
        have_grads = self._have_grads
        jumps = build_default_jumps(
            SCAMweight=weights["SCAM"],
            AMweight=weights["AM"],
            DEweight=weights["DE"],
            NUTSweight=weights["NUTS"] if have_grads else 0,
            MALAweight=weights["MALA"] if have_grads else 0,
            HMCweight=weights["HMC"] if have_grads else 0,
            CHEESweight=weights.get("CHEES", 0) if have_grads else 0,
            burn=burn,
            have_grads=have_grads,
        ) + tuple(self._custom_jumps)
        return SamplerConfig(
            ndim=self.ndim,
            ntemps=self.ntemps,
            nchains=self.nchains,
            groups=self.groups,
            jumps=jumps,
            aux_jumps=tuple(self._aux_jumps),
            tskip=tskip,
            cov_update=cov_update,
            burn=burn,
            thin=thin,
            de_size=max(burn, self.nchains),
            nuts_max_depth=nuts_max_depth,
            nuts_trajectory=nuts_trajectory,
            jump_select=self.jump_select,
            per_chain_mode=self.per_chain_mode,
            de_pair=self.de_pair,
            de_block=self.de_block,
            swap_mode=self._resolved_swap_mode(),
            adapt_from=self.adapt_from,
            **(ladder_kwargs or {}),
            hmc_stepsize=hmc_kwargs.get("stepsize", 0.1),
            hmc_nminsteps=hmc_kwargs.get("nminsteps", 2),
            hmc_nmaxsteps=hmc_kwargs.get("nmaxsteps", 300),
            mass_adapt=mass_adapt,
        )

    def _initial_state(self, config, x0, cov, betas, seed):
        """``init_state`` at per-chain starts ``x0 [T, C, D]``, with the
        reference's -inf prior short-circuit of the likelihood (:481-487)."""
        xs = torch.as_tensor(np.ascontiguousarray(np.moveaxis(x0, 2, 1), dtype=np.float32),
                             device=self.device)
        lp0 = self._model.lnprior(xs)
        ll0 = torch.where(torch.isneginf(lp0), float("-inf"), self._model.lnlike(xs))
        return init_state(config, seed, x0, cov, betas, ll0, lp0, device=self.device)

    def sample(
        self,
        p0,
        Niter,
        ladder=None,
        Tmin=1,
        Tmax=None,
        Tskip=100,
        isave=1000,
        covUpdate=1000,
        SCAMweight=20,
        AMweight=20,
        DEweight=20,
        NUTSweight=20,
        MALAweight=20,
        HMCweight=20,
        CHEESweight=0,
        burn=10000,
        HMCstepsize=0.1,
        HMCsteps=300,
        maxIter=None,
        thin=10,
        i0=0,
        neff=None,
        writeHotChains=False,
        hotChain=False,
        trajectoryDir=None,
        write_burnin=False,
        profile_dir=None,
        adaptLadder=False,
        ladderAdaptLag=10000.0,
        ladderAdaptTime=100.0,
        massAdapt=False,
        NUTSmaxdepth=10,
    ):
        """Run PTMCMC sampling (reference ``sample``, PTMCMCSampler.py:374-528)."""
        if (maxIter is not None or i0 != 0) and self.verbose:
            # In the reference these size per-rank in-memory histories
            # (PTMCMCSampler.py:205-212, :419-421); blocks here are drained
            # to disk every isave, so there is nothing for them to size.
            print(
                "NOTE: maxIter/i0 are accepted for signature parity but have "
                "no effect (history is block-drained; see MIGRATION.md)"
            )
        Niter = int(Niter)
        if isave % thin != 0:
            raise ValueError(
                "isave = %d is not a multiple of thin =  %d" % (isave, thin)
            )
        if Niter % thin != 0 and self.verbose:
            print(
                "Niter = %d is not a multiple of thin = %d.  The last %d samples will be lost"
                % (Niter, thin, Niter % thin)
            )

        # Temperature ladder (reference :699-720).
        if ladder is not None:
            ladder = np.asarray(ladder, dtype=np.float64)
            self.ntemps = len(ladder)
        else:
            ladder = temperature_ladder(self.ndim, self.ntemps, tmin=Tmin, tmax=Tmax)
        self.ladder, betas = ladder_betas(ladder, hot_chain=hotChain)

        weights = dict(
            SCAM=SCAMweight, AM=AMweight, DE=DEweight, NUTS=NUTSweight,
            MALA=MALAweight, HMC=HMCweight, CHEES=CHEESweight,
        )
        # Multi-process run (the reference's ``mpirun -np N``, README.md:40-46):
        # every process runs sample() on its block of the mesh.
        self._multi = distributed.process_count() > 1
        self._owns_cold = not self._multi  # set at the first drain that holds it
        pid = distributed.process_index()
        mesh = self._resolve_mesh()
        config = self._build_config(
            weights, burn, Tskip, covUpdate, thin,
            dict(stepsize=HMCstepsize, nminsteps=2, nmaxsteps=HMCsteps),
            mass_adapt=bool(massAdapt), nuts_max_depth=int(NUTSmaxdepth),
            nuts_trajectory=trajectoryDir is not None,
            ladder_kwargs=dict(
                adapt_ladder=bool(adaptLadder),
                ladder_adapt_lag=float(ladderAdaptLag),
                ladder_adapt_time=float(ladderAdaptTime),
                ladder_adapt_skip_top=bool(hotChain),
            ),
        )
        self.config = config
        self._traj_writer = None
        if trajectoryDir is not None:
            if self._multi:
                raise NotImplementedError(
                    "trajectoryDir capture is not supported in multi-process runs; capture "
                    "trajectories in a single-process run")
            self._traj_writer = TrajectoryWriter(trajectoryDir, burn, write_burnin)
        if self.route == "kernel":
            why = card_refusal(self.device.type, self._model.cuda_functor, config.jumps,
                               self.ndim)
            if why is not None:
                raise NotImplementedError(
                    f"on the card, model {type(self._model).__name__}: {why}. Set that jump's "
                    'weight to 0, or pass device="cpu" to run every jump there')
        if MALAweight and self._have_grads and self.verbose:
            # The reference warns "MALA jumps are not working properly yet"
            # (:230-231) because its qxy misses the Gaussian normalization;
            # this implementation uses the corrected density ratio.
            print("NOTE: using corrected MALA density ratio "
                  "(reference MALA is known-broken)")

        _, run_block = build_step(config, self._model, device=self.device,
                                  capture=self.route != "host", mesh=mesh)
        self.block_stats = run_block.stats
        self._block = block = run_block.block

        p0 = np.asarray(p0, dtype=np.float64)
        x0 = np.broadcast_to(p0, (self.ntemps, self.nchains, self.ndim))
        init_seed = int(self._seeds.spawn(1)[0].generate_state(1)[0])
        # Process 0 creates and truncates the files (a shared outDir, as the
        # reference's rank 0 manages them); the others open them to append,
        # after a barrier.
        keep = self.resume or (self._multi and pid != 0)
        self.io_seconds = {}
        writer = ChainWriter(
            self.outDir, self.ladder, hot_chain=hotChain,
            write_hot_chains=writeHotChains, resume=keep, seconds=self.io_seconds,
        )
        writer.init_jump_files(config.jump_names(), resume=keep)
        barrier()
        self._writer = writer
        self._sidecar_reset = set()

        ckpt_path = os.path.join(self.outDir, "checkpoint.npz")
        start_iter = 0
        state = None
        # Drains completed so far (one <name>_jump.txt entry is appended per
        # drain); persisted in the checkpoint meta so torn-run resume can
        # truncate the series exactly. _try_resume overwrites it.
        self._drain_count = 0

        if self.resume:
            state, start_iter = self._try_resume(
                config, ckpt_path, writer, betas, x0, init_seed, isave, thin
            )
        # Resumed runs report "percent of new work" in the progress line
        # (reference PTMCMCSampler.py:358-366).
        self._resume_start_iter = start_iter if state is not None else 0

        if state is None:
            state = self._initial_state(config, x0, self.cov0, betas, init_seed)
            start_iter = 0
            self._drain_count = 0
            # Record + write the initial sample (reference :489-491).
            lnprob0 = state.lnprob.cpu().numpy()
            lnlike0 = state.lnlike.cpu().numpy()
            x_host = np.moveaxis(state.x.cpu().numpy(), 1, 2)  # [T, C, D]
            self._chain_host = [x_host[0, 0][None]]
            # Multi-process drains append their block's chains; the all-chain
            # window and the part sidecars start after the seed row.
            self._chains_host = [] if self._multi else [x_host[0][None]]
            if self._multi:
                self._chains_host_row0 = 1
            self._lnlike_host = [lnlike0[0, 0][None]]
            self._lnprob_host = [lnprob0[0, 0][None]]
            for ti in range(self.ntemps):
                if self._multi:
                    # Process 0 writes every rung's seed row and clears stale
                    # sidecars (they would shadow the new parts in load_all);
                    # the owners reset their sidecars at their first drain.
                    if pid == 0:
                        writer.clear_stale_sidecars(ti)
                        writer.append(ti, x_host[ti, 0][None], np.array([lnprob0[ti, 0]]),
                                      np.array([lnlike0[ti, 0]]), np.array([0.0]),
                                      np.array([1.0]))
                    continue
                writer.reset_all(ti, self.nchains, self.ndim)
                writer.append(
                    ti,
                    x_host[ti, 0][None],
                    np.array([lnprob0[ti, 0]]),
                    np.array([lnlike0[ti, 0]]),
                    np.array([0.0]),
                    np.array([1.0]),
                )
                writer.append_all(ti, x_host[ti][None])

        barrier()  # the seed rows and the cleared sidecars before any drain
        state = shard_state(state, block)  # this rank's block of the whole state
        self.state = state
        self.Niter = Niter
        tstart = time.time()
        it = start_iter
        rows_per_block = isave // thin
        last = Niter - (Niter % thin)
        run_complete = it >= last
        message = ""

        # Tracing: the sampling loop under torch.profiler, written as a
        # Chrome trace into profile_dir.
        prof = None
        if profile_dir is not None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()

        def drain(st, out, it_done):
            self._drain_block(st, out, it_done, tstart, Niter, writer, config)
            self._drain_count += 1

        def save(st, it_done):
            # Multi-process: the whole state gathered (a collective), which
            # process 0 alone writes.
            st = unshard_state(st, block)
            if pid == 0:
                self._save_checkpoint(
                    ckpt_path, st,
                    dict(iter=int(it_done), niter=int(Niter), thin=int(thin), isave=int(isave),
                         drains=int(self._drain_count), swap_mode=config.swap_mode),
                )

        # Double-buffered dispatch, the JAX package's loop (its sampler.py
        # :743-771) for a run without a neff stop: block k's rows and state
        # go to the host by copies enqueued right behind it; block k+1 is
        # dispatched, and block k is drained and checkpointed from those
        # copies while the device runs k+1. run_block calls back before k+1's
        # first synchronising step (the factor refresh), so the host writes
        # while the device works.
        if neff is None and not run_complete and not self._multi:
            pending = None  # the last block's host copies, not drained yet

            def drain_pending():
                nonlocal pending
                if pending is not None:
                    snap, out_h, done, it_done = pending
                    pending = None
                    if done is not None:
                        t0 = time.perf_counter()
                        done.synchronize()
                        self._timed("wait", t0)
                    drain(snap, out_h, it_done)
                    save(snap, it_done)

            while it < last:
                todo_iters = Niter - it
                rows = min(rows_per_block, max(todo_iters // thin, 1))
                state, out = run_block(state, rows, on_dispatched=drain_pending)
                it += rows * thin
                pending = (*self._to_host(state, out), it)
                self.state = state
            drain_pending()
            message = "\nRun Complete"
            run_complete = True

        # The serial loop, for a neff stop: its decision must see the block
        # just drained. Run a block, drain it, checkpoint.
        while not run_complete:
            todo_iters = Niter - it
            rows = min(rows_per_block, max(todo_iters // thin, 1))
            state, out = run_block(state, rows)
            it += rows * thin
            drain(state, out, it)
            self.state = state

            if it >= last:
                message = "\nRun Complete"
                run_complete = True
            elif neff is not None and it > 2 * burn:
                n_eff = self._neff_value(burn // thin, it)
                if int(n_eff) >= neff:
                    message = "\nRun Complete with {0} effective samples".format(int(n_eff))
                    run_complete = True
            if self._multi:
                # Only the owner of the cold chain 0 votes; every rank agrees
                # on the flag (the reference's comm.bcast(runComplete), :523),
                # so none runs a collective step alone.
                run_complete = any_rank(run_complete)
            save(state, it)

        if prof is not None:
            prof.stop()
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        if self.verbose:
            print(message)
        return state

    # ------------------------------------------------------------ internals

    @staticmethod
    def _to_host(state, out):
        """Block k's state and rows on the host, taken before block k+1 is
        dispatched: ``(state, rows, done)``, where on the card every
        tensor is a non-blocking copy into pinned memory, enqueued behind
        block k and so not waiting for block k+1, and ``done`` an event
        recorded after them (None on the CPU, where the copies are clones).
        The generators' states are taken now: a checkpoint written while
        block k+1 runs must hold block k's."""
        if state.x.is_cuda:
            def host(a):
                return torch.empty(a.shape, dtype=a.dtype, pin_memory=True).copy_(
                    a, non_blocking=True)
        else:
            host = torch.clone
        snap = map_state(state, host, rng=clone_generator(state.rng),
                         host_rng=clone_generator(state.host_rng))
        rows = BlockOutput(*(host(a) for a in out[:-1]),
                           traj=None if out.traj is None else out.traj.map(host))
        done = None
        if state.x.is_cuda:
            done = torch.cuda.Event()
            done.record()
        return snap, rows, done

    def _save_checkpoint(self, path, state, meta):
        save_checkpoint(path, state, meta=meta, key=self._key_words, seconds=self.io_seconds)

    def _timed(self, part, t0):
        """Add the host seconds since ``t0`` to ``io_seconds[part]``; returns now."""
        now = time.perf_counter()
        self.io_seconds[part] = self.io_seconds.get(part, 0.0) + now - t0
        return now

    def _neff_value(self, burn_rows, it):
        """Effective-sample-size estimate for the neff termination check
        (reference PTMCMCSampler.py:510-521, iter/tau on the rank-0 chain).

        With nchains > 1, every batched chain is pooled with the cross-chain
        (Stan-style) ESS: neff grows about linearly with chains. Multi-process:
        only the process holding drained cold-chain history votes; on every
        other one the history is the 1-row seed, whose tau of 1 would make
        n_eff = it and stop the run (the stop flag is OR-reduced).
        """
        if self.nchains > 1 and self._chains_host:
            arr = np.concatenate(self._chains_host, axis=0)  # [rows, C, D]
            # The in-RAM window may start after row 0 (bounded
            # retention / resume): slice in GLOBAL row coordinates.
            start = max(0, burn_rows - self._chains_host_row0)
            post = arr[start:]
            if post.shape[0] >= 8:
                chains = np.moveaxis(post, 0, 1)  # [C, rows, D]
                return float(np.min(diagnostics.multichain_ess(chains)))
            return 0.0
        if self._multi and not self._owns_cold:
            return 0.0
        chain = np.concatenate(self._chain_host, axis=0)
        tau = diagnostics.max_autocorr_time(chain[burn_rows:])
        return it / max(1.0, tau)

    def _resolved_swap_mode(self):
        """Effective swap mode for this run: an explicit ``swap_mode`` wins;
        a resumed run keeps the mode its checkpoint meta records (the
        replica-exchange law is part of the sampler's statistics); otherwise
        DEO where the rungs are split over the ranks (its neighbour sends
        replace the sweep's gather of every row), and the reference-parity
        sweep where they are not."""
        if self.swap_mode is not None:
            return self.swap_mode
        if self.resume:
            ckpt_mode = self._checkpoint_meta_value("swap_mode")
            if ckpt_mode in ("sweep", "deo"):
                return ckpt_mode
        mesh = self.mesh
        if mesh is not None and mesh.ntemp > 1 and self.ntemps > 1:
            if self.verbose:
                print("NOTE: the temperature axis is split over %d ranks; swap_mode='deo' "
                      "(neighbour exchange). Pass swap_mode='sweep' for the reference-parity "
                      "serial sweep." % mesh.ntemp)
            return "deo"
        return "sweep"

    def _resolve_mesh(self):
        """The mesh of this run, or None: an explicit ``mesh=`` wins; in a
        process group of more than one rank, the rungs split over the ranks
        where ``ntemps`` tiles them, else the chains (the JAX package's
        ``_resolve_mesh``)."""
        from .parallel import make_temp_mesh

        n = distributed.process_count()
        if self.mesh is not None:
            axes = self.mesh.axis_names
            if self.temp_axis not in axes and self.chain_axis not in axes:
                raise ValueError(f"mesh axes {axes} contain neither temp_axis="
                                 f"{self.temp_axis!r} nor chain_axis={self.chain_axis!r}")
            if self.mesh.size != n:
                raise ValueError(f"a mesh of {self.mesh.size} ranks in a group of {n} "
                                 "processes: one process a shard")
        else:
            if n <= 1:
                return None
            if self.ntemps % n == 0:
                self.mesh = make_temp_mesh(n, axis=self.temp_axis)
            elif self.nchains % n == 0:
                self.mesh = make_temp_mesh(n, axis=self.chain_axis)
            else:
                raise ValueError(f"{n} processes tile neither ntemps={self.ntemps} nor "
                                 f"nchains={self.nchains}; pass mesh=make_pt_mesh(...)")
        return self.mesh

    def _checkpoint_meta_value(self, key):
        """Read one field from the checkpoint meta sidecar, if present."""
        path = os.path.join(self.outDir, "checkpoint.npz.json")
        try:
            with open(path) as f:
                return json.load(f).get(key)
        except (OSError, ValueError):
            return None

    def _drain_block(self, state, out, it, tstart, Niter, writer, config):
        """Host-side block drain: chain files, jump stats, progress line."""
        if self._multi:
            return self._drain_block_multi(state, out, it, tstart, Niter, writer, config)
        # Device emission is chain-minor [rows, T, D, C]; host convention
        # stays [rows, T, C, D].
        t0 = time.perf_counter()
        x = np.moveaxis(out.x.cpu().numpy(), 2, 3)
        lnlike = out.lnlike.cpu().numpy()  # [rows, T], chain 0
        lnprob = out.lnprob.cpu().numpy()  # [rows, T]
        its = out.it.cpu().numpy().astype(np.int64)  # [rows]
        nacc = out.naccepted.cpu().numpy()  # [rows, T]
        sacc = out.swaps_accepted.cpu().numpy()  # [rows, T]
        sprop = out.swaps_proposed.cpu().numpy()  # [rows, T]
        ctr = state.counters
        rows = x.shape[0]
        t0 = self._timed("to_host", t0)

        if self._traj_writer is not None and out.traj is not None:
            for r in range(rows):
                self._traj_writer.write(int(its[r]), out.traj.row(r))

        self._chain_host.append(x[:, 0, 0, :])
        self._chains_host.append(x[:, 0, :, :])
        self._lnlike_host.append(lnlike[:, 0])
        self._lnprob_host.append(lnprob[:, 0])
        # Bound the all-chain in-RAM window (the full history is on disk in
        # chain_all_<T>.bin); drop oldest blocks past the byte budget.
        cap_rows = max(
            1, self._host_history_bytes // max(1, self.nchains * self.ndim * 4)
        )
        total_rows = sum(b.shape[0] for b in self._chains_host)
        while total_rows > cap_rows and len(self._chains_host) > 1:
            dropped = self._chains_host.pop(0)
            self._chains_host_row0 += dropped.shape[0]
            total_rows -= dropped.shape[0]

        denom = np.maximum(its, 1).astype(np.float64)
        for ti in range(self.ntemps):
            # Per-row cumulative rates, as the reference writes them
            # (PTMCMCSampler.py:731-745), from the per-row counter snapshots.
            acc_rate = nacc[:, ti] / denom
            if ti < self.ntemps - 1:
                pt_acc = np.where(
                    sprop[:, ti] > 0,
                    sacc[:, ti] / np.maximum(sprop[:, ti], 1),
                    1.0,
                )
            else:
                pt_acc = np.ones(rows)  # reference :737-739
            writer.append(
                ti,
                x[:, ti, 0, :],
                lnprob[:, ti],
                lnlike[:, ti],
                acc_rate,
                pt_acc,
            )
            writer.append_all(ti, x[:, ti, :, :])

        t0 = time.perf_counter()
        writer.write_cov(state.adapt.cov.cpu().numpy())
        w, _ = config.weights_and_activation()
        # Per-jump rates pooled over ALL cold chains (every chain at beta=1
        # targets the same distribution; reference format unchanged).
        writer.write_jump_stats(
            config.jump_names(), w,
            ctr.jump_proposed[:, 0].sum(-1).cpu().numpy(),
            ctr.jump_accepted[:, 0].sum(-1).cpu().numpy(),
        )
        self._timed("cov_jumps", t0)

        if self.verbose:
            self._progress(it, Niter, tstart,
                           float(ctr.naccepted[0].cpu().numpy().mean()) / max(it, 1))

    def _drain_block_multi(self, state, out, it, tstart, Niter, writer, config):
        """Multi-process block drain (the JAX package's
        ``_drain_block_multi``): each process writes the files of the rows it
        owns, the analogue of one chain file an MPI rank
        (PTMCMCSampler.py:341-372): the owner of a rung's chain 0 its chain
        file, each its block's all-chain rows (a part sidecar
        ``chain_all_<T>.c<c0>.bin`` where the chains are split); the pooled
        statistics are gathered (collectives every process runs) and
        process 0 writes them."""
        block = self._block
        x = np.moveaxis(out.x.cpu().numpy(), 2, 3)  # [rows, Tl, Cl, D]
        lnlike = out.lnlike.cpu().numpy()  # [rows, Tl], the block's first chain
        lnprob = out.lnprob.cpu().numpy()
        nacc = out.naccepted.cpu().numpy()
        sacc = out.swaps_accepted.cpu().numpy()
        sprop = out.swaps_proposed.cpu().numpy()  # [rows, T], every pair's
        its = out.it.cpu().numpy().astype(np.int64)
        rows, ncl = x.shape[0], x.shape[2]
        denom = np.maximum(its, 1).astype(np.float64)
        own_chain0 = block.c0 == 0
        cstart = None if ncl == self.nchains else block.c0

        if own_chain0 and block.t0 == 0:
            self._owns_cold = True
            self._chain_host.append(x[:, 0, 0, :])
            self._chains_host.append(x[:, 0, :, :])
            self._lnlike_host.append(lnlike[:, 0])
            self._lnprob_host.append(lnprob[:, 0])
            cap_rows = max(1, self._host_history_bytes // max(1, ncl * self.ndim * 4))
            total_rows = sum(b.shape[0] for b in self._chains_host)
            while total_rows > cap_rows and len(self._chains_host) > 1:
                dropped = self._chains_host.pop(0)
                self._chains_host_row0 += dropped.shape[0]
                total_rows -= dropped.shape[0]

        for lt, ti in enumerate(range(block.t0, block.t1)):
            if own_chain0:
                acc_rate = nacc[:, lt] / denom
                if ti < self.ntemps - 1:
                    pt_acc = np.where(sprop[:, ti] > 0,
                                      sacc[:, lt] / np.maximum(sprop[:, ti], 1), 1.0)
                else:
                    pt_acc = np.ones(rows)
                writer.append(ti, x[:, lt, 0, :], lnprob[:, lt], lnlike[:, lt], acc_rate, pt_acc)
            if ti not in self._sidecar_reset:
                self._sidecar_reset.add(ti)
                if not self.resume:
                    writer.reset_all(ti, ncl, self.ndim, cstart=cstart,
                                     nchains_total=self.nchains)
            writer.append_all(ti, x[:, lt], cstart=cstart, nchains_total=self.nchains)

        # The cold rung's counters over every chain, gathered from the ranks
        # of the first temperature shard (collectives: every process runs
        # them).
        ctr = state.counters
        jp, ja, nacc0 = (a.cpu().numpy() for a in gather_many(block, [
            (ctr.jump_proposed[:, 0], ("J", "C")), (ctr.jump_accepted[:, 0], ("J", "C")),
            (ctr.naccepted[0], ("C",))]))
        jp, ja = jp.sum(-1), ja.sum(-1)
        if distributed.process_index() == 0:
            writer.write_cov(state.adapt.cov.cpu().numpy())
            w, _ = config.weights_and_activation()
            writer.write_jump_stats(config.jump_names(), w, jp, ja)
            if self.verbose:
                self._progress(it, Niter, tstart, float(nacc0.mean()) / max(it, 1))

    def _progress(self, it, Niter, tstart, acceptance):
        """The progress line (reference PTMCMCSampler.py:358-366)."""
        sys.stdout.write("\r")
        percent = it / Niter * 100
        elapsed = time.time() - tstart
        start = int(getattr(self, "_resume_start_iter", 0) or 0)
        if start > 0 and Niter > start:
            percentnew = (it - start) / (Niter - start) * 100
            sys.stdout.write("Finished %2.2f percent (%2.2f percent of new work) in %f s "
                             "Acceptance rate = %g" % (percent, percentnew, elapsed, acceptance))
        else:
            sys.stdout.write("Finished %2.2f percent in %f s Acceptance rate = %g"
                             % (percent, elapsed, acceptance))
        sys.stdout.flush()

    def _try_resume(self, config, ckpt_path, writer, betas, x0, init_seed, isave, thin):
        """Resume from a full checkpoint, else from reference chain files."""
        if os.path.isfile(ckpt_path):
            try:
                state, meta, restored = load_checkpoint(
                    ckpt_path, config, self.device, init_seed)
            except (ValueError, KeyError):
                # Structure mismatch (e.g. a checkpoint of another config):
                # fall through to chain-file resume.
                state, meta = None, None
            if state is not None:
                it = int(meta["iter"]) if meta else state.it
                if self.verbose:
                    print(f"Resuming from checkpoint at iteration {it}")
                    if not restored:
                        print(
                            "NOTE: the checkpoint holds no torch generator state for "
                            f"{self.device.type} (a JAX checkpoint, or one from another "
                            "device); the random streams restart from the seed."
                        )
                # Torn-run cleanup: a kill between a drain and its checkpoint
                # leaves files a block ahead of the checkpoint; resume re-runs
                # that block, so rows past the checkpoint must be dropped or
                # they are duplicated.
                thin_ck = int(meta.get("thin", thin)) if meta else thin
                isave_ck = int(meta.get("isave", isave)) if meta else isave
                drained = it // max(thin_ck, 1)
                drains_ck = int(meta.get("drains", it // max(isave_ck, 1))) \
                    if meta else it // max(isave_ck, 1)
                self._drain_count = drains_ck
                if distributed.process_index() == 0:
                    for ti in range(self.ntemps):
                        writer.truncate_text(ti, 1 + drained)
                        writer.truncate_all(ti, 1 + drained, drained)
                    # The per-jump acceptance series gain one entry per
                    # drain; drop entries past the checkpoint too.
                    writer.truncate_jump_files(config.jump_names(), drains_ck)
                barrier()  # every process reads the files truncated
                self._reload_host_history()
                return state, it

        data = writer.existing_rows(0)
        if data is None or len(data) == 0:
            return None, 0
        rows = data.shape[0]
        # Warm-start the proposal covariance from the cov.npy the previous
        # run wrote at every drain — the reference writes the same file but
        # never reloads it (PTMCMCSampler.py:349-351, :290-319).
        cov_res = self.cov0
        cov_warm = False
        cov_path = os.path.join(self.outDir, "cov.npy")
        if os.path.isfile(cov_path):
            try:
                cov_cand = np.load(cov_path)
                if cov_cand.shape == (self.ndim, self.ndim) and np.all(
                    np.isfinite(cov_cand)
                ):
                    cov_res = cov_cand
                    cov_warm = True
            except (OSError, ValueError):
                pass
        if self.verbose:
            print("Resuming run from chain file {0}".format(writer.fnames[0]))
            if cov_warm:
                print(
                    "NOTE: no usable full-state checkpoint found - proposal "
                    "covariance warm-started from cov.npy; other adaptive "
                    "state (DE buffer, step sizes, ladder) restarts from its "
                    "initial values."
                )
            else:
                print(
                    "WARNING: no usable full-state checkpoint found - adaptive "
                    "state (covariance, DE buffer, step sizes, ladder) restarts "
                    "from its initial values and will re-burn in."
                )
        if isave != thin and rows % (isave / thin) != 1:  # reference :301-309
            raise RuntimeError(
                "Old chain has {0} rows, which is not the initial sample plus "
                "a multiple of isave/thin = {1}".format(rows, isave // thin)
            )
        # Rebuild per-temperature positions: every chain's own last position
        # from the chain_all sidecar when present (so a resumed batch
        # restarts non-degenerate); otherwise broadcast the text file's last
        # row (the reference-format-only fallback, one chain of data).
        x_res = np.array(np.broadcast_to(x0, (self.ntemps, self.nchains, self.ndim)))
        for ti in range(self.ntemps):
            tail = writer.load_all(ti, tail_rows=1)
            if tail is not None and tail.shape[1] == self.nchains:
                x_res[ti, :, :] = tail[-1]
                continue
            d = writer.existing_rows(ti)
            if d is not None and len(d):
                x_res[ti, :, :] = d[-1, : self.ndim]
        state = self._initial_state(config, x_res, cov_res, betas, init_seed)
        it = (rows - 1) * thin
        self._drain_count = (rows - 1) // max(isave // thin, 1)
        # Restore the acceptance counter from the file column (reference :599).
        state.it = it
        state.counters.naccepted.fill_(int(data[-1, -2] * it))
        self._reload_host_history(data)
        return state, it

    def _reload_host_history(self, data=None):
        if data is None:
            data = self._writer.existing_rows(0)
        if data is None or len(data) == 0:
            return
        self._chain_host = [data[:, : self.ndim]]
        self._lnprob_host = [data[:, -4]]
        self._lnlike_host = [data[:, -3]]
        cap_rows = max(
            1, self._host_history_bytes // max(1, self.nchains * self.ndim * 4)
        )
        total_rows = self._writer.all_rows_count(0)
        if self._multi:
            # Multi-process drains append their block's chains, so the window
            # restarts at the resume point (+1: the parts start after the
            # seed row, which only the text file holds).
            self._chains_host = []
            self._chains_host_row0 = total_rows + 1
            return
        all_rows = self._writer.load_all(0, tail_rows=cap_rows)
        if all_rows is not None and all_rows.shape[1] == self.nchains:
            self._chains_host = [all_rows]
            self._chains_host_row0 = total_rows - all_rows.shape[0]
        else:
            # No usable sidecar: the window restarts at the resume point.
            self._chains_host = []
            self._chains_host_row0 = data.shape[0]

    # ------------------------------------------------------------ accessors

    @property
    def chain(self):
        """Thinned cold-chain history [rows, ndim] for chain index 0
        (reference self._chain, one chain per rank)."""
        if not self._chain_host:
            return np.zeros((0, self.ndim))
        return np.concatenate(self._chain_host, axis=0)

    @property
    def chains(self):
        """ALL batched cold chains, chains-major [nchains, rows, ndim]. Feed
        directly to :func:`ptmcmcsampler_torch.diagnostics.multichain_ess`.

        This is the bounded in-RAM window of the most recent rows (see
        ``host_history_bytes``, default 2 GiB); ``chains_row0`` gives the
        window start's global thinned-row index, and the complete history is
        on disk in ``chain_all_<T>.bin`` (``ChainWriter.load_all``)."""
        if not self._chains_host:
            return np.zeros((self.nchains, 0, self.ndim))
        return np.moveaxis(np.concatenate(self._chains_host, axis=0), 0, 1)

    @property
    def chains_row0(self):
        """Global thinned-row index of ``chains``' first retained row."""
        return self._chains_host_row0

    @property
    def pooled_chain(self):
        """All cold-chain samples pooled into one [rows * nchains, ndim]
        (same retention window as :attr:`chains`)."""
        return self.chains.reshape(-1, self.ndim)

    @property
    def lnprob_chain(self):
        return np.concatenate(self._lnprob_host, axis=0) if self._lnprob_host else np.zeros(0)

    @property
    def lnlike_chain(self):
        return np.concatenate(self._lnlike_host, axis=0) if self._lnlike_host else np.zeros(0)

    @property
    def cov(self):
        if self.state is None:
            return self.cov0
        return self.state.adapt.cov.cpu().numpy()

    # Reference counter attribute parity (PTMCMCSampler.py:214-216): scalars
    # for the cold chain 0, as analysis scripts read them.

    @property
    def naccepted(self):
        if self.state is None:
            return 0
        return int(self.state.counters.naccepted[0, 0])

    @property
    def swapProposed(self):  # noqa: N802 (reference casing)
        if self.state is None:
            return 0
        return int(self.state.counters.swaps_proposed[0])

    @property
    def nswap_accepted(self):
        if self.state is None:
            return 0
        return int(self.state.counters.swaps_accepted[0, 0])
