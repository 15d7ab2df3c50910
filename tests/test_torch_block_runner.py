"""The block runner of ``kernel.run_block`` and the sampler's overlapped
drain, on the CPU, against the eager loop they replace.

* The runner (the step split into ``step_key`` and a body written into a
  static state) against the eager ``run_block`` it replaced, which this file
  keeps as :func:`eager_run_block`: path 1 (SCAM/AM/DE/ChEES) and path 2
  (SCAM/AM/DE/NUTS/HMC) on the curved model and the 50-D hierarchy, over
  blocks that cross ``burn``, swap iterations and factor refreshes, with the
  DE ring narrower and wider than the chain batch, and with ``mass_adapt``
  (the structure tag turns "dense"). Twice: as the CPU runs it (every
  iteration eager) and with graphs simulated (a graph stand-in replays the
  captured body with the host values it was captured with, as a CUDA graph
  holds them), which fails if a host-side decision is missing from the key.
* The device-indexed DE ring push against the slice push it replaced.
* ``PTSampler.sample``'s overlapped loop against its serial loop (reached
  with a ``neff`` too large to stop the run): the same bytes in every file.

Tolerances: none; every comparison is bitwise.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ptmcmcsampler_torch import PTSampler, SamplerConfig, build_default_jumps, init_state
from ptmcmcsampler_torch import kernel as t_kernel
from ptmcmcsampler_torch import utils
from ptmcmcsampler_torch.adaptation import de_buffer_push, de_valid_rows
from ptmcmcsampler_torch.kernel import BlockOutput, build_step
from ptmcmcsampler_torch.models import CurvedLikelihood, HierarchicalGaussian
from ptmcmcsampler_torch.proposals.cycle import draw_kinds
from ptmcmcsampler_torch.state import DEState, copy_into, de_fill_count, state_tensors

torch.set_num_threads(2)


def eager_run_block(step, config, state, nrows):
    """``run_block`` as it was before the runner: ``step`` after ``step``,
    a thinned row every ``thin`` iterations."""
    t, dev, thin = config.ntemps, state.x.device, config.thin
    kinds = draw_kinds(config, state.it, nrows * thin, state.host_rng)
    x = torch.empty((nrows,) + tuple(state.x.shape), dtype=state.x.dtype, device=dev)
    lnlike = torch.empty((nrows, t), dtype=state.x.dtype, device=dev)
    lnprob = torch.empty_like(lnlike)
    nacc = torch.empty((nrows, t), dtype=torch.int32, device=dev)
    sacc = torch.empty_like(nacc)
    sprop = torch.empty_like(nacc)
    for r in range(nrows):
        for k in range(thin):
            state = step(state, kinds[r * thin + k])
        x[r] = state.x
        lnlike[r] = state.lnlike[:, 0]
        lnprob[r] = utils.tempered_lnprob(state.lnlike[:, 0], state.lnprior[:, 0], state.betas)
        nacc[r] = state.counters.naccepted[:, 0]
        sacc[r] = state.counters.swaps_accepted[:, 0]
        sprop[r] = state.counters.swaps_proposed
    its = torch.arange(1, nrows + 1, device=dev) * thin + (state.it - nrows * thin)
    return state, BlockOutput(x, lnlike, lnprob, its, nacc, sacc, sprop)


class _Replay:
    """A CUDA graph's stand-in on the CPU: ``replay()`` runs the captured
    body again on the holder's current tensors, with the host fields the
    body reads (the DE fill count, the structure tag) and its arguments as
    they were at capture, as a graph holds them frozen."""

    def __init__(self, fn, static):
        self.fn, self.static = fn, static
        self.frozen = (static.de.filled, static.adapt.structure)

    def replay(self):
        now = (self.static.de.filled, self.static.adapt.structure)
        self.static.de.filled, self.static.adapt.structure = self.frozen
        self.fn()
        self.static.de.filled, self.static.adapt.structure = now


class _SimulatedGraphs:
    """``kernel._CudaGraphs`` on the CPU: warm-ups run eagerly, captures
    return a :class:`_Replay`."""

    def __init__(self, device):
        pass

    def warm_up(self, fn):
        fn()

    def capture(self, fn, static):
        return _Replay(fn, static)


@pytest.fixture
def simulated_graphs(monkeypatch):
    """``run_block`` on the CPU takes its card branch: a key's first
    iteration eager, its second captured, every later one replayed."""
    monkeypatch.setattr(t_kernel, "_graphs_on", lambda device: True)
    monkeypatch.setattr(t_kernel, "_CudaGraphs", _SimulatedGraphs)


def _model(name):
    return CurvedLikelihood() if name == "curved" else HierarchicalGaussian()


def _config(model, path, nchains, de_size, burn=12, mass_adapt=False):
    grads = dict(CHEESweight=20) if path == "chees" else dict(NUTSweight=10, HMCweight=10)
    d = model.ndim
    return SamplerConfig(
        ndim=d, ntemps=3, nchains=nchains, groups=(tuple(range(d)),),
        jumps=build_default_jumps(SCAMweight=10, AMweight=10, DEweight=10, burn=burn,
                                  have_grads=True, **grads),
        tskip=3, cov_update=10, burn=burn, thin=2, de_size=de_size, hmc_stepsize=0.08,
        hmc_nmaxsteps=12, nuts_max_depth=4, chees_max_steps=16, mass_adapt=mass_adapt,
    )


def _state(config, model, seed=5):
    d, t, c = config.ndim, config.ntemps, config.nchains
    x0 = np.full(d, 0.3) if d > 2 else np.array([-0.1, -0.5])
    xs = torch.tensor(x0, dtype=torch.float32)[None, :, None].expand(t, d, c)
    betas = 1.0 / 1.5 ** np.arange(t)
    return init_state(config, seed, x0, np.eye(d), betas, model.lnlike(xs), model.lnprior(xs),
                      device="cpu")


def _bytes(a):
    return a.detach().contiguous().numpy().tobytes()


def assert_states_equal(a, b):
    """Every tensor, host field and generator state equal, bit for bit."""
    ta, tb = state_tensors(a), state_tensors(b)
    assert sorted(ta) == sorted(tb)
    for path in ta:
        assert ta[path].dtype == tb[path].dtype and _bytes(ta[path]) == _bytes(tb[path]), path
    assert (a.it, a.de.filled, a.adapt.structure) == (b.it, b.de.filled, b.adapt.structure)
    for name in ("rng", "host_rng"):
        assert torch.equal(getattr(a, name).get_state(), getattr(b, name).get_state()), name


def assert_outputs_equal(a, b):
    for field, x, y in zip(BlockOutput._fields, a, b):
        if field == "traj" and x is None and y is None:  # no trajectory capture
            continue
        if field == "traj":
            assert x is not None and y is not None, field
            for u, v in zip(x.tensors(), y.tensors()):
                assert _bytes(u) == _bytes(v), field
            continue
        assert x.dtype == y.dtype and _bytes(x) == _bytes(y), field


# (model, path, chains, DE ring columns, burn, mass_adapt): the ring
# narrower than the batch (its start always 0) or wider (its start wraps;
# with burn 2, DE runs while the ring fills, so its draw range, a part of
# the key, changes between DE iterations).
CASES = {
    "curved-chees-ring-wraps": ("curved", "chees", 16, 400, 2, False),
    "curved-nuts-ring-full": ("curved", "nuts", 128, 64, 12, False),
    "curved-chees-mass-adapt": ("curved", "chees", 64, 64, 12, True),
    "hierarchical-chees-ring-wraps": ("hierarchical", "chees", 32, 100, 12, False),
    "hierarchical-nuts-ring-full": ("hierarchical", "nuts", 32, 32, 12, False),
    "hierarchical-nuts-mass-adapt": ("hierarchical", "nuts", 32, 32, 12, True),
}
BLOCKS, ROWS = 2, 10  # two blocks of 20 iterations: refreshes at 10, 20, 30, 40


def _run_both(case, **config_kw):
    name, path, c, de_size, burn, mass = CASES[case]
    model = _model(name)
    cfg = _config(model, path, c, de_size, burn=burn, mass_adapt=mass, **config_kw)
    step, run_block = build_step(cfg, model, device="cpu")
    ref, got = _state(cfg, model), _state(cfg, model)
    pairs = []
    for _ in range(BLOCKS):
        ref, ref_out = eager_run_block(step, cfg, ref, ROWS)
        got, got_out = run_block(got, ROWS)
        pairs.append((ref_out, got_out))
    return cfg, ref, got, pairs, run_block.stats


@pytest.mark.parametrize("graphs", ["eager", "simulated graphs"])
@pytest.mark.parametrize("case", list(CASES))
def test_runner_equals_the_eager_run_block(case, graphs, request):
    """State, rows, counters, step sizes, the DE ring and both generators
    after each block equal the eager loop's, bit for bit."""
    if graphs == "simulated graphs":
        request.getfixturevalue("simulated_graphs")
    cfg, ref, got, pairs, stats = _run_both(case)
    for ref_out, got_out in pairs:
        assert_outputs_equal(ref_out, got_out)
    assert_states_equal(ref, got)
    iters = BLOCKS * ROWS * cfg.thin
    assert stats.iterations == iters and stats.refreshes == iters // cfg.cov_update
    kinds = {s.kind for s in cfg.jumps}
    assert int(got.counters.jump_proposed[:, 0, 0].gt(0).sum()) == len(kinds)  # every jump ran
    if graphs == "eager":
        assert stats.eager["no capture"] == iters and not stats.recorded
    else:
        # Each key's first iteration warms up, its second captures.
        keys = len(stats.recorded)
        assert stats.eager["warm-up"] >= keys and stats.captured == keys > 0
        assert sum(stats.replays.values()) + stats.eager["warm-up"] == iters
    if CASES[case][5]:  # mass_adapt: a refresh makes the factor dense
        assert got.adapt.structure == "dense"
    if CASES[case][0] == "hierarchical" and not CASES[case][5]:
        assert got.adapt.structure == "diagonal"


def test_step_key_holds_every_host_decision():
    """The key's parts at the iterations where each decision turns."""
    model = CurvedLikelihood()
    cfg = _config(model, "chees", 16, 100, burn=2)
    state = _state(cfg, model)
    kind = {s.kind: i for i, s in enumerate(cfg.jumps)}
    key = t_kernel.step_key
    assert key(cfg, state, 3, kind["scam"]) == (kind["scam"], ("sweep",), None, None,
                                                 state.adapt.structure)
    assert key(cfg, state, 4, kind["scam"])[1] is None
    assert key(cfg, state, 2, kind["chees"])[2] is True
    assert key(cfg, state, 3, kind["chees"])[2] is False
    assert key(cfg, state, 3, kind["de"])[3] == de_valid_rows(state.de) == 0
    state.de = DEState(buf=state.de.buf, filled=48)
    assert key(cfg, state, 4, kind["de"])[3] == 48


def test_simulated_graphs_catch_a_key_without_the_burn_flag(simulated_graphs, monkeypatch):
    """The simulation sees what a graph freezes: with the burn flag left out
    of the key, a ChEES graph captured during burn-in replays its adaptation
    after it, and the runner leaves the eager loop."""
    real = t_kernel.step_key
    monkeypatch.setattr(t_kernel, "step_key",
                        lambda *a: real(*a)[:2] + (None,) + real(*a)[3:])
    _, ref, got, _, _ = _run_both("hierarchical-chees-ring-wraps")
    with pytest.raises(AssertionError):
        assert_states_equal(ref, got)


def test_on_dispatched_runs_before_the_first_refresh():
    """``on_dispatched`` is called once, after the refresh iteration's step
    and before its refresh, or at the block's end without one."""
    model = CurvedLikelihood()
    cfg = _config(model, "chees", 16, 64)
    _, run_block = build_step(cfg, model, device="cpu")
    holder, _ = run_block(_state(cfg, model), 1)  # iterations 1-2
    cov0 = holder.adapt.cov.clone()
    seen = []

    def note():
        seen.append((holder.it, torch.equal(holder.adapt.cov, cov0)))

    run_block(holder, 2, on_dispatched=note)  # 3-6: no refresh
    run_block(holder, 3, on_dispatched=note)  # 7-12: refresh at 10
    assert seen == [(6, True), (10, True)]
    assert not torch.equal(holder.adapt.cov, cov0)


def test_run_block_writes_a_foreign_state_into_its_holder():
    """A state that is not the runner's holder (a loaded checkpoint, a
    resume) is copied into it; the returned state is the holder, advanced
    in place, and the caller's state is left as it was."""
    model = CurvedLikelihood()
    cfg = _config(model, "chees", 16, 64)
    step, run_block = build_step(cfg, model, device="cpu")
    first, _ = run_block(_state(cfg, model, seed=1), 2)
    other = _state(cfg, model, seed=2)
    x_before = other.x.clone()
    ref, ref_out = eager_run_block(step, cfg, _state(cfg, model, seed=2), 2)
    got, got_out = run_block(other, 2)
    assert got is first and torch.equal(other.x, x_before)
    assert_states_equal(ref, got)
    assert_outputs_equal(ref_out, got_out)
    wrong = _state(_config(model, "chees", 8, 64), model)
    with pytest.raises(ValueError, match="copy_into: x"):
        copy_into(got, wrong)


def _slice_push(buf, filled, xs):
    """The slice version the device-indexed push replaced."""
    rows, m = buf.shape[1], xs.shape[1]
    start = filled % rows
    head = min(m, rows - start)
    buf[:, start:start + head] = xs[:, :head]
    if head < m:
        buf[:, : m - head] = xs[:, head:]
    return de_fill_count(filled + m, rows)


@pytest.mark.parametrize("rows, m", [(10, 4), (7, 7), (9, 2)])
def test_device_indexed_push_writes_the_slice_bytes(rows, m):
    """Over several wraps, the same bytes in the ring and the same host
    count as the slice push; the device start stays ``filled % rows``."""
    gen = np.random.default_rng(rows * m)
    ref = torch.zeros(3, rows)
    de = DEState(buf=torch.zeros(3, rows), filled=0)
    filled = 0
    for _ in range(3 * rows):
        xs = torch.tensor(gen.normal(size=(3, m)), dtype=torch.float32)
        filled = _slice_push(ref, filled, xs)
        de = de_buffer_push(de, xs)
        assert _bytes(de.buf) == _bytes(ref)
        assert de.filled == filled and int(de.start) == filled % rows


# ------------------------------------------------------------ the sampler


def _files(outdir):
    """Every file's bytes; the checkpoint's ``.npz`` as its arrays' names,
    types, shapes and bytes (the zip container stamps the write time)."""
    out = {}
    for name in sorted(os.listdir(outdir)):
        path = os.path.join(outdir, name)
        if name == "checkpoint.npz":
            with np.load(path) as data:
                out[name] = {k: (data[k].dtype.str, data[k].shape, data[k].tobytes())
                             for k in data.files}
        else:
            with open(path, "rb") as f:
                out[name] = f.read()
    return out


_WEIGHTS = {
    "chees": dict(SCAMweight=10, AMweight=10, DEweight=10, CHEESweight=20, NUTSweight=0,
                  HMCweight=0, MALAweight=0),
    "nuts_hmc": dict(SCAMweight=10, AMweight=10, DEweight=10, CHEESweight=0, NUTSweight=10,
                     HMCweight=10, MALAweight=0),
}


def _sampler_run(outdir, niter, cycle, neff=None, resume=False, calls=None):
    cl = CurvedLikelihood()
    s = PTSampler(2, cl.lnlikefn, cl.lnpriorfn, np.eye(2), logl_grad=cl.lnlikefn_grad,
                  logp_grad=cl.lnpriorfn_grad, ntemps=2, nchains=32, seed=11, outDir=outdir,
                  resume=resume, device="cpu", verbose=False)
    if calls is not None:  # count the overlapped loop's host copies
        real = s._to_host
        s._to_host = lambda *a: calls.append(1) or real(*a)
    s.sample([-0.1, -0.5], niter, burn=100, Tskip=5, isave=100, covUpdate=100, thin=2,
             HMCstepsize=0.08, HMCsteps=20, NUTSmaxdepth=5, neff=neff, **_WEIGHTS[cycle])
    return s


@pytest.mark.parametrize("cycle", list(_WEIGHTS))
def test_overlapped_loop_writes_the_serial_loops_bytes(tmp_path, cycle):
    """Chain files, the ``chain_all`` sidecars, jump files, ``cov.npy`` and
    the checkpoint (its arrays and meta) are the same bytes whether each
    block is drained after the next is dispatched or before."""
    calls, serial_calls = [], []
    _sampler_run(str(tmp_path / "overlapped"), 400, cycle, calls=calls)
    serial = _sampler_run(str(tmp_path / "serial"), 400, cycle, neff=10**12, calls=serial_calls)
    assert len(calls) == 4 and not serial_calls and serial.state.it == 400
    a, b = _files(str(tmp_path / "overlapped")), _files(str(tmp_path / "serial"))
    assert sorted(a) == sorted(b)
    assert {"chain_1.0.txt", "chain_all_1.0.bin", "cov.npy", "jumps.txt", "checkpoint.npz",
            "checkpoint.npz.json"} <= set(a)
    for name in a:
        assert a[name] == b[name], name


def test_resume_from_an_overlapped_checkpoint_continues(tmp_path):
    """An overlapped run of N resumed (overlapped) to 2N writes the bytes of
    a serial run of 2N."""
    parts = str(tmp_path / "parts")
    _sampler_run(parts, 200, "chees")
    s = _sampler_run(parts, 400, "chees", resume=True)
    assert s._resume_start_iter == 200
    _sampler_run(str(tmp_path / "whole"), 400, "chees", neff=10**12)
    a, b = _files(parts), _files(str(tmp_path / "whole"))
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name] == b[name], name


def test_host_callables_take_the_host_route(tmp_path, simulated_graphs):
    """Numpy callables run on the host, which a graph cannot hold: the route
    says so, and ``run_block`` runs every iteration eagerly where another
    route would capture."""
    s = PTSampler(2, lambda x: -0.5 * float(np.sum(np.asarray(x) ** 2)), lambda x: 0.0,
                  np.eye(2), ntemps=2, nchains=4, seed=3, outDir=str(tmp_path), device="cpu",
                  verbose=False)
    assert s.route == "host"
    s.sample([0.1, 0.2], 20, burn=10, thin=2, isave=10, Tskip=5)
    assert s.block_stats.eager["no capture"] == 20 and not s.block_stats.recorded


def test_map_state_holder_has_addresses_of_its_own():
    model = CurvedLikelihood()
    cfg = _config(model, "chees", 16, 64)
    state = _state(cfg, model)
    holder = t_kernel.map_state(state, torch.clone)
    for path, a in state_tensors(holder).items():
        assert a.data_ptr() != state_tensors(state)[path].data_ptr(), path
    assert holder.rng is state.rng and dataclasses.is_dataclass(holder)
