"""The port's sharded-run pieces in one process, against the unsharded run
and the JAX package (``tests/test_sharding.py``'s counterparts):

* the mesh's layout and errors (the JAX package's messages: a ``ntemps``
  the temperature axis does not tile, a grid that does not tile the
  processes), and ``initialize_distributed`` a no-op with nothing to join;
* the shard-local DEO body (``swaps.deo_shard_take`` and
  ``deo_shard_move``, what each rank runs between its neighbour sends),
  shard by shard, bit for bit against the JAX package's ``deo_swap_apply``
  on its own uniforms, at both parities;
* every draw of a block (``utils.Block.draw``) equal to its block of the
  unsharded draw, and each branch that needs no cross-chain statistic
  (SCAM, AM, DE in its three pair laws, MALA, HMC, NUTS) run on a block
  equal to its block of the whole batch's run, the generators alike after;
* the NUTS reservoir's uniforms and the HMC draws of a block, from its
  counter base ``n0`` and the unsharded ``C``, equal to the rows of the
  unsharded call;
* ``state_sharding``'s placement of every field against the JAX package's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptmcmcsampler_torch import SamplerConfig, build_default_jumps, init_state, swaps
from ptmcmcsampler_torch.kernel import make_context
from ptmcmcsampler_torch.models import CurvedLikelihood
from ptmcmcsampler_torch.ops.hmc import hmc_draws
from ptmcmcsampler_torch.ops.nuts import nuts_uniforms
from ptmcmcsampler_torch.parallel import distributed, mesh as t_mesh
from ptmcmcsampler_torch.proposals.cycle import build_jump_branches
from ptmcmcsampler_torch.state import SS_FIELDS
from ptmcmcsampler_torch.utils import Block
from ptmcmcsampler_tpu import swaps as j_swaps

torch.set_num_threads(2)


# ---- the mesh ----------------------------------------------------------------

def test_mesh_layout():
    m = t_mesh.PTMesh(2, 4, rank=6)
    assert m.shape == {"temp": 2, "chain": 4} and (m.ti, m.ci) == (1, 2)
    blk = m.block(8, 64)
    assert (blk.t0, blk.t1, blk.c0, blk.c1) == (4, 8, 32, 48) and blk.n0 == 4 * 64 + 32
    assert [m.bounds(r, 8, 64) for r in (0, 3)] == [(0, 4, 0, 16), (0, 4, 48, 64)]
    assert not t_mesh.PTMesh().block(8, 64).sharded


def test_mesh_rejects_what_does_not_tile():
    m = t_mesh.PTMesh(4, 2)
    with pytest.raises(ValueError, match="multiple of mesh axis 'temp'"):
        m.block(6, 64)
    with pytest.raises(ValueError, match="multiple of mesh axis 'chain'"):
        m.block(8, 63)


def test_pt_mesh_rejects_bad_chain_split(monkeypatch):
    """One process a shard: a grid that leaves processes over, or needs
    more than there are, is refused."""
    monkeypatch.setattr(distributed, "process_count", lambda: 3)
    with pytest.raises(ValueError, match="multiple of the"):
        distributed.make_pt_mesh(ntemp_devices=1, nchain_devices=2)
    with pytest.raises(ValueError, match="needs more than 3 devices"):
        distributed.make_pt_mesh(ntemp_devices=2, nchain_devices=4)


def test_sampler_mesh_divisibility_raises(tmp_path, monkeypatch):
    """A ``mesh=`` whose temperature axis does not tile ``ntemps``: the JAX
    package's error, before any iteration (eight ranks stood in)."""
    from ptmcmcsampler_torch import PTSampler

    monkeypatch.setattr(distributed, "process_count", lambda: 8)
    monkeypatch.setattr(distributed, "process_index", lambda: 0)
    s = PTSampler(3, lambda x: -0.5 * torch.sum(x**2), lambda x: torch.zeros(()), np.eye(3),
                  ntemps=6, nchains=8, outDir=str(tmp_path), verbose=False, seed=1,
                  mesh=t_mesh.make_temp_mesh(8), device="cpu")
    with pytest.raises(ValueError, match="multiple of mesh axis"):
        s.sample(np.zeros(3), 50, burn=20, thin=1, isave=50,
                 SCAMweight=20, AMweight=20, DEweight=20)


def test_initialize_distributed_serial_noop():
    distributed.initialize_distributed()
    distributed.initialize_distributed()
    assert distributed.process_count() == 1
    assert not t_mesh.make_temp_mesh().block(4, 8).sharded


# ---- DEO, shard by shard -----------------------------------------------------

def _swap_rows(seed, t, c=64, d=3):
    """Random rows, the top one and part of row 2 at -inf (as
    ``tests/test_swaps_impl.py``), betas descending."""
    rng = np.random.default_rng(seed)
    lnlike = rng.normal(size=(t, c)).astype(np.float32)
    lnlike[-1] = -np.inf
    lnlike[2, :5] = -np.inf
    lnprior = rng.normal(size=(t, c)).astype(np.float32)
    x = rng.normal(size=(t, d, c)).astype(np.float32)
    betas = np.sort(rng.uniform(0.01, 1.0, size=t).astype(np.float32))[::-1].copy()
    return x, lnlike, lnprior, betas


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("parity", [0, 1])
def test_deo_shard_body_matches_jax(parity, shards):
    t = 8
    x, lnlike, lnprior, betas = _swap_rows(parity + 10 * shards, t)
    c = lnlike.shape[1]
    key = jax.random.key(3 + parity)
    want = j_swaps.deo_swap_apply(key, *(jnp.asarray(a) for a in (x, lnlike, lnprior, betas)),
                                  parity)
    us = torch.tensor(np.asarray(j_swaps.pair_uniforms(key, t, c))[:-1])
    rows = [torch.tensor(a) for a in (x, lnlike, lnprior, betas)]
    tl = t // shards
    blocks = [Block(t, c, k * tl, (k + 1) * tl) for k in range(shards)]
    parts = [[blk.take(a, ("T",) + (None,) * (a.dim() - 1)) for a in rows] for blk in blocks]
    takes = []
    for k, blk in enumerate(blocks):
        up = parts[k + 1] if k + 1 < shards else None
        take, _ = swaps.deo_shard_take(swaps.block_uniforms(us, blk), parts[k][1], parts[k][3],
                                       None if up is None else up[1][0],
                                       None if up is None else up[3][0], parity, blk.t0, t)
        takes.append(take)
    got = [[] for _ in range(4)]
    for k in range(shards):
        up = None if k + 1 == shards else [a[0] for a in parts[k + 1][:3]]
        down = None if k == 0 else [a[-1] for a in parts[k - 1][:3]]
        new = swaps.deo_shard_move(takes[k], parts[k][:3], up, down,
                                   None if k == 0 else takes[k - 1][-1])
        for g, a in zip(got, (*new, takes[k])):
            g.append(a)
    for g, w in zip(got, want[:4]):
        np.testing.assert_array_equal(torch.cat(g).numpy(), np.asarray(w))


# ---- draws and branches of a block -------------------------------------------

def test_block_draws_are_blocks_of_the_unsharded_draw():
    blk = Block(6, 40, 2, 4, 8, 28)
    for fn, dims, args in ((torch.rand, ("T", "C"), ()), (torch.randn, ("T", 3, "C"), ()),
                           (torch.randint, (5, "T", "C"), (0, 7))):
        g1, g2 = torch.Generator(), torch.Generator()
        g1.manual_seed(4)
        g2.manual_seed(4)
        full = fn(*args, blk.shape(dims), generator=g1)
        part = blk.draw(fn, g2, dims, "cpu", *args)
        idx = tuple(slice(2, 4) if d == "T" else slice(8, 28) if d == "C" else slice(None)
                    for d in dims)
        assert torch.equal(part, full[idx])
        assert torch.equal(g1.get_state(), g2.get_state())


BRANCH_WEIGHTS = dict(SCAMweight=10, AMweight=10, DEweight=10, MALAweight=10, HMCweight=10,
                      NUTSweight=10)


@pytest.mark.parametrize("de_pair", ["blocked", "rolled", "iid"])
def test_branches_on_a_block_equal_the_unsharded_run(de_pair):
    """Each branch on the block of rungs 1..3 and chains 20..52 (mid-way
    through a DE group of 8) equals its block of the whole batch's run."""
    t, c, d = 4, 64, 2
    cfg = SamplerConfig(ndim=d, ntemps=t, nchains=c, groups=((0, 1),), tskip=5,
                        jumps=build_default_jumps(burn=0, have_grads=True, **BRANCH_WEIGHTS),
                        burn=100, de_size=96, de_pair=de_pair, nuts_max_depth=4,
                        hmc_nmaxsteps=8, hmc_stepsize=0.08)
    model = CurvedLikelihood()
    rng = np.random.default_rng(5)
    x0 = rng.normal(-0.3, 0.5, size=(t, c, d))
    xs = torch.tensor(np.moveaxis(x0, 2, 1), dtype=torch.float32)
    state = init_state(cfg, 3, x0, np.eye(d) * 0.5, np.array([1.0, 0.7, 0.4, 0.2]),
                       model.lnlike(xs), model.lnprior(xs), device="cpu")
    state.de.buf.copy_(torch.tensor(rng.normal(size=(d, 96)), dtype=torch.float32))
    state = dataclasses.replace(state, de=dataclasses.replace(state.de, filled=96))
    blk = Block(t, c, 1, 3, 20, 52)
    tc = ("T", "C")
    ss = {f: getattr(state.stepsize, f) for f in SS_FIELDS}
    ss["epsilon"] = torch.full((t, c), 0.2)  # NUTS without its step-size search
    for j, branch in enumerate(build_jump_branches(cfg, model, "cpu")):
        g1, g2 = (torch.Generator() for _ in range(2))
        g1.manual_seed(9 + j)
        g2.manual_seed(9 + j)
        q, qxy, new = branch(g1, state.x, state.betas, 200, make_context(state), ss)
        qb, qxyb, newb = branch(g2, blk.take(state.x, ("T", d, "C")), blk.take(state.betas, ("T",)),
                                200, make_context(state, block=blk),
                                {f: blk.take(v, tc) for f, v in ss.items()})
        name = cfg.jumps[j].name
        assert torch.equal(qb, blk.take(q, ("T", d, "C"))), name
        assert torch.equal(qxyb, blk.take(qxy, tc)), name
        for f in ss:
            assert torch.equal(newb[f], blk.take(new[f], tc)), (name, f)
        assert torch.equal(g1.get_state(), g2.get_state()), name


def test_counters_of_a_block_are_the_unsharded_rows():
    key = torch.tensor([0x1234abcd, 0x0badf00d], dtype=torch.int64)
    t, c, depth = 6, 40, 5
    full = nuts_uniforms(key, depth, t, c)
    blk = Block(t, c, 2, 5, 12, 30)
    part = nuts_uniforms(key, depth, 3, 18, blk.n0, c)
    assert torch.equal(part, full[:, 2:5, 12:30])
    for d in (2, 7):
        p0, ns = hmc_draws(key, t, d, c, 2, 50)
        bp0, bns = hmc_draws(key, 3, d, 18, 2, 50, blk.n0, c)
        assert torch.equal(bp0, p0[2:5, :, 12:30]) and torch.equal(bns, ns[2:5, 12:30])


# ---- placement ---------------------------------------------------------------

@pytest.mark.parametrize("chain_axis", [None, "chain"])
def test_state_sharding_matches_jax(chain_axis):
    from ptmcmcsampler_tpu import config as j_config, state as j_state
    from ptmcmcsampler_tpu.parallel import make_pt_mesh, state_sharding as j_sharding

    t, c, d = 4, 8, 3
    kw = dict(ndim=d, ntemps=t, nchains=c, groups=((0, 1), (2,)), de_size=16,
              jumps=None)
    jumps = build_default_jumps(burn=5, have_grads=True, NUTSweight=1, CHEESweight=1)
    tcfg = SamplerConfig(**{**kw, "jumps": jumps})
    jcfg = j_config.SamplerConfig(**{**kw, "jumps": j_config.build_default_jumps(
        burn=5, have_grads=True, NUTSweight=1, CHEESweight=1)})
    zeros = np.zeros((t, c))
    betas = np.linspace(1.0, 0.3, t)
    tstate = init_state(tcfg, 0, np.zeros(d), np.eye(d), betas, zeros, zeros, device="cpu")
    jstate = j_state.init_state(jcfg, jax.random.key(0), np.zeros(d), np.eye(d), betas, zeros,
                                zeros)
    spec = j_sharding(jstate, make_pt_mesh(2, 4), axis="temp", chain_axis=chain_axis)
    got = t_mesh.state_sharding(tstate, t_mesh.PTMesh(2, 4), axis="temp", chain_axis=chain_axis)
    checked = 0
    for path, mine in got.items():
        if path == "de/start":  # the port's own (a device index of de/filled)
            continue
        node = spec
        for part in path.split("/"):
            node = node[int(part)] if part.isdigit() else getattr(node, part)
        assert mine == tuple(node.spec), path
        checked += 1
    assert checked == len(got) - 1


def test_host_local_block_gives_the_global_indices():
    blk = t_mesh.PTMesh(2, 2, rank=3).block(4, 10)
    arr = torch.arange(2 * 3 * 5, dtype=torch.float32).view(2, 3, 5)
    block, index = t_mesh.host_local_block(arr, blk, ("T", 3, "C"))
    assert np.array_equal(block, arr.numpy())
    assert [i.tolist() for i in index] == [[2, 3], [0, 1, 2], [5, 6, 7, 8, 9]]
    cfg = SamplerConfig(ndim=2, ntemps=2, nchains=4, groups=((0, 1),),
                        jumps=build_default_jumps(burn=5))
    state = init_state(cfg, 0, np.zeros(2), np.eye(2), np.array([1.0, 0.5]), np.zeros((2, 4)),
                       np.zeros((2, 4)), device="cpu")
    assert distributed.process_local_block(state)[0] is state.x
