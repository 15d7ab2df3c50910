"""The port's "rolled" and "iid" DE pair laws against the JAX package.

* The deterministic cores fed the JAX kernels' own draws (their key splits
  replayed: ``proposals/de.py`` ``make_de`` and ``make_de_batch``): a full
  ring, a part-full one, more chains than ring rows, and rings of two and
  three rows, where many chains' rows collide (identity moves).
* ``tests/test_de_modes.py`` mirrored through the port's branches: each
  chain's marginal pair law is uniform over ordered distinct pairs, only
  valid rows are drawn, and full sampling runs under the three laws agree
  within Monte Carlo error.

Tolerances: the cores within 1e-6, the tolerance of the blocked core's
test (``tests/test_torch_proposals.py``); the statistical checks as the
JAX tests state them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptmcmcsampler_torch import config as t_config
from ptmcmcsampler_torch import init_state
from ptmcmcsampler_torch.kernel import build_step
from ptmcmcsampler_torch.ladder import ladder_betas, temperature_ladder
from ptmcmcsampler_torch.proposals import de as t_de
from ptmcmcsampler_torch.proposals.base import ProposalContext as TCtx
from ptmcmcsampler_tpu import config as j_config
from ptmcmcsampler_tpu.proposals import de as j_de
from ptmcmcsampler_tpu.proposals.base import ProposalContext as JCtx
from ptmcmcsampler_tpu.utils import split_grid

torch.set_num_threads(2)

T, D = 3, 2
RTOL = ATOL = 1e-6
GROUPS = {"one": ((0, 1),), "two": ((0, 1), (1,))}


def _configs(c, groups, de_pair):
    kw = dict(ndim=D, ntemps=T, nchains=c, groups=groups, de_pair=de_pair)
    return (j_config.SamplerConfig(jumps=j_config.build_default_jumps(), **kw),
            t_config.SamplerConfig(jumps=t_config.build_default_jumps(), **kw))


def _inputs(seed, c, de_valid, de_rows, groups):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, D, c)).astype(np.float32)
    betas = np.array([1.0, 0.3, 0.0], np.float32)  # with the beta = 0 hot chain
    buf = rng.normal(size=(D, de_rows)).astype(np.float32)
    eye = [np.eye(len(g), dtype=np.float32) for g in groups]
    ones = [np.ones(len(g), np.float32) for g in groups]
    jctx = JCtx(group_u=tuple(map(jnp.asarray, eye)), group_s=tuple(map(jnp.asarray, ones)),
                chol=None, chol_inv=None, de_buf=jnp.asarray(buf),
                de_valid=jnp.asarray(de_valid, jnp.int32))
    tctx = TCtx(group_u=tuple(map(torch.tensor, eye)), group_s=tuple(map(torch.tensor, ones)),
                chol=None, chol_inv=None, de_buf=torch.tensor(buf), de_valid=de_valid)
    return x, betas, jctx, tctx, split_grid(jax.random.key(seed), (T, c))


def _per_key(fn, keys):
    return np.asarray(jax.vmap(jax.vmap(fn))(keys))


def _group_draw(kg, groups):
    """``random_group`` (JAX ``proposals/base.py:90-94``)."""
    if len(groups) == 1:
        return jnp.zeros((), jnp.int32)
    return jax.random.randint(kg, (), 0, len(groups))


def _long(a):
    return torch.tensor(np.asarray(a)).long()


# (seed, chains, valid rows, ring rows, groups): a full ring, a part-full
# one, more chains than ring rows, and rings of 2 and 3 rows. On the
# 2-row ring the shifts of seed 7 make every chain's two rows collide,
# those of seed 3 none.
CASES = [(0, 20, 64, 64, "one"), (1, 20, 37, 64, "one"), (2, 40, 16, 16, "one"),
         (3, 20, 2, 2, "one"), (7, 20, 2, 2, "one"), (4, 25, 3, 64, "two"),
         (5, 33, 7, 7, "two")]


@pytest.mark.parametrize("seed,c,de_valid,de_rows,groups", CASES)
def test_rolled_core_matches_jax_draws(seed, c, de_valid, de_rows, groups):
    groups = GROUPS[groups]
    jc, tc = _configs(c, groups, "rolled")
    x, betas, jctx, tctx, keys = _inputs(seed, c, de_valid, de_rows, groups)
    want, _, _ = j_de.make_de_batch(jc)(keys, jnp.asarray(x), jnp.asarray(betas), 0, jctx, {})

    # make_de_batch: the shifts from a fold_in of the (0, 0) key, then kg,
    # kp, ku per chain; the scale uniform drawn inside the group's branch.
    nvalid = max(de_valid, 2)
    k1, k2 = jax.random.split(jax.random.fold_in(keys[0, 0], 7919))
    s1 = int(jax.random.randint(k1, (), 0, nvalid))
    s2 = int(jax.random.randint(k2, (), 0, nvalid))

    def split(k):
        return jax.random.split(k, 3)

    gidx = _per_key(lambda k: _group_draw(split(k)[0], groups), keys)
    prob = _per_key(lambda k: jax.random.uniform(split(k)[1]), keys)
    uu = _per_key(lambda k: jax.random.uniform(split(k)[2], dtype=jnp.float32), keys)
    got = t_de.make_de_rolled(tc, "cpu").core(
        torch.tensor(x), torch.tensor(betas), tctx, torch.tensor(s1), torch.tensor(s2),
        _long(gidx), torch.tensor(prob), torch.tensor(uu))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    collide = (2 * np.arange(c) + s1 - s2) % nvalid == 0
    if de_valid == 2:
        assert collide.all() if seed == 7 else not collide.any()
    # A chain whose two rows collide stays where it was.
    np.testing.assert_array_equal(got.numpy()[:, :, collide], x[:, :, collide])


@pytest.mark.parametrize("seed,c,de_valid,de_rows,groups", CASES)
def test_iid_core_matches_jax_draws(seed, c, de_valid, de_rows, groups):
    groups = GROUPS[groups]
    jc, tc = _configs(c, groups, "iid")
    x, betas, jctx, tctx, keys = _inputs(seed, c, de_valid, de_rows, groups)
    kernel = j_de.make_de(jc)
    per_chain = jax.vmap(lambda k, xx, b: kernel(k, xx, b, 0, jctx),
                         in_axes=(0, -1, None), out_axes=(-1, 0))
    want, _ = jax.vmap(per_chain)(keys, jnp.asarray(x), jnp.asarray(betas))

    # make_de: kg, km, kn, kp, ku per chain.
    nvalid = max(de_valid, 2)

    def split(k):
        return jax.random.split(k, 5)

    gidx = _per_key(lambda k: _group_draw(split(k)[0], groups), keys)
    mm = _per_key(lambda k: jax.random.randint(split(k)[1], (), 0, nvalid), keys)
    nn = _per_key(lambda k: jax.random.randint(split(k)[2], (), 0, nvalid - 1), keys)
    prob = _per_key(lambda k: jax.random.uniform(split(k)[3]), keys)
    uu = _per_key(lambda k: jax.random.uniform(split(k)[4], dtype=jnp.float32), keys)
    branch = t_de.make_de(tc, "cpu")
    got = branch.core(torch.tensor(x), torch.tensor(betas), tctx, _long(mm), _long(nn),
                      _long(gidx), torch.tensor(prob), torch.tensor(uu))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_make_de_dispatches_on_the_pair_law():
    for law, name in (("blocked", "de_blocked"), ("iid", "de_blocked"), ("rolled", "de_rolled")):
        cfg = t_config.SamplerConfig(ndim=D, ntemps=T, nchains=4, groups=GROUPS["one"],
                                     jumps=t_config.build_default_jumps(), de_pair=law)
        assert t_de.make_de(cfg, "cpu").__name__ == name


# ---- tests/test_de_modes.py, through the port's branches ----

VALS = np.array([0.0, 1.0, 3.0, 9.0], np.float32)  # distinct ordered differences


def _law_deltas(de_pair, nchains, n, de_block=8, vals=VALS, nvalid=None, seed=3):
    """``n`` draws of the DE branch on ``x = 0`` at one temperature, beta 1:
    ``[n, nchains]`` moves (a mode jump's move is its pair's difference)."""
    cfg = t_config.SamplerConfig(ndim=1, ntemps=1, nchains=nchains, groups=((0,),),
                                 jumps=(t_config.JumpSpec("de", t_config.KIND_DE, 1),),
                                 de_pair=de_pair, de_block=de_block)
    branch = t_de.make_de(cfg, "cpu")
    ctx = TCtx(group_u=(torch.eye(1),), group_s=(torch.ones(1),), chol=None, chol_inv=None,
               de_buf=torch.tensor(vals[None, :]),
               de_valid=len(vals) if nvalid is None else nvalid)
    x = torch.zeros((1, 1, nchains))
    betas = torch.ones(1)
    rng = torch.Generator().manual_seed(seed)
    return np.stack([branch(rng, x, betas, 0, ctx, {})[0][0, 0].numpy() for _ in range(n)])


def _assert_uniform_pairs(deltas, n):
    diffs = {(a, b): VALS[a] - VALS[b] for a in range(4) for b in range(4) if a != b}
    for chain in range(deltas.shape[1]):
        d = deltas[:, chain]
        counts = {p: int(np.sum(np.isclose(d, v, atol=1e-6))) for p, v in diffs.items()}
        total = sum(counts.values())
        assert total > n * 0.35, total  # about half are mode jumps (scale 1)
        for p, cnt in counts.items():
            assert abs(cnt / total - 1 / 12) < 0.02, (chain, p, cnt / total)


@pytest.mark.parametrize("de_pair", ["rolled", "iid"])
def test_marginal_pair_law_per_chain(de_pair):
    n = 20000
    _assert_uniform_pairs(_law_deltas(de_pair, 5, n), n)


def test_blocked_marginal_pair_law_and_sharing():
    """As the JAX test: groups of 2 chains share their pair, each chain's
    marginal law is still uniform."""
    n = 20000
    deltas = _law_deltas("blocked", 6, n, de_block=2, seed=9)
    _assert_uniform_pairs(deltas, n)
    assert np.mean(deltas[:, 0] == deltas[:, 1]) > 0.2
    assert np.mean(deltas[:, 0] == deltas[:, 2]) < 0.1


@pytest.mark.parametrize("de_pair", ["rolled", "iid"])
def test_partial_ring_uses_valid_rows_only(de_pair):
    vals = np.array([0.0, 1.0, 3.0, 100.0, 200.0, 300.0], np.float32)
    deltas = _law_deltas(de_pair, 3, 4000, vals=vals, nvalid=3, seed=5)
    # Valid differences are at most 3, scaled by at most 2.4/sqrt(2); a row
    # past the valid ones would show as |delta| ~ 100.
    assert np.max(np.abs(deltas)) <= 3.0 * 2.4 / np.sqrt(2.0) + 1e-4


def test_rolled_vs_iid_statistically_equivalent():
    """Full sampling runs of a SCAM + DE cycle on a correlated Gaussian, as
    the JAX test: the three laws agree on acceptance and moments within
    Monte Carlo error."""

    class Gauss:
        def lnlike(self, x):
            return -0.5 * (x[..., 0, :] ** 2 + (x[..., 1, :] - x[..., 0, :]) ** 2
                           + x[..., 1, :] ** 2)

        def lnprior(self, x):
            return torch.where((x.abs() < 20.0).all(-2), 0.0, float("-inf"))

    model = Gauss()
    results = {}
    for mode in ("blocked", "rolled", "iid"):
        cfg = t_config.SamplerConfig(
            ndim=2, ntemps=2, nchains=48, groups=((0, 1),),
            jumps=(t_config.JumpSpec("scam", t_config.KIND_SCAM, 1),
                   t_config.JumpSpec("de", t_config.KIND_DE, 3, activate_after=100)),
            tskip=10, cov_update=200, burn=100, thin=2, de_size=64, de_pair=mode)
        _, run_block = build_step(cfg, model, device="cpu")
        _, betas = ladder_betas(temperature_ladder(2, 2))
        xs = torch.zeros((2, 2, 48))
        state = init_state(cfg, 11, np.zeros(2), np.eye(2), betas, model.lnlike(xs),
                           model.lnprior(xs), device="cpu")
        state, _ = run_block(state, 400)  # burn-in and DE's activation
        acc0, it0 = state.counters.naccepted.clone(), state.it
        state, out = run_block(state, 2500)
        acc = (state.counters.naccepted - acc0).double().mean().item() / (state.it - it0)
        cold = out.x[:, 0].movedim(-1, -2).reshape(-1, 2).numpy()
        results[mode] = (acc, cold.mean(axis=0), cold.std(axis=0))

    acc_i, mean_i, std_i = results["iid"]
    for mode in ("blocked", "rolled"):
        acc_r, mean_r, std_r = results[mode]
        assert abs(acc_r - acc_i) < 0.05, (mode, acc_r, acc_i)
        np.testing.assert_allclose(std_r, std_i, rtol=0.12, err_msg=mode)
        np.testing.assert_allclose(mean_r, mean_i, atol=0.15, err_msg=mode)
