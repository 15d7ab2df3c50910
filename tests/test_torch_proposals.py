"""PyTorch port vs the JAX package: SCAM, AM and blocked DE with the JAX
kernels' own draws, and the sweep swap with the same uniforms.

Each JAX proposal draws from its keys; the test replays those key splits
(am.py:28, :64, de.py:111-124) to extract the draws and feeds them to the
port's deterministic cores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptmcmcsampler_torch import config as t_config
from ptmcmcsampler_torch import swaps as t_swaps
from ptmcmcsampler_torch.proposals import am as t_am
from ptmcmcsampler_torch.proposals import de as t_de
from ptmcmcsampler_torch.proposals.base import ProposalContext as TCtx
from ptmcmcsampler_tpu import config as j_config
from ptmcmcsampler_tpu import swaps as j_swaps
from ptmcmcsampler_tpu.proposals import am as j_am
from ptmcmcsampler_tpu.proposals import de as j_de
from ptmcmcsampler_tpu.proposals.base import ProposalContext as JCtx
from ptmcmcsampler_tpu.utils import split_grid

torch.set_num_threads(2)

T, C, D = 3, 20, 2
RTOL = ATOL = 1e-6


GROUPS = {"one": ((0, 1),), "two": ((0, 1), (1,))}


def _configs(de_block=8, groups=GROUPS["one"]):
    kw = dict(ndim=D, ntemps=T, nchains=C, groups=groups, de_block=de_block)
    return (j_config.SamplerConfig(jumps=j_config.build_default_jumps(), **kw),
            t_config.SamplerConfig(jumps=t_config.build_default_jumps(), **kw))


def _inputs(seed, de_valid=37, de_rows=64, groups=GROUPS["one"]):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, D, C)).astype(np.float32)
    betas = np.array([1.0, 0.3, 0.0], np.float32)  # includes the beta=0 hot chain
    a = rng.normal(size=(D, D))
    cov = a @ a.T + 0.5 * np.eye(D)
    factors = [np.linalg.eigh(cov[np.ix_(g, g)]) for g in groups]
    buf = rng.normal(size=(D, de_rows)).astype(np.float32)
    jctx = JCtx(group_u=tuple(jnp.asarray(u, jnp.float32) for _, u in factors),
                group_s=tuple(jnp.asarray(s, jnp.float32) for s, _ in factors),
                chol=None, chol_inv=None, de_buf=jnp.asarray(buf),
                de_valid=jnp.asarray(de_valid, jnp.int32))
    tctx = TCtx(group_u=tuple(torch.tensor(u, dtype=torch.float32) for _, u in factors),
                group_s=tuple(torch.tensor(s, dtype=torch.float32) for s, _ in factors),
                chol=None, chol_inv=None, de_buf=torch.tensor(buf), de_valid=de_valid)
    keys = split_grid(jax.random.key(seed), (T, C))
    return x, betas, jctx, tctx, keys


def _jax_batch(kernel, keys, x, betas, jctx):
    per_chain = jax.vmap(lambda k, xx, b: kernel(k, xx, b, 0, jctx),
                         in_axes=(0, -1, None), out_axes=(-1, 0))
    q, _ = jax.vmap(per_chain, in_axes=(0, 0, 0))(keys, jnp.asarray(x), jnp.asarray(betas))
    return np.asarray(q)


def _per_key(fn, keys):
    return np.asarray(jax.vmap(jax.vmap(fn))(keys))


def _group_draw(kg, groups):
    """random_group (base.py:90-94): 0 for one group, else randint."""
    if len(groups) == 1:
        return jnp.zeros((), jnp.int32)
    return jax.random.randint(kg, (), 0, len(groups))


def _by_group(keys, groups, draw):
    """Per chain, ``draw(key, sg)`` for the size of the chain's chosen group
    (the JAX kernels draw inside the chosen group's branch)."""
    def one(k, kg):
        gidx = _group_draw(kg, groups)
        vals = [draw(k, len(g)) for g in groups]
        return jax.lax.select_n(gidx, *vals) if len(groups) > 1 else vals[0]

    return one


@pytest.mark.parametrize("seed,groups", [(0, "one"), (1, "one"), (2, "one"), (3, "two")])
def test_scam_matches_jax_draws(seed, groups):
    groups = GROUPS[groups]
    jc, tc = _configs(groups=groups)
    x, betas, jctx, tctx, keys = _inputs(seed, groups=groups)
    want = _jax_batch(j_am.make_scam(jc), keys, x, betas, jctx)

    def split(k):  # am.py:28: kg, ks, ki, kn
        return jax.random.split(k, 4)

    gidx = _per_key(lambda k: _group_draw(split(k)[0], groups), keys)
    prob = _per_key(lambda k: jax.random.uniform(split(k)[1]), keys)
    ind = _per_key(lambda k: _by_group(k, groups, lambda kk, sg: jax.random.randint(
        split(kk)[2], (), 0, sg))(k, split(k)[0]), keys)
    z = _per_key(lambda k: jax.random.normal(split(k)[3], dtype=jnp.float32), keys)
    got = t_am.make_scam(tc, "cpu").core(
        torch.tensor(x), torch.tensor(betas), tctx, torch.tensor(gidx).long(),
        torch.tensor(prob), torch.tensor(ind).long(), torch.tensor(z),
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed,groups", [(0, "one"), (1, "one"), (2, "one"), (3, "two")])
def test_am_matches_jax_draws(seed, groups):
    groups = GROUPS[groups]
    jc, tc = _configs(groups=groups)
    x, betas, jctx, tctx, keys = _inputs(seed, groups=groups)
    want = _jax_batch(j_am.make_am(jc), keys, x, betas, jctx)

    def split(k):  # am.py:64: kg, ks, kn
        return jax.random.split(k, 3)

    def z_of(k, sg):  # normal(kn, (sg,)), padded to D
        z = jax.random.normal(split(k)[2], (sg,), dtype=jnp.float32)
        return jnp.concatenate([z, jnp.zeros((D - sg,), jnp.float32)])

    gidx = _per_key(lambda k: _group_draw(split(k)[0], groups), keys)
    prob = _per_key(lambda k: jax.random.uniform(split(k)[1]), keys)
    z = _per_key(lambda k: _by_group(k, groups, z_of)(k, split(k)[0]), keys)
    got = t_am.make_am(tc, "cpu").core(
        torch.tensor(x), torch.tensor(betas), tctx, torch.tensor(gidx).long(),
        torch.tensor(prob), torch.tensor(np.moveaxis(z, -1, 1)),
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "seed,de_block,de_valid,groups",
    [(0, 8, 37, "one"), (1, 3, 64, "one"), (2, 8, 2, "one"), (3, 8, 50, "two")],
)
def test_de_blocked_matches_jax_draws(seed, de_block, de_valid, groups):
    groups = GROUPS[groups]
    jc, tc = _configs(de_block, groups)
    x, betas, jctx, tctx, keys = _inputs(seed, de_valid=de_valid, groups=groups)
    want, _, _ = j_de.make_de_blocked(jc)(keys, jnp.asarray(x), jnp.asarray(betas), 0, jctx, {})

    # de.py:109-124: pair draws from a fold_in of the (0, 0) key
    ng = -(-C // de_block)
    nvalid = max(de_valid, 2)
    kmm, knn = jax.random.split(jax.random.fold_in(keys[0, 0], 7919))
    mm = np.asarray(jax.random.randint(kmm, (T, ng), 0, nvalid))
    nn = np.asarray(jax.random.randint(knn, (T, ng), 0, nvalid - 1))
    def split(k):  # de.py:123: kg, kp, ku
        return jax.random.split(k, 3)

    gidx = _per_key(lambda k: _group_draw(split(k)[0], groups), keys)
    prob = _per_key(lambda k: jax.random.uniform(split(k)[1]), keys)
    uu = _per_key(lambda k: jax.random.uniform(split(k)[2], dtype=jnp.float32), keys)
    got = t_de.make_de_blocked(tc, "cpu").core(
        torch.tensor(x), torch.tensor(betas), tctx, torch.tensor(mm).long(),
        torch.tensor(nn).long(), torch.tensor(gidx).long(),
        torch.tensor(prob), torch.tensor(uu),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _swap_state(seed, t=6, c=33, d=3):
    """As tests/test_swaps_impl.py: random rows with -inf likelihoods."""
    rng = np.random.default_rng(seed)
    lnlike = rng.normal(size=(t, c)).astype(np.float32)
    lnlike[-1] = -np.inf
    lnlike[min(2, t - 1), :5] = -np.inf
    lnprior = rng.normal(size=(t, c)).astype(np.float32)
    x = rng.normal(size=(t, d, c)).astype(np.float32)
    betas = np.sort(rng.uniform(0.01, 1.0, size=t).astype(np.float32))[::-1].copy()
    return x, lnlike, lnprior, betas


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sweep_swap_apply_bitwise(seed):
    x, lnlike, lnprior, betas = _swap_state(seed)
    key = jax.random.key(seed + 100)
    jx, jll, jlp, jacc, jprop = j_swaps.sweep_swap_apply(
        key, *(jnp.asarray(a) for a in (x, lnlike, lnprior, betas))
    )
    t, c = lnlike.shape
    us = np.asarray(jax.random.uniform(key, (t - 1, c)))  # swaps.py:54
    tx, tll, tlp, tacc, tprop = t_swaps.sweep_swap_apply(
        torch.tensor(us), *(torch.tensor(a) for a in (x, lnlike, lnprior, betas))
    )
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(tprop.numpy(), np.asarray(jprop))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tll.numpy(), np.asarray(jll))
    np.testing.assert_array_equal(tlp.numpy(), np.asarray(jlp))


def test_sweep_single_temperature_noop():
    x, lnlike, lnprior, betas = _swap_state(3, t=1, c=9, d=2)
    us = t_swaps.draw_swap_uniforms(torch.Generator(), 1, 9, "cpu")
    tx, _, _, tacc, tprop = t_swaps.sweep_swap_apply(
        us, *(torch.tensor(a) for a in (x, lnlike, lnprior, betas))
    )
    np.testing.assert_array_equal(tx.numpy(), x)
    assert not tacc.any() and not tprop.any()
