"""PyTorch port vs the JAX package: numeric core, ladder, DE ring, group
embedding, MH log-ratio and config checks (all exact)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptmcmcsampler_torch import adaptation as t_adapt
from ptmcmcsampler_torch import config as t_config
from ptmcmcsampler_torch import kernel as t_kernel
from ptmcmcsampler_torch import ladder as t_ladder
from ptmcmcsampler_torch import utils as t_utils
from ptmcmcsampler_torch.proposals.base import GroupEmbed as TGroupEmbed
from ptmcmcsampler_torch.state import DEState as TDEState
from ptmcmcsampler_tpu import adaptation as j_adapt
from ptmcmcsampler_tpu import config as j_config
from ptmcmcsampler_tpu import kernel as j_kernel
from ptmcmcsampler_tpu import ladder as j_ladder
from ptmcmcsampler_tpu import utils as j_utils
from ptmcmcsampler_tpu.proposals.base import GroupEmbed as JGroupEmbed
from ptmcmcsampler_tpu.state import DEState as JDEState

torch.set_num_threads(2)

NEG = -np.inf


def _edge_values(seed, shape):
    rng = np.random.default_rng(seed)
    a = rng.normal(scale=5.0, size=shape).astype(np.float32)
    flat = a.reshape(-1)
    flat[::5] = NEG
    flat[1::7] = 0.0
    return a


@pytest.mark.parametrize("seed", [0, 1])
def test_tempered_lnprob_exact(seed):
    ll = _edge_values(seed, (5, 13))
    lp = _edge_values(seed + 10, (5, 13))
    betas = np.array([1.0, 0.5, 1e-3, 0.0, 0.25], np.float32)[:, None]
    want = np.asarray(j_utils.tempered_lnprob(jnp.asarray(ll), jnp.asarray(lp), jnp.asarray(betas)))
    got = t_utils.tempered_lnprob(torch.tensor(ll), torch.tensor(lp), torch.tensor(betas)).numpy()
    np.testing.assert_array_equal(got, want)
    # beta = 0 with a -inf likelihood stays -inf, never NaN
    assert not np.isnan(got).any()


def test_accept_logratio_exact():
    rng = np.random.default_rng(3)
    shape = (4, 40)
    new_ll, new_lp = _edge_values(1, shape), _edge_values(2, shape)
    old_ll, old_lp = _edge_values(3, shape), _edge_values(4, shape)
    qxy = rng.normal(size=shape).astype(np.float32)
    qxy[0, :6] = [np.nan, NEG, np.inf, np.nan, NEG, 0.0]
    betas = np.array([1.0, 0.3, 0.0, 0.01], np.float32)[:, None]
    want = j_kernel._accept_logratio(*(jnp.asarray(a) for a in (new_ll, new_lp, old_ll, old_lp, qxy, betas)))
    got = t_kernel._accept_logratio(*(torch.tensor(a) for a in (new_ll, new_lp, old_ll, old_lp, qxy, betas)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize(
    "ndim,ntemps,kw",
    [(2, 8, {}), (20, 4, {}), (5, 1, {}), (3, 6, {"tmax": 50.0}), (4, 5, {"tstep": 1.7})],
)
def test_ladder_exact(ndim, ntemps, kw):
    want = j_ladder.temperature_ladder(ndim, ntemps, **kw)
    got = t_ladder.temperature_ladder(ndim, ntemps, **kw)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    for hot in (False, True):
        jl, jb = j_ladder.ladder_betas(want, hot_chain=hot)
        tl, tb = t_ladder.ladder_betas(got, hot_chain=hot)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tb, jb)


def test_de_buffer_push_ring_wrap_exact():
    d, rows, m = 3, 10, 4
    rng = np.random.default_rng(5)
    jde = JDEState(buf=jnp.zeros((d, rows), jnp.float32), filled=jnp.zeros((), jnp.int32))
    tde = TDEState(buf=torch.zeros(d, rows), filled=0)
    for _ in range(7):  # 28 columns through a 10-column ring: wraps twice
        xs = rng.normal(size=(d, m)).astype(np.float32)
        jde = j_adapt.de_buffer_push(jde, jnp.asarray(xs))
        tde = t_adapt.de_buffer_push(tde, torch.tensor(xs))
        np.testing.assert_array_equal(tde.buf.numpy(), np.asarray(jde.buf))
        # The port keeps its count below 2 * rows (state.de_fill_count): the
        # same ring start and valid count as the JAX package's running count.
        assert tde.filled % rows == int(jde.filled) % rows and tde.filled < 2 * rows
        assert t_adapt.de_valid_rows(tde) == int(j_adapt.de_valid_rows(jde))


def test_de_buffer_push_full_width():
    """A push as wide as the ring (C == de_rows) overwrites every column."""
    rng = np.random.default_rng(6)
    jde = JDEState(buf=jnp.zeros((2, 6), jnp.float32), filled=jnp.asarray(4, jnp.int32))
    tde = TDEState(buf=torch.zeros(2, 6), filled=4)
    xs = rng.normal(size=(2, 6)).astype(np.float32)
    jde = j_adapt.de_buffer_push(jde, jnp.asarray(xs))
    tde = t_adapt.de_buffer_push(tde, torch.tensor(xs))
    np.testing.assert_array_equal(tde.buf.numpy(), np.asarray(jde.buf))


@pytest.mark.parametrize("g", [(0, 1, 2, 3), (1, 3), (2,)])
def test_group_embed_exact(g):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 4, 5)).astype(np.float32)  # [T, D, C]
    step = rng.normal(size=(3, len(g), 5)).astype(np.float32)
    je = JGroupEmbed(g, 4, jnp.float32)
    te = TGroupEmbed(g, 4, "cpu")
    vj = jax.vmap(jax.vmap(lambda f, a, b: f(a, b), in_axes=(None, -1, -1), out_axes=-1),
                  in_axes=(None, 0, 0))
    take_j = jax.vmap(jax.vmap(je.take, in_axes=-1, out_axes=-1))(jnp.asarray(x))
    np.testing.assert_array_equal(te.take(torch.tensor(x)).numpy(), np.asarray(take_j))
    add_j = vj(je.add_at, jnp.asarray(x), jnp.asarray(step))
    np.testing.assert_array_equal(
        te.add_at(torch.tensor(x), torch.tensor(step)).numpy(), np.asarray(add_j)
    )
    set_j = vj(je.set_at, jnp.asarray(x), jnp.asarray(step))
    np.testing.assert_array_equal(
        te.set_at(torch.tensor(x), torch.tensor(step)).numpy(), np.asarray(set_j)
    )


def test_cholesky_psd_matches():
    rng = np.random.default_rng(8)
    a = rng.normal(size=(4, 4))
    mats = [a @ a.T, np.diag([1.0, 0.0, 2.0, 3.0]), np.zeros((4, 4))]
    for m in mats:
        want = np.asarray(j_utils.cholesky_psd(jnp.asarray(m, jnp.float32)))
        got = t_utils.cholesky_psd(torch.tensor(m, dtype=torch.float32)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_default_jumps_and_weights_match():
    kw = dict(SCAMweight=10, AMweight=10, DEweight=10, CHEESweight=20, burn=1500, have_grads=True)
    jj = j_config.build_default_jumps(**kw)
    tj = t_config.build_default_jumps(**kw)
    assert [(s.name, s.kind, s.weight, s.activate_after) for s in tj] == [
        (s.name, s.kind, s.weight, s.activate_after) for s in jj
    ]
    jc = j_config.SamplerConfig(ndim=2, ntemps=2, nchains=4, groups=((0, 1),), jumps=jj)
    tc = t_config.SamplerConfig(ndim=2, ntemps=2, nchains=4, groups=((0, 1),), jumps=tj)
    for a, b in zip(tc.weights_and_activation(), jc.weights_and_activation()):
        np.testing.assert_array_equal(a, b)


def _host_jump(x, it, beta):
    return x, 0.0


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(jump_select="per_chain", extra=(t_config.JumpSpec(
            "numpy", t_config.KIND_CUSTOM, 5, fn=_host_jump, protocol="host"),)), "host"),
        (dict(jump_select="per_chain", nuts_trajectory=True), "jump_select='shared'"),
        (dict(nuts_max_depth=31), "int32"),
        (dict(nuts_max_depth=0), "outside"),
        (dict(per_chain_mode="sorted"), "per_chain_mode"),
    ],
)
def test_config_refuses_what_jax_refuses(kw, match):
    """The port refuses, with ValueError, what the JAX package's config
    refuses (a host jump or the trajectory capture under per_chain
    selection, an unknown per_chain_mode), and a NUTS depth past 30, where
    the JAX package's int32 leaf count overflows; the JAX config takes
    depth 30 and refuses the same per_chain settings."""
    base = dict(ndim=2, ntemps=2, nchains=4, groups=((0, 1),),
                jumps=t_config.build_default_jumps(have_grads=True, CHEESweight=20))
    base["jumps"] += kw.pop("extra", ())
    base.update(kw)
    with pytest.raises(ValueError, match=match):
        t_config.SamplerConfig(**base)
    if "nuts_max_depth" not in kw:
        jkw = dict(base, jumps=tuple(
            j_config.JumpSpec(s.name, s.kind, s.weight, s.activate_after,
                              **({"fn": s.fn, "protocol": "legacy"} if s.fn else {}))
            for s in base["jumps"]))
        with pytest.raises(ValueError):
            j_config.SamplerConfig(**jkw)


def test_config_takes_the_settings_the_jax_package_takes():
    """per_chain selection (both modes), NUTS depth 11-30, a forced length
    and the capture: no refusal in either package."""
    base = dict(ndim=2, ntemps=2, nchains=4, groups=((0, 1),),
                jumps=t_config.build_default_jumps(have_grads=True, NUTSweight=20))
    for kw in (dict(jump_select="per_chain", per_chain_mode="rotation"),
               dict(jump_select="per_chain", per_chain_mode="stacked"),
               dict(nuts_max_depth=11), dict(nuts_max_depth=30), dict(nuts_force_trajlen=5),
               dict(nuts_trajectory=True)):
        cfg = t_config.SamplerConfig(**dict(base, **kw))
        j_config.SamplerConfig(**dict(base, **kw))
        assert cfg.per_chain_rotation == (kw.get("per_chain_mode") == "rotation")


def test_config_builds_the_gradient_cycle():
    jumps = t_config.build_default_jumps(SCAMweight=10, AMweight=10, DEweight=10, NUTSweight=10,
                                         HMCweight=10, MALAweight=10, have_grads=True)
    cfg = t_config.SamplerConfig(ndim=2, ntemps=2, nchains=4, groups=((0, 1),), jumps=jumps,
                                 nuts_max_depth=10)
    assert [j.kind for j in cfg.jumps] == ["mala", "hmc", "nuts", "scam", "am", "de"]
    assert (cfg.hmc_nminsteps, cfg.hmc_nmaxsteps, cfg.nuts_delta) == (2, 300, 0.6)


@pytest.mark.parametrize("kw", [dict(swap_mode="bogus"), dict(de_pair="bogus"),
                                dict(jump_select="bogus"), dict(adapt_from="bogus")])
def test_config_rejects_unknown_settings(kw):
    base = dict(ndim=2, ntemps=2, nchains=4, groups=((0, 1),),
                jumps=t_config.build_default_jumps(have_grads=True, CHEESweight=20))
    base.update(kw)
    with pytest.raises(ValueError, match="unknown"):
        t_config.SamplerConfig(**base)
