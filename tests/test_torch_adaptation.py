"""PyTorch port vs the JAX package: Welford merge, factor refresh, and
carrying a JAX sampler state into the port and back."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptmcmcsampler_torch import adaptation as t_adapt
from ptmcmcsampler_torch import config as t_config
from ptmcmcsampler_torch import kernel as t_kernel
from ptmcmcsampler_torch import state as t_state
from ptmcmcsampler_tpu import adaptation as j_adapt
from ptmcmcsampler_tpu import config as j_config
from ptmcmcsampler_tpu import state as j_state
from ptmcmcsampler_tpu.io.checkpoint import _path_name
from ptmcmcsampler_tpu.kernel import build_step as j_build_step
from ptmcmcsampler_tpu.models import CurvedLikelihood as JCurved

torch.set_num_threads(2)


def _adapt_pair(d, groups, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(d, d))
    cov0 = a @ a.T + d * np.eye(d)
    jc = j_config.SamplerConfig(ndim=d, ntemps=1, nchains=4, groups=groups,
                                jumps=j_config.build_default_jumps())
    tc = t_config.SamplerConfig(ndim=d, ntemps=1, nchains=4, groups=groups,
                                jumps=t_config.build_default_jumps())
    return jc, tc, j_state.init_adapt_state(jc, cov0), t_state.init_adapt_state(tc, cov0, "cpu")


def _assert_adapt_close(ta, ja, rtol=1e-5):
    for f in ("mean", "m2", "count", "count_err", "cov"):
        np.testing.assert_allclose(getattr(ta, f).numpy(), np.asarray(getattr(ja, f)),
                                   rtol=rtol, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("d,groups", [(2, ((0, 1),)), (4, ((0, 1, 2, 3), (1, 3)))])
def test_welford_batch_update_matches(d, groups):
    jc, tc, ja, ta = _adapt_pair(d, groups, 0)
    rng = np.random.default_rng(1)
    for i in range(6):
        xs = rng.normal(loc=i, size=(d, 64)).astype(np.float32)
        ja = j_adapt.welford_batch_update(ja, jnp.asarray(xs))
        ta = t_adapt.welford_batch_update(ta, torch.tensor(xs))
        _assert_adapt_close(ta, ja)


@pytest.mark.parametrize("mass_adapt", [False, True])
def test_refresh_factors_matches(mass_adapt):
    groups = ((0, 1, 2, 3), (1, 3))
    jc, tc, ja, ta = _adapt_pair(4, groups, 2)
    jc = dataclasses.replace(jc, mass_adapt=mass_adapt)
    tc = dataclasses.replace(tc, mass_adapt=mass_adapt)
    rng = np.random.default_rng(3)
    mix = rng.normal(size=(4, 4))
    for _ in range(3):
        xs = (mix @ rng.normal(size=(4, 128))).astype(np.float32)
        ja = j_adapt.welford_batch_update(ja, jnp.asarray(xs))
        ta = t_adapt.welford_batch_update(ta, torch.tensor(xs))
    ja = j_adapt.refresh_factors(jc, ja)
    ta = t_adapt.refresh_factors(tc, ta)
    _assert_adapt_close(ta, ja)
    for gi in range(len(groups)):
        # eigh column signs and order may differ: compare U diag(s) U^T.
        ju, js = np.asarray(ja.group_u[gi]), np.asarray(ja.group_s[gi])
        tu, ts = ta.group_u[gi].numpy(), ta.group_s[gi].numpy()
        np.testing.assert_allclose((tu * ts) @ tu.T, (ju * js) @ ju.T, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.sort(ts), np.sort(js), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ta.chol.numpy(), np.asarray(ja.chol), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ta.chol_inv.numpy(), np.asarray(ja.chol_inv), rtol=1e-4, atol=1e-5)


def test_refresh_keeps_factors_on_degenerate_cov():
    """An all-zero covariance (no samples yet) keeps the previous factors."""
    _, tc, _, ta = _adapt_pair(2, ((0, 1),), 4)
    new = t_adapt.refresh_factors(tc, ta)
    np.testing.assert_array_equal(new.group_u[0].numpy(), ta.group_u[0].numpy())
    np.testing.assert_array_equal(new.group_s[0].numpy(), ta.group_s[0].numpy())


def _jax_state_after_steps(nsteps=7):
    model = JCurved()

    def func_grad(x, beta):
        ll, gll = model.lnlikefn_grad(x)
        lp, glp = model.lnpriorfn_grad(x)
        return beta * ll + lp, beta * gll + glp

    kw = dict(SCAMweight=10, AMweight=10, DEweight=10, CHEESweight=20, burn=3, have_grads=True)
    common = dict(ndim=2, ntemps=3, nchains=16, groups=((0, 1),), tskip=2, cov_update=8,
                  burn=3, thin=1, de_size=20, hmc_stepsize=0.08, chees_max_steps=16)
    jc = j_config.SamplerConfig(jumps=j_config.build_default_jumps(**kw), **common)
    tc = t_config.SamplerConfig(jumps=t_config.build_default_jumps(**kw), **common)
    step, _ = j_build_step(jc, model.lnlikefn, model.lnpriorfn, func_grad)
    xs = jnp.broadcast_to(jnp.asarray([-0.1, -0.5], jnp.float32), (3, 16, 2))
    ll0 = jax.vmap(jax.vmap(model.lnlikefn))(xs)
    lp0 = jax.vmap(jax.vmap(model.lnpriorfn))(xs)
    st = j_state.init_state(jc, jax.random.key(0), np.array([-0.1, -0.5]), np.eye(2),
                            np.array([1.0, 0.5, 0.25]), ll0, lp0)
    step = jax.jit(step)
    for _ in range(nsteps):
        st = step(st)
    return jc, tc, st


def _flatten(jstate):
    flat = jax.tree_util.tree_flatten_with_path(jstate)[0]
    return {_path_name(p): np.asarray(leaf) for p, leaf in flat if _path_name(p) != "key"}


def assert_same_ring_fill(port, jax_count, ring):
    """The port's DE fill count (below 2 * ring, state.de_fill_count) and
    the JAX package's running count give the same ring start and valid
    rows."""
    assert port < 2 * ring
    assert port % ring == jax_count % ring and min(port, ring) == min(jax_count, ring)


def test_state_carries_across_and_round_trips():
    jc, tc, jst = _jax_state_after_steps()
    arrays = _flatten(jst)
    tst = t_state.state_from_numpy(arrays, tc, device="cpu", seed=3)
    back = t_state.state_to_numpy(tst)
    assert sorted(back) == sorted(arrays)
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype, k
        if k == "de/filled":  # kept below 2 * ring: same start, same valid count
            assert_same_ring_fill(int(back[k]), int(v), arrays["de/buf"].shape[1])
            continue
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # and the round trip through the port is exact
    again = t_state.state_to_numpy(t_state.state_from_numpy(back, tc, device="cpu"))
    for k, v in back.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)


def test_history_updates_after_carry_match():
    """history_updates on the carried state equals the JAX composition
    (kernel.py:430-452) at an iteration that also refreshes the factors."""
    jc, tc, jst = _jax_state_after_steps(nsteps=7)
    tst = t_state.state_from_numpy(_flatten(jst), tc, device="cpu")
    it = 8  # cov_update = 8: refresh due
    adapt = j_adapt.welford_batch_update(jst.adapt, jst.x[0])
    de = j_adapt.de_buffer_push(jst.de, jst.x[0])
    adapt = j_adapt.refresh_factors(jc, adapt)
    tst = t_kernel.history_updates(tc, tst, it)
    _assert_adapt_close(tst.adapt, adapt)
    np.testing.assert_array_equal(tst.de.buf.numpy(), np.asarray(de.buf))
    assert_same_ring_fill(tst.de.filled, int(de.filled), tst.de.buf.shape[1])
    ju, js = np.asarray(adapt.group_u[0]), np.asarray(adapt.group_s[0])
    tu, ts = tst.adapt.group_u[0].numpy(), tst.adapt.group_s[0].numpy()
    np.testing.assert_allclose((tu * ts) @ tu.T, (ju * js) @ ju.T, rtol=1e-4, atol=1e-6)


def test_state_from_numpy_rejects_wrong_shape():
    jc, tc, jst = _jax_state_after_steps(nsteps=1)
    arrays = _flatten(jst)
    arrays["x"] = arrays["x"][:, :, :8]
    with pytest.raises(ValueError, match="'x'"):
        t_state.state_from_numpy(arrays, tc, device="cpu")
    del arrays["x"]
    with pytest.raises(ValueError, match="missing 'x'"):
        t_state.state_from_numpy(arrays, tc, device="cpu")
