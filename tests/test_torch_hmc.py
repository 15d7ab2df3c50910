"""PyTorch port vs the JAX package: the HMC trajectories and the fused HMC
step (plain versions of the CUDA kernel's two entries), the step's draws,
and the HMC proposal.

The plain trajectories are held to the Pallas kernel run by the interpreter
(``fused_hmc_trajectories(interpret=True)``) on the curved model, and the
fused step's plain version and ``make_hmc``'s core to the JAX
``gradient.make_hmc`` fed the same momenta and trajectory lengths, replayed
from its key splits (gradient.py:106-113). Tolerances are those of
tests/test_pallas_ops.py:70-71: the banana's leapfrog amplifies f32 ulp
differences between XLA and PyTorch. The step's own draws come from a
Philox key (``hmc_draws``): their layout is held to ``philox4x32`` and
their law to U[nmin, nmax) and N(0, 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from ptmcmcsampler_torch import config as t_config
from ptmcmcsampler_torch.models import CurvedLikelihood as TCurved
from ptmcmcsampler_torch.ops.common import philox4x32
from ptmcmcsampler_torch.ops.hmc import (
    STREAM_HMC, hmc_draws, hmc_step, hmc_step_plain, hmc_trajectories,
)
from ptmcmcsampler_torch.proposals import gradient as t_gradient
from ptmcmcsampler_torch.proposals.base import ProposalContext as TCtx
from ptmcmcsampler_tpu import config as j_config
from ptmcmcsampler_tpu.models import CurvedLikelihood as JCurved
from ptmcmcsampler_tpu.ops.hmc_pallas import fused_hmc_trajectories
from ptmcmcsampler_tpu.proposals import gradient as j_gradient
from ptmcmcsampler_tpu.proposals.base import ProposalContext as JCtx
from ptmcmcsampler_tpu.utils import split_grid

torch.set_num_threads(2)

T, C, D = 2, 24, 2
Q_TOL, QXY_TOL = 2e-4, 2e-3
EPS, NMIN, NMAX = 0.08, 2, 50
HMC_KW = dict(ndim=D, ntemps=T, nchains=C, groups=((0, 1),), hmc_stepsize=EPS,
              hmc_nminsteps=NMIN, hmc_nmaxsteps=NMAX)


def _func_grad(x, beta):
    m = JCurved()
    ll, gll = m.lnlikefn_grad(x)
    lp, glp = m.lnpriorfn_grad(x)
    return beta * ll + lp, beta * gll + glp


def _setup(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(0.0, 0.3, (T, D, C)) + np.array([0.0, -1.0])[None, :, None]).astype(np.float32)
    x[0, :, 3] = [12.0, 0.5]  # starts outside the prior box
    cov = np.array([[0.25, 0.05], [0.05, 0.2]])
    chol = np.linalg.cholesky(cov).astype(np.float32)
    chol_inv = np.linalg.inv(chol).astype(np.float32)
    betas = np.array([1.0, 0.3], np.float32)
    jctx = JCtx(group_u=None, group_s=None, chol=jnp.asarray(chol), chol_inv=jnp.asarray(chol_inv),
                de_buf=None, de_valid=None)
    tctx = TCtx(group_u=None, group_s=None, chol=torch.tensor(chol),
                chol_inv=torch.tensor(chol_inv), de_buf=None, de_valid=0)
    return rng, x, betas, chol, jctx, tctx


def _flat(a):  # [T, D, C] -> [T*C, D]
    return jnp.asarray(np.moveaxis(a, 1, 2).reshape(-1, a.shape[1]))


@pytest.mark.parametrize("eps,nmin,nmax", [(0.08, 2, 50), (5.0, 10, 30)])
def test_plain_trajectories_match_pallas_interpreted(eps, nmin, nmax):
    """At the path's settings, and at a huge step size where most lanes
    leave the prior box and are rejected (cf. test_pallas_ops.py:74-90)."""
    rng, x, betas, chol, _, _ = _setup(0)
    q0 = np.einsum("ki,tkc->tic", np.linalg.inv(chol).astype(np.float32), x).astype(np.float32)
    p0 = rng.normal(size=(T, D, C)).astype(np.float32)
    nsteps = rng.integers(nmin, nmax, size=(T, C)).astype(np.int32)
    jq, jqxy = fused_hmc_trajectories(
        _flat(q0), _flat(p0), jnp.asarray(np.repeat(betas, C)), jnp.asarray(nsteps.reshape(-1)),
        jnp.asarray(chol), func_grad=_func_grad, ndim=D, eps=eps, nmax_steps=nmax - 1,
        interpret=True,
    )
    tq, tqxy = hmc_trajectories(
        torch.tensor(q0), torch.tensor(p0), torch.tensor(betas), torch.tensor(nsteps),
        torch.tensor(chol), eps, TCurved(),
    )
    assert tq.shape == (T, D, C) and tqxy.shape == (T, C)
    jq = np.moveaxis(np.asarray(jq).reshape(T, C, D), 2, 1)
    jqxy = np.asarray(jqxy).reshape(T, C)
    np.testing.assert_array_equal(np.isneginf(tqxy.numpy()), np.isneginf(jqxy))
    fin = np.isfinite(jqxy)
    np.testing.assert_allclose(tqxy.numpy()[fin], jqxy[fin], rtol=QXY_TOL, atol=QXY_TOL)
    np.testing.assert_allclose(tq.numpy(), jq, rtol=Q_TOL, atol=Q_TOL)
    if eps > 1.0:
        assert np.mean(~fin) > 0.5  # most first steps left the prior box


def _jax_hmc(seed, key):
    """The JAX ``make_hmc`` on ``_setup(seed)``'s chains under per-chain key
    splits of ``key``, and its draws replayed: ``kp, kn = split(key); p0 =
    normal(kp, (D,)), nsteps = randint(kn, (), NMIN, NMAX)``
    (gradient.py:106-113). Returns the setup, the JAX results and the draws
    as torch tensors ``(p0 [T, D, C], nsteps [T, C] int32)``."""
    _, x, betas, chol, jctx, tctx = _setup(seed)
    jc = j_config.SamplerConfig(jumps=j_config.build_default_jumps(HMCweight=1, have_grads=True),
                                **HMC_KW)
    keys = split_grid(jax.random.key(key), (T, C))
    hmc = j_gradient.make_hmc(jc, _func_grad)
    per_chain = jax.vmap(lambda k, xx, b: hmc(k, xx, b, 0, jctx), in_axes=(0, -1, None),
                         out_axes=(-1, 0))
    jq, jqxy = jax.vmap(per_chain)(keys, jnp.asarray(x), jnp.asarray(betas))
    ks = jax.vmap(jax.vmap(jax.random.split))(keys)
    p0 = jax.vmap(jax.vmap(lambda k: jax.random.normal(k, (D,), dtype=jnp.float32),
                           out_axes=-1))(ks[:, :, 0])
    nsteps = jax.vmap(jax.vmap(lambda k: jax.random.randint(k, (), NMIN, NMAX)))(ks[:, :, 1])
    draws = (torch.tensor(np.asarray(p0)), torch.tensor(np.asarray(nsteps, np.int32)))
    return (x, betas, chol, tctx), (np.asarray(jq), np.asarray(jqxy)), draws


def _assert_matches_jax(tq, tqxy, jq, jqxy):
    np.testing.assert_array_equal(np.isneginf(tqxy.numpy()), np.isneginf(jqxy))
    assert np.isneginf(tqxy.numpy()[0, 3])  # the chain outside the box is rejected
    fin = np.isfinite(jqxy)
    np.testing.assert_allclose(tqxy.numpy()[fin], jqxy[fin], rtol=QXY_TOL, atol=QXY_TOL)
    np.testing.assert_allclose(tq.numpy(), jq, rtol=Q_TOL, atol=Q_TOL)


def test_hmc_core_matches_make_hmc():
    (x, betas, _, tctx), (jq, jqxy), draws = _jax_hmc(2, 3)
    tc = t_config.SamplerConfig(jumps=t_config.build_default_jumps(HMCweight=1, have_grads=True),
                                **HMC_KW)
    tq, tqxy = t_gradient.make_hmc(tc, TCurved()).core(
        torch.tensor(x), torch.tensor(betas), tctx, draws)
    _assert_matches_jax(tq, tqxy, jq, jqxy)


def test_hmc_step_plain_matches_make_hmc():
    """The fused step's plain version fed the JAX draws. The start outside
    the prior box has joint0 = -inf, so the break test never holds and it
    runs its whole drawn length: its end point is not the one-step point."""
    (x, betas, chol, tctx), (jq, jqxy), (p0, nsteps) = _jax_hmc(4, 5)
    args = (torch.tensor(x), torch.tensor(betas))
    mats = (tctx.chol, tctx.chol_inv, EPS, NMIN, NMAX, TCurved())
    tq, tqxy = hmc_step_plain(*args, (p0, nsteps), *mats)
    _assert_matches_jax(tq, tqxy, jq, jqxy)
    one, _ = hmc_step_plain(*args, (p0, torch.ones_like(nsteps)), *mats)
    assert int(nsteps[0, 3]) > 1 and not torch.equal(tq[0, :, 3], one[0, :, 3])
    inside = torch.ones((T, C), dtype=torch.bool)
    inside[0, 3] = False
    # every chain inside the box stopped after its first step
    assert torch.equal(tq.movedim(1, 2)[inside], one.movedim(1, 2)[inside])


def test_hmc_step_plain_key_equals_materialised_draws():
    _, x, betas, _, _, tctx = _setup(6)
    key = torch.tensor([0x89ABCDEF, 0x01234567], dtype=torch.int64)
    args = (torch.tensor(x), torch.tensor(betas))
    mats = (tctx.chol, tctx.chol_inv, EPS, NMIN, NMAX, TCurved())
    got = hmc_step_plain(*args, key, *mats)
    want = hmc_step_plain(*args, hmc_draws(key, T, D, C, NMIN, NMAX), *mats)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got[0], hmc_step(*args, key, *mats)[0])  # the CPU wrapper


def test_hmc_draws_follow_philox_layout():
    """Chain n = t*C + c: Philox4x32-10 at counter (0, n, STREAM_HMC, 0);
    words 0 and 1 give the momenta by Box-Muller, word 2 the length."""
    t, c, nmin, nmax = 3, 7, 2, 50
    kw = (0x12345678, 0x9ABCDEF0)
    p0, nsteps = hmc_draws(torch.tensor(kw, dtype=torch.int64), t, D, c, nmin, nmax)
    assert p0.shape == (t, D, c) and p0.dtype == torch.float32
    assert nsteps.shape == (t, c) and nsteps.dtype == torch.int32
    f32 = np.float32
    for ti, ci in [(0, 0), (2, 6), (1, 3), (0, 5)]:
        w = [int(v) for v in philox4x32((0, ti * c + ci, STREAM_HMC, 0), kw)]
        assert int(nsteps[ti, ci]) == nmin + ((w[2] * (nmax - nmin)) >> 32)
        u1 = f32((w[0] >> 8) + 1) * f32(2.0**-24)
        u2 = f32(w[1] >> 8) * f32(2.0**-24)
        r = np.sqrt(f32(-2.0) * np.log(u1))
        theta = f32(2 * np.pi) * u2
        want = np.array([r * np.cos(theta), r * np.sin(theta)], f32)
        np.testing.assert_allclose(p0[ti, :, ci].numpy(), want, rtol=4e-7, atol=1e-7)
    # The NUTS reservoir's counters (r, n, 0, 0) give other words.
    other = philox4x32((0, 0, 0, 0), kw)
    assert int(other[2]) != int(philox4x32((0, 0, STREAM_HMC, 0), kw)[2])


def test_hmc_draws_statistics():
    """At the main path's shape (8 x 16384 chains): lengths uniform on
    [nmin, nmax), both ends reached; momenta standard normal in mean,
    variance and shape, the two dimensions uncorrelated."""
    t, c, nmin, nmax = 8, 16384, 2, 50
    n = t * c
    p0, nsteps = hmc_draws(torch.tensor([77, 2024], dtype=torch.int64), t, D, c, nmin, nmax)
    ns = nsteps.flatten().numpy()
    assert ns.min() == nmin and ns.max() == nmax - 1
    counts = np.bincount(ns - nmin, minlength=nmax - nmin)
    assert stats.chisquare(counts).pvalue > 1e-3
    p = p0.transpose(0, 1).reshape(D, n).double().numpy()
    for d in range(D):
        assert abs(p[d].mean()) * np.sqrt(n) < 4.0
        assert abs(p[d].var() - 1.0) / np.sqrt(2.0 / n) < 4.0
        assert stats.kstest(p[d], "norm").statistic < 0.01
    assert abs(np.corrcoef(p)[0, 1]) * np.sqrt(n) < 4.0


def test_hmc_draws_edge_and_range_checks():
    key = torch.tensor([3, 4], dtype=torch.int64)
    p0, nsteps = hmc_draws(key, 2, D, 50, 5, 6)  # nmax = nmin + 1: one length
    assert torch.equal(nsteps, torch.full((2, 50), 5, dtype=torch.int32))
    assert torch.isfinite(p0).all()
    for nmin, nmax in ((5, 5), (-1, 4)):
        with pytest.raises(ValueError, match="lengths"):
            hmc_draws(key, 2, D, 50, nmin, nmax)


@pytest.mark.parametrize("d", [1, 3, 4, 5, 8, 9])
def test_hmc_draws_layout_any_dimension(d):
    """The layout beyond D = 2: chain n takes Philox calls j = 0, 1, ... at
    counters (j, n, STREAM_HMC, 0), call j giving words 4j .. 4j + 3;
    momentum pair m comes from words 2m and 2m + 1 (the last sine dropped for
    an odd D), the length from word 2 ceil(D/2)."""
    t, c, nmin, nmax = 2, 5, 3, 40
    kw = (0x0F1E2D3C, 0x4B5A6978)
    p0, nsteps = hmc_draws(torch.tensor(kw, dtype=torch.int64), t, d, c, nmin, nmax)
    assert p0.shape == (t, d, c) and nsteps.shape == (t, c)
    pairs = (d + 1) // 2
    f32 = np.float32
    for ti, ci in [(0, 0), (1, 4), (1, 2)]:
        n = ti * c + ci
        w = [int(v) for j in range((2 * pairs + 4) // 4)
             for v in philox4x32((j, n, STREAM_HMC, 0), kw)]
        assert len(w) >= 2 * pairs + 1
        assert int(nsteps[ti, ci]) == nmin + ((w[2 * pairs] * (nmax - nmin)) >> 32)
        want = []
        for m in range(pairs):
            u1 = f32((w[2 * m] >> 8) + 1) * f32(2.0**-24)
            u2 = f32(w[2 * m + 1] >> 8) * f32(2.0**-24)
            r = np.sqrt(f32(-2.0) * np.log(u1))
            theta = f32(2 * np.pi) * u2
            want += [r * np.cos(theta), r * np.sin(theta)]
        np.testing.assert_allclose(p0[ti, :, ci].numpy(), np.array(want[:d], f32),
                                   rtol=4e-7, atol=1e-7)
