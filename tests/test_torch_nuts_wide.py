"""PyTorch port vs the JAX package: the NUTS tree (plain version of the wide
CUDA kernel) and the NUTS proposal on the wide models.

* ``nuts_trees_plain`` against the Pallas tree kernel run by the interpreter
  (``fused_nuts_trees(interpret=True)``), fed the same numpy-seeded arrays,
  reservoir uniforms included, on the 40-D interval-transformed Gaussian,
  the 50-D hierarchy and a 20-D correlated Gaussian (one start outside its
  box), two dozen chains at depth 3 and 4.
* ``make_nuts``'s core against ``make_nuts_pallas(interpret=True)`` at 50-D,
  its draws replayed from its key splits (nuts_pallas.py:454-487), on a
  first call (the step-size search runs) and in burn-in.
* At 200-D (bench.py's gaussian200), a small batch against the JAX
  package's XLA NUTS (``proposals/nuts.py make_nuts``) fed the same draws,
  replayed from its per-chain key chain.

Tolerances are tests/test_torch_nuts.py's (Q_TOL, LOGP_TOL, ALPHA_RTOL, and
SS_RTOL, SS_ATOL for the step-size state): f32 sums over D are ordered
differently in XLA and in the port. Leaf counts and cap cuts must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptmcmcsampler_torch import config as t_config
from ptmcmcsampler_torch import models as tm
from ptmcmcsampler_torch.ops.nuts import nuts_trees_plain
from ptmcmcsampler_torch.proposals import nuts as t_nuts
from ptmcmcsampler_torch.proposals.base import ProposalContext as TCtx
from ptmcmcsampler_tpu import config as j_config
from ptmcmcsampler_tpu import models as jm
from ptmcmcsampler_tpu.ops.nuts_pallas import fused_nuts_trees, make_nuts_pallas
from ptmcmcsampler_tpu.proposals import nuts as j_nuts
from ptmcmcsampler_tpu.proposals.base import ProposalContext as JCtx
from ptmcmcsampler_tpu.utils import split_grid

torch.set_num_threads(2)

Q_TOL, LOGP_TOL, ALPHA_RTOL = 2e-4, 2e-3, 1e-4
SS_RTOL, SS_ATOL = 2e-3, 2e-4
SS_NUTS = ("epsilon", "epsilonbar", "hbar", "mu", "ncalls")
T = 2

MODELS = {
    "interval40": (lambda: tm.IntervalTransformedGaussian(),
                   lambda: jm.IntervalTransformedGaussian()),
    "hierarchical50": (lambda: tm.HierarchicalGaussian(), lambda: jm.HierarchicalGaussian()),
    "correlated20": (lambda: tm.CorrelatedGaussian(), lambda: jm.CorrelatedGaussian()),
    "correlated200": (lambda: tm.CorrelatedGaussian(ndim=200, seed=1),
                      lambda: jm.CorrelatedGaussian(ndim=200, seed=1)),
}
# A step size a rung that gives trees of several sizes (whitened coordinates).
EPS = {"interval40": 0.25, "hierarchical50": 0.08, "correlated20": 0.04, "correlated200": 0.01}


def _func_grad(jmodel):
    def fg(x, beta):
        ll, gll = jmodel.lnlikefn_grad(x)
        lp, glp = jmodel.lnpriorfn_grad(x)
        return beta * ll + lp, beta * gll + glp

    return fg


def _setup(name, c, seed):
    """Positions around the posterior (one chain outside the correlated
    model's box), a well-conditioned mass-matrix factor, two rungs."""
    t_model, j_model = (f() for f in MODELS[name])
    rng = np.random.default_rng(seed)
    d = t_model.ndim
    if name.startswith("correlated"):
        centre, scale = t_model.mu, 0.1
    elif name.startswith("interval"):
        centre, scale = np.full(d, -2.5), 0.5
    else:
        centre, scale = t_model.posterior_moments()[0], 0.3
    x = (centre[None, :, None] + scale * rng.normal(size=(T, d, c))).astype(np.float32)
    if name.startswith("correlated"):
        x = x.clip(0.05, 9.95)  # inside the closed box [0, 10] ...
        x[0, 0, 3] = -0.5  # ... but for this one
    a = rng.normal(size=(d, d)) / d
    chol = np.linalg.cholesky(0.05 * np.eye(d) + 0.05 * a @ a.T).astype(np.float32)
    betas = np.array([1.0, 0.3], np.float32)
    return t_model, j_model, rng, x, chol, betas


def _to_tdc(a, t, c):
    """``[T*C, K]`` (the JAX kernels' rows) -> ``[T, K, C]``."""
    return np.moveaxis(np.asarray(a).reshape(t, c, -1), 2, 1)


def _to_ktc(a, t, c):
    """``[T*C, K]`` -> ``[K, T, C]`` (the port's draw layout)."""
    return np.moveaxis(np.asarray(a).reshape(t, c, -1), 2, 0)


@pytest.mark.parametrize("name,depth", [("interval40", 3), ("interval40", 4),
                                        ("hierarchical50", 3), ("hierarchical50", 4),
                                        ("correlated20", 4)])
def test_plain_tree_matches_pallas_interpreted(name, depth):
    c = 12
    t_model, j_model, rng, x, chol, betas = _setup(name, c, depth)
    d = t_model.ndim
    f32 = np.float32
    q0 = np.einsum("ki,tkc->tic", np.linalg.inv(chol), x).astype(f32)
    inp = dict(
        q0=q0, r0=rng.normal(size=(T, d, c)).astype(f32), beta=betas,
        eps=(EPS[name] * 1.5 ** np.arange(T)[:, None] * np.ones((T, c))).astype(f32),
        expo=rng.exponential(size=(T, c)).astype(f32),
        dirs=np.where(rng.random((depth, T, c)) < 0.5, -1.0, 1.0).astype(f32),
        accu=rng.random((depth, T, c)).astype(f32),
        resu=rng.random(((1 << depth) - 1, T, c)).astype(f32), chol=chol,
    )

    def rows(a):  # [T, K, C] -> [T*C, K]
        return jnp.asarray(np.moveaxis(a, 1, 2).reshape(T * c, -1))

    def rows_k(a):  # [K, T, C] -> [T*C, K]
        return jnp.asarray(np.moveaxis(a, 0, 2).reshape(T * c, -1))

    jout = fused_nuts_trees(
        rows(inp["q0"]), rows(inp["r0"]), jnp.asarray(np.repeat(betas, c)),
        jnp.asarray(inp["eps"].reshape(-1)), jnp.asarray(inp["expo"].reshape(-1)),
        rows_k(inp["dirs"]), rows_k(inp["accu"]), rows_k(inp["resu"]), jnp.asarray(chol),
        func_grad=_func_grad(j_model), ndim=d, max_depth=depth, interpret=True,
    )
    tout = nuts_trees_plain(*(torch.tensor(inp[k]) for k in (
        "q0", "r0", "beta", "eps", "expo", "dirs", "accu", "resu", "chol")), t_model)
    jq = _to_tdc(jout[0], T, c)
    jl0, jlp, ja, jn, jalive = (np.asarray(a).reshape(T, c) for a in jout[1:])
    tq, tl0, tlp, ta, tn, talive, teps = (a.numpy() for a in tout)
    np.testing.assert_array_equal(teps, inp["eps"])  # no lane searched
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(talive, jalive)
    np.testing.assert_allclose(tq, jq, rtol=Q_TOL, atol=Q_TOL)
    np.testing.assert_array_equal(np.isneginf(tl0), np.isneginf(jl0))
    fin = np.isfinite(jl0)
    np.testing.assert_allclose(tl0[fin], jl0[fin], rtol=LOGP_TOL, atol=LOGP_TOL)
    np.testing.assert_allclose(tlp, jlp, rtol=LOGP_TOL, atol=LOGP_TOL)
    np.testing.assert_allclose(ta, ja, rtol=ALPHA_RTOL, atol=1e-6)
    assert tn.max() > 1  # trees of several sizes
    if name.startswith("correlated"):  # outside the box: logp0 = -inf, the tree still runs
        assert np.isneginf(tl0[0, 3])


def _configs(d, c, depth, burn=100):
    kw = dict(ndim=d, ntemps=T, nchains=c, groups=(tuple(range(d)),), burn=burn,
              nuts_max_depth=depth)
    jumps = dict(NUTSweight=1, SCAMweight=0, AMweight=0, DEweight=0, have_grads=True)
    jc = j_config.SamplerConfig(jumps=j_config.build_default_jumps(**jumps), **kw)
    tc = t_config.SamplerConfig(jumps=t_config.build_default_jumps(**jumps), **kw)
    return jc, tc


def _pallas_draws(keys, d, depth):
    """make_nuts_pallas's draws (nuts_pallas.py:454-487) in the port's
    layouts: r0, expo, dirs, accu, resu and the step-size search's momenta."""
    t, c = keys.shape
    kk = jax.vmap(lambda k: tuple(jax.random.split(k, 6)))(keys.reshape(t * c))
    k_eps, k_mom, k_slice, k_dir, k_acc, k_res = kk
    normal = jax.vmap(lambda k: jax.random.normal(k, (d,), dtype=jnp.float32))
    uniform = jax.vmap(lambda k: jax.random.uniform(k, (depth,), dtype=jnp.float32))
    resu = jnp.concatenate([
        jax.vmap(lambda k, j=j: jax.random.uniform(
            jax.random.fold_in(k, j), (1 << j,), dtype=jnp.float32))(k_res)
        for j in range(depth)
    ], axis=-1)
    return dict(
        r0=_to_tdc(normal(k_mom), t, c),
        expo=np.asarray(jax.vmap(lambda k: jax.random.exponential(k, dtype=jnp.float32))(
            k_slice)).reshape(t, c),
        dirs=np.where(_to_ktc(uniform(k_dir), t, c) < 0.5, -1.0, 1.0).astype(np.float32),
        accu=_to_ktc(uniform(k_acc), t, c),
        resu=_to_ktc(resu, t, c),
        r_eps=_to_tdc(normal(k_eps), t, c),
    )


def _xla_draws(keys, d, depth):
    """The XLA NUTS's draws (ptmcmcsampler_tpu/proposals/nuts.py:200-340) for
    a tree of up to ``depth`` doublings, in the port's layouts: per chain
    ``k_eps, k_mom, k_slice, k_tree = split(key, 4)``; doubling j splits its
    carried key into (next, k_dir, k_sub, k_acc); leaf k of the subtree
    splits its carried key (from k_sub) into (next, k_take)."""
    t, c = keys.shape
    kf = keys.reshape(t * c)
    k_eps, k_mom, k_slice, k_tree = jax.vmap(lambda k: tuple(jax.random.split(k, 4)))(kf)
    unif = jax.vmap(lambda k: jax.random.uniform(k, dtype=jnp.float32))
    dirs, accu, resu = [], [], []
    key = k_tree
    for j in range(depth):
        key, k_dir, k_sub, k_acc = jax.vmap(lambda k: tuple(jax.random.split(k, 4)))(key)
        dirs.append(np.where(np.asarray(unif(k_dir)) < 0.5, -1.0, 1.0))
        accu.append(np.asarray(unif(k_acc)))
        for _ in range(1 << j):
            k_sub, k_take = jax.vmap(lambda k: tuple(jax.random.split(k)))(k_sub)
            resu.append(np.asarray(unif(k_take)))
    normal = jax.vmap(lambda k: jax.random.normal(k, (d,), dtype=jnp.float32))

    def tc(rows):
        return np.stack(rows).reshape(-1, t, c).astype(np.float32)

    return dict(
        r0=_to_tdc(normal(k_mom), t, c),
        expo=np.asarray(jax.vmap(lambda k: jax.random.exponential(k, dtype=jnp.float32))(
            k_slice)).reshape(t, c),
        dirs=tc(dirs), accu=tc(accu), resu=tc(resu), r_eps=_to_tdc(normal(k_eps), t, c),
    )


def _ss(c, first_call, eps):
    vals = dict(epsilon=eps, epsilonbar=0.9 * eps, hbar=0.02, mu=np.log(10 * eps), ncalls=4.0)
    if first_call:
        vals.update(epsilon=-1.0, epsilonbar=1.0, hbar=0.0, mu=0.0, ncalls=0.0)
    ss = {k: np.full((T, c), v, np.float32) for k, v in vals.items()}
    ss["epsilon"][1, ::3] *= 1.3  # chains of one rung at different step sizes
    return ss


def _ctxs(chol):
    chol_inv = np.linalg.inv(chol).astype(np.float32)
    jctx = JCtx(group_u=None, group_s=None, chol=jnp.asarray(chol),
                chol_inv=jnp.asarray(chol_inv), de_buf=None, de_valid=None)
    tctx = TCtx(group_u=None, group_s=None, chol=torch.tensor(chol),
                chol_inv=torch.tensor(chol_inv), de_buf=None, de_valid=0)
    return jctx, tctx


def _assert_step_matches(tq, tqxy, tss, jq, jqxy, jss, ss):
    np.testing.assert_allclose(tq.numpy(), jq, rtol=Q_TOL, atol=Q_TOL)
    np.testing.assert_array_equal(np.isneginf(tqxy.numpy()), np.isneginf(jqxy))
    fin = np.isfinite(jqxy)
    np.testing.assert_allclose(tqxy.numpy()[fin], jqxy[fin], rtol=LOGP_TOL, atol=LOGP_TOL)
    for k in ss:
        np.testing.assert_allclose(tss[k].numpy(), np.asarray(jss[k]), rtol=SS_RTOL,
                                   atol=SS_ATOL, err_msg=k)


@pytest.mark.parametrize("it,first_call", [(5, True), (5, False)])
def test_nuts_core_matches_make_nuts_pallas(it, first_call):
    """At 50-D: a first call (epsilon = -1, find_reasonable_epsilon runs on
    the k_eps draws) and a call in burn-in (dual averaging moves)."""
    name, c, depth = "hierarchical50", 8, 4
    t_model, j_model, _, x, chol, betas = _setup(name, c, 11)
    d = t_model.ndim
    jc, tc = _configs(d, c, depth)
    jctx, tctx = _ctxs(chol)
    ss = _ss(c, first_call, EPS[name])
    keys = split_grid(jax.random.key(it + 7 * first_call), (T, c))
    jq, jqxy, jss = make_nuts_pallas(jc, _func_grad(j_model), interpret=True)(
        keys, jnp.asarray(np.moveaxis(x, 1, 2)), jnp.asarray(betas), it, jctx,
        {k: jnp.asarray(v) for k, v in ss.items()},
    )
    dr = {k: torch.tensor(np.ascontiguousarray(v))
          for k, v in _pallas_draws(keys, d, depth).items()}
    tq, tqxy, tss = t_nuts.make_nuts(tc, t_model).core(
        torch.tensor(x), torch.tensor(betas), it, tctx,
        {k: torch.tensor(v) for k, v in ss.items()},
        dr["r0"], dr["expo"], dr["dirs"], dr["accu"], dr["resu"], dr["r_eps"],
    )
    _assert_step_matches(tq, tqxy, tss, np.moveaxis(np.asarray(jq), 2, 1), np.asarray(jqxy),
                         jss, ss)
    if first_call:
        assert (tss["epsilon"] > 0).all()


@pytest.mark.parametrize("first_call", [True, False])
def test_nuts_core_matches_xla_nuts_at_200d(first_call):
    """At 200-D (bench.py's gaussian200, one start outside the box): the
    port's core against the JAX package's XLA NUTS fed its own key chain's
    draws."""
    name, c, depth = "correlated200", 4, 3
    t_model, j_model, _, x, chol, betas = _setup(name, c, 5)
    d = t_model.ndim
    jc, tc = _configs(d, c, depth)
    jctx, tctx = _ctxs(chol)
    ss = _ss(c, first_call, EPS[name])
    keys = split_grid(jax.random.key(13 + first_call), (T, c))
    nuts = j_nuts.make_nuts(jc, _func_grad(j_model))
    per_chain = jax.vmap(lambda k, xx, b, s: nuts(k, xx, b, 5, jctx, s),
                         in_axes=(0, -1, None, 0), out_axes=(-1, 0, 0))
    jq, jqxy, jss = jax.vmap(per_chain)(keys, jnp.asarray(x), jnp.asarray(betas),
                                        {k: jnp.asarray(v) for k, v in ss.items()})
    dr = {k: torch.tensor(np.ascontiguousarray(v)) for k, v in _xla_draws(keys, d, depth).items()}
    tq, tqxy, tss = t_nuts.make_nuts(tc, t_model).core(
        torch.tensor(x), torch.tensor(betas), 5, tctx, {k: torch.tensor(v) for k, v in ss.items()},
        dr["r0"], dr["expo"], dr["dirs"], dr["accu"], dr["resu"], dr["r_eps"],
    )
    _assert_step_matches(tq, tqxy, tss, np.asarray(jq), np.asarray(jqxy), jss, ss)
    if first_call:  # the start outside the box adapts to NaN, as in JAX (compared above)
        inside = np.ones((T, c), bool)
        inside[0, 3] = False
        assert (tss["epsilon"].numpy()[inside] > 0).all()
