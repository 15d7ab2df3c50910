"""PyTorch port vs the JAX package: the NUTS tree (plain version of the CUDA
kernel) and the NUTS proposal with its step-size adaptation.

* The plain tree against the Pallas tree kernel run by the interpreter
  (``fused_nuts_trees(interpret=True)``), fed the same pre-drawn arrays, on
  the curved model: positions and log densities within the tolerances of
  tests/test_pallas_ops.py:70-71, the leaf and cap counts equal.
* ``make_nuts``'s core against ``make_nuts_pallas(interpret=True)``, with
  its draws replayed from its key splits (nuts_pallas.py:454-487): on a
  first call (the step-size search runs), in burn-in and after it, and from
  a JAX sampler state carried into the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptmcmcsampler_torch import config as t_config
from ptmcmcsampler_torch import state as t_state
from ptmcmcsampler_torch.kernel import make_context
from ptmcmcsampler_torch.models import CurvedLikelihood as TCurved
from ptmcmcsampler_torch.ops.nuts import nuts_trees
from ptmcmcsampler_torch.proposals import nuts as t_nuts
from ptmcmcsampler_torch.proposals.base import ProposalContext as TCtx
from ptmcmcsampler_tpu import config as j_config
from ptmcmcsampler_tpu import state as j_state
from ptmcmcsampler_tpu.io.checkpoint import _path_name
from ptmcmcsampler_tpu.kernel import build_step as j_build_step
from ptmcmcsampler_tpu.models import CurvedLikelihood as JCurved
from ptmcmcsampler_tpu.ops.nuts_pallas import fused_nuts_trees, make_nuts_pallas
from ptmcmcsampler_tpu.proposals.base import ProposalContext as JCtx
from ptmcmcsampler_tpu.utils import split_grid

torch.set_num_threads(2)

D = 2
Q_TOL, LOGP_TOL, ALPHA_RTOL = 2e-4, 2e-3, 1e-4
SS_RTOL, SS_ATOL = 2e-3, 2e-4
SS_NUTS = ("epsilon", "epsilonbar", "hbar", "mu", "ncalls")


def _func_grad(x, beta):
    m = JCurved()
    ll, gll = m.lnlikefn_grad(x)
    lp, glp = m.lnpriorfn_grad(x)
    return beta * ll + lp, beta * gll + glp


def _to_tdc(a, t, c):
    """``[T*C, K]`` (the JAX kernels' rows) -> ``[T, K, C]``."""
    return np.moveaxis(np.asarray(a).reshape(t, c, -1), 2, 1)


def _to_ktc(a, t, c):
    """``[T*C, K]`` -> ``[K, T, C]`` (the port's draw layout)."""
    return np.moveaxis(np.asarray(a).reshape(t, c, -1), 2, 0)


def _tree_inputs(seed, t, c, depth, eps_scale=1.0):
    """Chains around both modes of the curved target, a non-trivial mass
    matrix, per-rung step sizes and the tree's uniforms, as numpy."""
    rng = np.random.default_rng(seed)
    mode = np.where(rng.random((t, 1, c)) < 0.5, -1.0, 2.0)
    x = 0.3 * rng.normal(size=(t, D, c))
    x[:, 1:] += mode
    chol = np.linalg.cholesky(np.array([[0.6, 0.15], [0.15, 0.9]])).astype(np.float32)
    q0 = np.einsum("ki,tkc->tic", np.linalg.inv(chol), x).astype(np.float32)
    f32 = np.float32
    return dict(
        q0=q0, r0=rng.normal(size=(t, D, c)).astype(f32),
        beta=np.geomspace(1.0, 0.3, t).astype(f32),
        eps=(eps_scale * 0.1 * 1.5 ** np.arange(t)[:, None] * np.ones((t, c))).astype(f32),
        expo=rng.exponential(size=(t, c)).astype(f32),
        dirs=np.where(rng.random((depth, t, c)) < 0.5, -1.0, 1.0).astype(f32),
        accu=rng.random((depth, t, c)).astype(f32),
        resu=rng.random(((1 << depth) - 1, t, c)).astype(f32),
        chol=chol,
    )


def _both_trees(inp, depth):
    t, _, c = inp["q0"].shape

    def rows(a):  # [T, K, C] -> [T*C, K]
        return jnp.asarray(np.moveaxis(a, 1, 2).reshape(t * c, -1))

    def rows_k(a):  # [K, T, C] -> [T*C, K]
        return jnp.asarray(np.moveaxis(a, 0, 2).reshape(t * c, -1))

    jout = fused_nuts_trees(
        rows(inp["q0"]), rows(inp["r0"]), jnp.asarray(np.repeat(inp["beta"], c)),
        jnp.asarray(inp["eps"].reshape(-1)), jnp.asarray(inp["expo"].reshape(-1)),
        rows_k(inp["dirs"]), rows_k(inp["accu"]), rows_k(inp["resu"]), jnp.asarray(inp["chol"]),
        func_grad=_func_grad, ndim=D, max_depth=depth, interpret=True,
    )
    tout = nuts_trees(*(torch.tensor(inp[k]) for k in (
        "q0", "r0", "beta", "eps", "expo", "dirs", "accu", "resu", "chol")), TCurved())
    jq = _to_tdc(jout[0], t, c)
    jstats = [np.asarray(a).reshape(t, c) for a in jout[1:]]
    np.testing.assert_array_equal(tout[6].numpy(), inp["eps"])  # no lane searched
    return (jq, *jstats), tuple(a.numpy() for a in tout[:6])


@pytest.mark.parametrize("depth", [3, 5])
def test_plain_tree_matches_pallas_interpreted(depth):
    inp = _tree_inputs(depth, 2, 64, depth)
    (jq, jl0, jlp, ja, jn, jalive), (tq, tl0, tlp, ta, tn, talive) = _both_trees(inp, depth)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(talive, jalive)
    np.testing.assert_allclose(tq, jq, rtol=Q_TOL, atol=Q_TOL)
    np.testing.assert_allclose(tl0, jl0, rtol=LOGP_TOL, atol=LOGP_TOL)
    np.testing.assert_allclose(tlp, jlp, rtol=LOGP_TOL, atol=LOGP_TOL)
    np.testing.assert_allclose(ta, ja, rtol=ALPHA_RTOL, atol=1e-6)
    assert tn.min() >= 1 and tn.max() <= (1 << depth) - 1
    assert np.any(tn > 1) and np.any(talive == 0)  # trees of several sizes


def test_huge_step_diverges_at_the_first_leaf():
    """At eps = 50 every first leaf leaves the prior box and diverges: the
    proposal stays at the start, one leaf, no acceptance, no cap cut
    (cf. tests/test_pallas_nuts.py:152-169)."""
    inp = _tree_inputs(7, 2, 32, 4, eps_scale=500.0)
    (jq, jl0, jlp, ja, jn, jalive), (tq, tl0, tlp, ta, tn, talive) = _both_trees(inp, 4)
    np.testing.assert_array_equal(tq, inp["q0"])
    np.testing.assert_array_equal(tlp, tl0)
    np.testing.assert_array_equal(tn, np.ones_like(tn))
    np.testing.assert_array_equal(ta, np.zeros_like(ta))
    np.testing.assert_array_equal(talive, np.zeros_like(talive))
    for a, b in ((tq, jq), (tlp, jlp), (ta, ja), (tn, jn), (talive, jalive)):
        np.testing.assert_allclose(a, b, rtol=Q_TOL, atol=Q_TOL)


def _configs(t, c, depth, burn=100):
    kw = dict(ndim=D, ntemps=t, nchains=c, groups=((0, 1),), burn=burn, nuts_max_depth=depth)
    jumps = dict(NUTSweight=1, SCAMweight=0, AMweight=0, DEweight=0, have_grads=True)
    jc = j_config.SamplerConfig(jumps=j_config.build_default_jumps(**jumps), **kw)
    tc = t_config.SamplerConfig(jumps=t_config.build_default_jumps(**jumps), **kw)
    return jc, tc


def _jax_draws(keys, depth):
    """make_nuts_pallas's draws (nuts_pallas.py:454-487), in the port's
    layouts: r0, expo, dirs, accu, resu and the step-size search's momenta."""
    t, c = keys.shape
    kk = jax.vmap(lambda k: tuple(jax.random.split(k, 6)))(keys.reshape(t * c))
    k_eps, k_mom, k_slice, k_dir, k_acc, k_res = kk
    normal = jax.vmap(lambda k: jax.random.normal(k, (D,), dtype=jnp.float32))
    uniform = jax.vmap(lambda k: jax.random.uniform(k, (depth,), dtype=jnp.float32))
    resu = jnp.concatenate([
        jax.vmap(lambda k, j=j: jax.random.uniform(
            jax.random.fold_in(k, j), (1 << j,), dtype=jnp.float32))(k_res)
        for j in range(depth)
    ], axis=-1)
    draws = dict(
        r0=_to_tdc(normal(k_mom), t, c),
        expo=np.asarray(jax.vmap(lambda k: jax.random.exponential(k, dtype=jnp.float32))(
            k_slice)).reshape(t, c),
        dirs=np.where(_to_ktc(uniform(k_dir), t, c) < 0.5, -1.0, 1.0).astype(np.float32),
        accu=_to_ktc(uniform(k_acc), t, c),
        resu=_to_ktc(resu, t, c),
        r_eps=_to_tdc(normal(k_eps), t, c),
    )
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in draws.items()}


def _ss(t, c, first_call):
    vals = dict(epsilon=0.2, epsilonbar=0.18, hbar=0.02, mu=np.log(2.0), ncalls=4.0)
    if first_call:
        vals.update(epsilon=-1.0, epsilonbar=1.0, hbar=0.0, mu=0.0, ncalls=0.0)
    ss = {k: np.full((t, c), v, np.float32) for k, v in vals.items()}
    ss["epsilon"][1, ::3] *= 1.7  # chains of one rung at different step sizes
    return ss


def _compare_calls(jc, tc, x_tdc, betas, chol, chol_inv, ss, it, seed):
    t, _, c = x_tdc.shape
    depth = tc.nuts_max_depth
    keys = split_grid(jax.random.key(seed), (t, c))
    jctx = JCtx(group_u=None, group_s=None, chol=jnp.asarray(chol),
                chol_inv=jnp.asarray(chol_inv), de_buf=None, de_valid=None)
    tctx = TCtx(group_u=None, group_s=None, chol=torch.tensor(chol),
                chol_inv=torch.tensor(chol_inv), de_buf=None, de_valid=0)
    jq, jqxy, jss = make_nuts_pallas(jc, _func_grad, interpret=True)(
        keys, jnp.asarray(np.moveaxis(x_tdc, 1, 2)), jnp.asarray(betas), it, jctx,
        {k: jnp.asarray(v) for k, v in ss.items()},
    )
    dr = _jax_draws(keys, depth)
    tq, tqxy, tss = t_nuts.make_nuts(tc, TCurved()).core(
        torch.tensor(x_tdc), torch.tensor(betas), it, tctx,
        {k: torch.tensor(v) for k, v in ss.items()},
        dr["r0"], dr["expo"], dr["dirs"], dr["accu"], dr["resu"], dr["r_eps"],
    )
    np.testing.assert_allclose(tq.numpy(), np.moveaxis(np.asarray(jq), 2, 1), rtol=Q_TOL,
                               atol=Q_TOL)
    jqxy = np.asarray(jqxy)
    np.testing.assert_array_equal(np.isneginf(tqxy.numpy()), np.isneginf(jqxy))
    fin = np.isfinite(jqxy)
    np.testing.assert_allclose(tqxy.numpy()[fin], jqxy[fin], rtol=LOGP_TOL, atol=LOGP_TOL)
    for k in SS_NUTS:
        np.testing.assert_allclose(tss[k].numpy(), np.asarray(jss[k]), rtol=SS_RTOL,
                                   atol=SS_ATOL, err_msg=k)
    return tss


@pytest.mark.parametrize("it,first_call", [(5, True), (5, False), (200, False)])
def test_nuts_core_matches_make_nuts_pallas(it, first_call):
    """First call (epsilon = -1: find_reasonable_epsilon runs on the k_eps
    draws), in burn-in (dual averaging moves) and after it (frozen)."""
    t, c, depth = 2, 32, 5
    jc, tc = _configs(t, c, depth)
    inp = _tree_inputs(11, t, c, depth)
    x = np.einsum("ki,tkc->tic", inp["chol"], inp["q0"]).astype(np.float32)
    ss = _ss(t, c, first_call)
    tss = _compare_calls(jc, tc, x, inp["beta"], inp["chol"],
                         np.linalg.inv(inp["chol"]).astype(np.float32), ss, it, seed=it)
    if first_call:
        assert (tss["epsilon"] > 0).all()
    if it > jc.burn:
        np.testing.assert_array_equal(tss["epsilon"].numpy(), ss["epsilonbar"])


def _flatten(jstate):
    flat = jax.tree_util.tree_flatten_with_path(jstate)[0]
    return {_path_name(p): np.asarray(leaf) for p, leaf in flat if _path_name(p) != "key"}


def test_jax_state_after_nuts_carries_into_the_port():
    """A JAX sampler state after a few NUTS iterations (step sizes set and
    adapted) loads into the port; the next NUTS call then agrees."""
    t, c, depth = 2, 16, 4
    jc, tc = _configs(t, c, depth, burn=50)
    model = JCurved()
    step, _ = j_build_step(jc, model.lnlikefn, model.lnpriorfn, _func_grad)
    xs = jnp.broadcast_to(jnp.asarray([-0.1, -0.5], jnp.float32), (t, c, D))
    st = j_state.init_state(jc, jax.random.key(0), np.array([-0.1, -0.5]), np.eye(D),
                            np.array([1.0, 0.5]), jax.vmap(jax.vmap(model.lnlikefn))(xs),
                            jax.vmap(jax.vmap(model.lnpriorfn))(xs))
    step = jax.jit(step)
    for _ in range(3):
        st = step(st)
    arrays = _flatten(st)
    assert (arrays["stepsize/epsilon"] > 0).all() and (arrays["stepsize/ncalls"] == 3).all()
    tst = t_state.state_from_numpy(arrays, tc, device="cpu")
    ctx = make_context(tst)
    ss = {k: arrays[f"stepsize/{k}"] for k in SS_NUTS}
    _compare_calls(jc, tc, tst.x.numpy(), tst.betas.numpy(), ctx.chol.numpy(),
                   ctx.chol_inv.numpy(), ss, tst.it + 1, seed=21)


def test_underflowed_step_size_is_searched_again():
    """A lane whose dual-averaged step size underflows to 0 is searched again
    at its next NUTS call, as make_nuts_pallas searches every lane with
    epsilon <= 0 at every call (nuts_pallas.py:497-515).

    Lanes with mu = -110 (a tiny step size found long ago) underflow in the
    first call of the drawing wrapper; its second call searches them, so
    every lane leaves with epsilon > 0 and the searched lanes restart dual
    averaging at mu = log(10 * epsilon), epsilon a power of two. Fed that
    state, the port's core and make_nuts_pallas agree."""
    t, c, depth = 2, 32, 4
    jc, tc = _configs(t, c, depth)
    inp = _tree_inputs(13, t, c, depth)
    chol = inp["chol"]
    chol_inv = np.linalg.inv(chol).astype(np.float32)
    x = np.einsum("ki,tkc->tic", chol, inp["q0"]).astype(np.float32)
    ss = _ss(t, c, first_call=False)
    low = np.zeros((t, c), bool)
    low[:, ::3] = True
    ss["mu"][low] = -110.0
    ctx = TCtx(group_u=None, group_s=None, chol=torch.tensor(chol),
               chol_inv=torch.tensor(chol_inv), de_buf=None, de_valid=0)
    nuts = t_nuts.make_nuts(tc, TCurved())
    rng = torch.Generator().manual_seed(3)
    betas = torch.tensor(inp["beta"])
    q1, _, ss1 = nuts(rng, torch.tensor(x), betas, 5, ctx,
                      {k: torch.tensor(v) for k, v in ss.items()})
    eps1 = ss1["epsilon"].numpy()
    assert (eps1[low] == 0).all() and (eps1[~low] > 0).all()

    _, _, ss2 = nuts(rng, q1, betas, 6, ctx, ss1)
    eps2, mu2 = ss2["epsilon"].numpy(), ss2["mu"].numpy()
    assert (eps2 > 0).all()
    np.testing.assert_array_equal(mu2[~low], ss1["mu"].numpy()[~low])
    _assert_searched(mu2[low])

    state = {k: v.numpy() for k, v in ss1.items()}
    tss = _compare_calls(jc, tc, q1.numpy(), inp["beta"], chol, chol_inv, state, 6, seed=31)
    assert (tss["epsilon"].numpy() > 0).all()
    _assert_searched(tss["mu"].numpy()[low])


def _assert_searched(mu):
    """mu = log(10 * epsilon) with epsilon a power of two, as the search
    returns."""
    found = np.log2(np.exp(mu.astype(np.float64)) / 10.0)
    np.testing.assert_allclose(found, np.round(found), atol=1e-5)
