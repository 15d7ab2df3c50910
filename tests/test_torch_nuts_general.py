"""The NUTS tree past depth 10, with a forced length and the capture (the
plain twin of the tree kernel's general entry) against the JAX package.

* The plain tree at depth 11 against the Pallas tree kernel run by the
  interpreter, its unroll cap raised to 11 for the test (a monkeypatch of
  ``nuts_pallas.MAX_UNROLL_DEPTH``; the kernel's code is unchanged).
* ``nuts_force_trajlen``: the leaf counts of the JAX package's XLA tree
  (its capture's lengths) equal the plain tree's, which are deterministic;
  a sampler run with a forced length against the JAX sampler's moments.
* The capture of lane (T0, C0) against a leapfrog replay of the plain tree;
  the capture and the general path change no output.
* The reservoir's Philox rows past 1023 against an independent Philox.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptmcmcsampler_torch import config as t_config
from ptmcmcsampler_torch.kernel import build_step as t_build_step
from ptmcmcsampler_torch.models import CurvedLikelihood as TCurved
from ptmcmcsampler_torch.ops import common
from ptmcmcsampler_torch.ops.nuts import nuts_trees, nuts_uniforms
from ptmcmcsampler_torch.state import init_state as t_init_state
from ptmcmcsampler_torch.trajectory import empty_capture
from ptmcmcsampler_tpu import config as j_config
from ptmcmcsampler_tpu.kernel import build_step as j_build_step
from ptmcmcsampler_tpu.ops import nuts_pallas
from ptmcmcsampler_tpu.proposals import nuts as j_nuts
from ptmcmcsampler_tpu.proposals.base import ProposalContext as JCtx
from ptmcmcsampler_tpu.state import init_state as j_init_state
from test_torch_nuts import ALPHA_RTOL, LOGP_TOL, Q_TOL, _both_trees, _func_grad, _tree_inputs

torch.set_num_threads(2)

D = 2


def _cfg(depth, **kw):
    return t_config.SamplerConfig(ndim=D, ntemps=1, nchains=1, groups=((0, 1),),
                                  jumps=t_config.build_default_jumps(), nuts_max_depth=depth,
                                  **kw)


def _torch_inputs(inp):
    return [torch.tensor(inp[k]) for k in ("q0", "r0", "beta", "eps", "expo", "dirs", "accu",
                                           "resu", "chol")]


def test_plain_tree_at_depth_11_matches_pallas_interpreted(monkeypatch):
    """Depth 11 (2047 leaves) on small step sizes, so that trees reach the
    cap: the leaf counts and cap cuts equal, the values within the depth
    <= 10 tests' tolerances."""
    monkeypatch.setattr(nuts_pallas, "MAX_UNROLL_DEPTH", 11)
    inp = _tree_inputs(11, 1, 8, 11, eps_scale=0.001)
    (jq, jl0, jlp, ja, jn, jalive), (tq, tl0, tlp, ta, tn, talive) = _both_trees(inp, 11)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(talive, jalive)
    np.testing.assert_allclose(tq, jq, rtol=Q_TOL, atol=Q_TOL)
    np.testing.assert_allclose(tl0, jl0, rtol=LOGP_TOL, atol=LOGP_TOL)
    np.testing.assert_allclose(tlp, jlp, rtol=LOGP_TOL, atol=LOGP_TOL)
    np.testing.assert_allclose(ta, ja, rtol=ALPHA_RTOL, atol=1e-6)
    assert tn.max() == 2047 and talive.max() == 1  # the cap cut some trees
    assert tn.max() > 1023  # past the default entries' depth


@pytest.mark.parametrize("depth", [4, 10])
def test_general_path_changes_no_output(depth):
    """The capture only observes, and the general path (forced by
    ``general=True``) computes the default one's function: every output
    equal, bit for bit."""
    inp = _tree_inputs(depth, 2, 16, depth)
    args = _torch_inputs(inp)
    base = nuts_trees(*args, TCurved())
    cap = empty_capture(_cfg(depth), "cpu")
    for out in (nuts_trees(*args, TCurved(), general=True),
                nuts_trees(*args, TCurved(), capture=cap)):
        for a, b in zip(out, base):
            assert torch.equal(a, b)
    assert int(cap.meta[3]) == 1


def _jax_leaves(depth, trajlen, seeds, eps):
    """Leaf counts of the JAX package's XLA tree with a forced length: its
    capture's two lengths less the start."""
    jc = j_config.SamplerConfig(ndim=D, ntemps=1, nchains=1, groups=((0, 1),),
                                jumps=j_config.build_default_jumps(), nuts_max_depth=depth,
                                nuts_force_trajlen=trajlen, nuts_force_epsilon=eps)
    nuts = j_nuts.make_nuts(jc, _func_grad, capture=True)
    chol = jnp.eye(D)
    ctx = JCtx(group_u=(), group_s=(), chol=chol, chol_inv=chol, de_buf=jnp.zeros((D, 2)),
               de_valid=0)
    ss = {k: jnp.asarray(v, jnp.float32) for k, v in dict(
        epsilon=eps, epsilonbar=eps, hbar=0.0, mu=0.0, ncalls=1.0).items()}
    ss.update({k: jnp.zeros(()) for k in ("chees_eps", "chees_epsbar", "chees_hbar", "chees_mu",
                                          "chees_count", "chees_m", "chees_v", "chees_tlen")})
    run = jax.jit(jax.vmap(lambda k: nuts(k, jnp.array([-0.1, -0.5]), 1.0, 1, ctx, ss)[3]))
    cap = run(jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds)))
    return np.asarray(cap["len_plus"]) + np.asarray(cap["len_minus"]) - 1


@pytest.mark.parametrize("trajlen", [1, 6, 37, 100])
def test_force_trajlen_leaf_counts_match_jax_xla(trajlen):
    """With a forced length the leaf count depends on L alone where no leaf
    diverges: the JAX XLA tree's counts equal the plain tree's nalpha (and
    the capture's lengths), at depth 8 and at a step size that keeps the
    curved target's trajectories bounded."""
    depth, eps = 8, 0.01
    jl = _jax_leaves(depth, trajlen, np.arange(6), eps)
    inp = _tree_inputs(3, 1, 6, depth)
    inp["eps"] = np.full_like(inp["eps"], eps)
    cap = empty_capture(_cfg(depth), "cpu")
    out = nuts_trees(*_torch_inputs(inp), TCurved(), force_trajlen=trajlen, capture=cap)
    np.testing.assert_array_equal(out[4].numpy()[0], jl.astype(np.float32))
    assert int(cap.meta[0] + cap.meta[1]) - 1 == jl[0]
    assert np.all(out[5].numpy() == 0)  # the forced length, not the cap, ended the trees


def _curved_state(cfg, model, t_seed=0):
    x0 = np.array([-0.1, -0.5])
    xs = torch.tensor(x0, dtype=torch.float32)[None, :, None].expand(cfg.ntemps, D, cfg.nchains)
    return t_init_state(cfg, t_seed, x0, np.eye(D), np.ones(cfg.ntemps), model.lnlike(xs),
                        model.lnprior(xs), device="cpu")


def test_force_trajlen_sampler_moments_match_jax():
    """NUTS alone with a forced length of 12 leaves at depth 12 on the
    curved target: the port's cold-chain moments against the JAX
    sampler's (its XLA tree), within their Monte Carlo errors."""
    c, rows = 48, 200
    kw = dict(ndim=D, ntemps=1, nchains=c, groups=((0, 1),), tskip=1000, cov_update=10**6,
              burn=100, thin=1, de_size=64, nuts_max_depth=12, nuts_force_trajlen=12)
    jumps = dict(NUTSweight=1, SCAMweight=0, AMweight=0, DEweight=0, have_grads=True)
    tcfg = t_config.SamplerConfig(jumps=t_config.build_default_jumps(**jumps), **kw)
    jcfg = j_config.SamplerConfig(jumps=j_config.build_default_jumps(**jumps), **kw)
    model = TCurved()
    _, run_block = t_build_step(tcfg, model, device="cpu")
    state, _ = run_block(_curved_state(tcfg, model), 100)
    state, out = run_block(state, rows)
    tx = out.x[:, 0].movedim(1, 2).reshape(-1, D).numpy()
    from ptmcmcsampler_tpu.models import CurvedLikelihood as JCurved

    jm = JCurved()
    _, jrun = j_build_step(jcfg, jm.lnlikefn, jm.lnpriorfn, _func_grad)
    xs = jnp.broadcast_to(jnp.array([-0.1, -0.5]), (1, c, D))
    ll0, lp0 = (jax.vmap(jax.vmap(f))(xs) for f in (jm.lnlikefn, jm.lnpriorfn))
    js = j_init_state(jcfg, jax.random.PRNGKey(1), np.array([-0.1, -0.5]), np.eye(D),
                      np.ones(1), ll0, lp0)
    js, _ = jrun(js, 100)
    js, jout = jrun(js, rows)
    jx = np.moveaxis(np.asarray(jout.x[:, 0]), 1, 2).reshape(-1, D)
    # Each chain's rows: the spread of the chain means gives the error.
    se = np.hypot(*(a.reshape(rows, c, D).mean(0).std(0) / np.sqrt(c) for a in (tx, jx)))
    assert np.all(np.abs(tx.mean(0) - jx.mean(0)) < 5 * se + 0.02), (tx.mean(0), jx.mean(0))
    np.testing.assert_allclose(tx.std(0), jx.std(0), rtol=0.15)


def _philox_np(c0, c1, k0, k1):
    """Word 0 of Philox4x32-10 at counter (c0, c1, 0, 0) and key (k0, k1),
    in numpy's uint64 arithmetic (Salmon et al., SC'11)."""
    m0, m1, w0, w1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
    mask = (1 << 32) - 1
    x = [int(c0), int(c1), 0, 0]
    for i in range(10):
        if i:
            k0, k1 = (k0 + w0) & mask, (k1 + w1) & mask
        p0, p1 = m0 * x[0], m1 * x[2]
        x = [(p1 >> 32) ^ x[1] ^ k0, p1 & mask, (p0 >> 32) ^ x[3] ^ k1, p0 & mask]
    return x[0]


def test_reservoir_uniforms_past_row_1023():
    """At depth 12 the rows run to 4094: each (row, chain) takes its own
    counter, so the rows' uniforms equal an independent Philox's, the
    first 1023 rows are the depth-10 array, and no two rows of a chain
    repeat one another."""
    key = torch.tensor([0x01234567, 0x89ABCDEF], dtype=torch.int64)
    t, c = 2, 3
    u12 = nuts_uniforms(key, 12, t, c)
    assert u12.shape == (4095, t, c)
    assert torch.equal(u12[:1023], nuts_uniforms(key, 10, t, c))
    for row in (1023, 2047, 3000, 4094):
        for n in range(t * c):
            want = (_philox_np(row, n, 0x01234567, 0x89ABCDEF) >> 8) * 2.0**-24
            assert u12[row].reshape(-1)[n].item() == np.float32(want)
    flat = u12.reshape(4095, -1)
    for n in range(t * c):
        assert len(torch.unique(flat[:, n])) > 4000  # 24-bit uniforms: few chance ties
    assert not torch.equal(flat[1023:2046], flat[:1023])


def test_capture_is_the_leapfrog_path_the_tree_took():
    """Lane (T0, C0)'s capture replayed: the plus branch is the start and
    the leapfrog steps of +eps from (z0, r0), the minus branch those of
    -eps, their indices the leaves' order, and the proposal is the row of
    the chosen index."""
    depth = 6
    inp = _tree_inputs(5, 1, 4, depth)
    args = _torch_inputs(inp)
    cap = empty_capture(_cfg(depth), "cpu")
    model = TCurved()
    out = nuts_trees(*args, model, capture=cap)
    lp, lm, used, active = cap.meta.tolist()
    assert active == 1 and lp >= 1 and lp + lm == int(out[4][0, 0]) + 1
    chol = args[-1]
    fgw = common.whitened(model, chol, args[2][:1, None])
    eps = float(args[3][0, 0])
    z0, r0 = args[0][:1, :, :1], args[1][:1, :, :1]
    for rows, inds, n, sign in ((cap.plus, cap.ind_plus, lp, 1.0),
                                (cap.minus, cap.ind_minus, lm, -1.0)):
        z, r = z0, r0
        _, g = fgw(z)
        skip = 1 if sign > 0 else 0  # the start heads the plus branch
        for i in range(skip, n):
            rh = r + 0.5 * sign * eps * g
            z = z + sign * eps * rh
            _, g = fgw(z)
            r = rh + 0.5 * sign * eps * g
            torch.testing.assert_close(rows[i], z[0, :, 0], rtol=1e-6, atol=1e-6)
        assert torch.all(rows[n:] == 0) and torch.all(inds[n:] == 0)
    inds = torch.cat([cap.ind_plus[:lp], cap.ind_minus[:lm]])
    assert sorted(inds.tolist()) == list(range(lp + lm))
    assert int(cap.ind_plus[0]) == 0 and torch.equal(cap.plus[0], args[0][0, :, 0])
    rows = torch.cat([cap.plus[:lp], cap.minus[:lm]])
    torch.testing.assert_close(rows[int((inds == used).nonzero()[0, 0])], out[0][0, :, 0],
                               rtol=0, atol=0)


def test_depth_31_raises():
    with pytest.raises(ValueError, match="int32"):
        _cfg(31)
    _cfg(30)
    dirs = torch.ones((31, 1, 2))
    with pytest.raises(ValueError, match="depth 31"):
        nuts_trees(torch.zeros((1, 2, 2)), torch.zeros((1, 2, 2)), torch.ones(1),
                   torch.ones((1, 2)), torch.ones((1, 2)), dirs, dirs, torch.ones((1, 1, 2)),
                   torch.eye(2), TCurved())
