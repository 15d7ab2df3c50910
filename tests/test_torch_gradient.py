"""PyTorch port vs the JAX package: the MALA proposal and the batched NUTS
step-size search.

* ``make_mala``'s core against the JAX ``gradient.make_mala``, fed the same
  axis and normal draw, replayed from its key splits (gradient.py:64-79).
* ``find_reasonable_epsilon`` over the whole ``[T, C]`` batch against the
  JAX per-chain search vmapped, given the same momenta. Its results are
  0.5 times powers of two, so they must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptmcmcsampler_torch import config as t_config
from ptmcmcsampler_torch.models import CurvedLikelihood as TCurved
from ptmcmcsampler_torch.proposals import gradient as t_gradient
from ptmcmcsampler_torch.proposals.base import ProposalContext as TCtx
from ptmcmcsampler_tpu import config as j_config
from ptmcmcsampler_tpu.models import CurvedLikelihood as JCurved
from ptmcmcsampler_tpu.proposals import gradient as j_gradient
from ptmcmcsampler_tpu.proposals.base import ProposalContext as JCtx
from ptmcmcsampler_tpu.utils import split_grid

torch.set_num_threads(2)

T, C, D = 3, 40, 2
Q_TOL, QXY_TOL = 2e-4, 2e-3


def _func_grad(x, beta):
    m = JCurved()
    ll, gll = m.lnlikefn_grad(x)
    lp, glp = m.lnpriorfn_grad(x)
    return beta * ll + lp, beta * gll + glp


def _setup(seed):
    rng = np.random.default_rng(seed)
    mode = np.where(rng.random((T, 1, C)) < 0.5, -1.0, 2.0)
    x = 0.3 * rng.normal(size=(T, D, C))
    x[:, 1:] += mode
    x[0, :, 5] = [9.99, 0.5]  # at the edge of the prior box
    x[1, :, 7] = [3.0, -9.5]  # far out on the ridge's flank
    x = x.astype(np.float32)
    chol = np.linalg.cholesky(np.array([[0.5, 0.1], [0.1, 0.3]])).astype(np.float32)
    chol_inv = np.linalg.inv(chol).astype(np.float32)
    betas = np.array([1.0, 0.4, 0.05], np.float32)
    jctx = JCtx(group_u=None, group_s=None, chol=jnp.asarray(chol), chol_inv=jnp.asarray(chol_inv),
                de_buf=None, de_valid=None)
    tctx = TCtx(group_u=None, group_s=None, chol=torch.tensor(chol),
                chol_inv=torch.tensor(chol_inv), de_buf=None, de_valid=0)
    return x, betas, jctx, tctx


def _configs():
    kw = dict(ndim=D, ntemps=T, nchains=C, groups=((0, 1),))
    return (
        j_config.SamplerConfig(jumps=j_config.build_default_jumps(MALAweight=1, have_grads=True),
                               **kw),
        t_config.SamplerConfig(jumps=t_config.build_default_jumps(MALAweight=1, have_grads=True),
                               **kw),
    )


def test_mala_core_matches_make_mala():
    x, betas, jctx, tctx = _setup(0)
    jc, tc = _configs()
    keys = split_grid(jax.random.key(4), (T, C))
    mala = j_gradient.make_mala(jc, _func_grad)
    per_chain = jax.vmap(lambda k, xx, b: mala(k, xx, b, 0, jctx), in_axes=(0, -1, None),
                         out_axes=(-1, 0))
    jq, jqxy = jax.vmap(per_chain)(keys, jnp.asarray(x), jnp.asarray(betas))
    # The JAX draws, replayed: ki, kd = split(key); i = randint(ki, (), 0, D),
    # dist = normal(kd).
    ks = jax.vmap(jax.vmap(jax.random.split))(keys)
    ind = jax.vmap(jax.vmap(lambda k: jax.random.randint(k, (), 0, D)))(ks[:, :, 0])
    dist = jax.vmap(jax.vmap(lambda k: jax.random.normal(k, dtype=jnp.float32)))(ks[:, :, 1])
    tq, tqxy = t_gradient.make_mala(tc, TCurved()).core(
        torch.tensor(x), torch.tensor(betas), tctx, torch.tensor(np.asarray(ind, np.int64)),
        torch.tensor(np.asarray(dist)),
    )
    assert tq.shape == (T, D, C) and tqxy.shape == (T, C)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=Q_TOL, atol=Q_TOL)
    jqxy = np.asarray(jqxy)
    np.testing.assert_array_equal(np.isneginf(tqxy.numpy()), np.isneginf(jqxy))
    fin = np.isfinite(jqxy)
    np.testing.assert_allclose(tqxy.numpy()[fin], jqxy[fin], rtol=QXY_TOL, atol=QXY_TOL)


@pytest.mark.parametrize("seed", [1, 2])
def test_batched_find_reasonable_epsilon_equals_jax(seed):
    x, betas, jctx, tctx = _setup(seed)
    keys = split_grid(jax.random.key(seed), (T, C))
    jforward, _, jfgw = j_gradient.make_whitened_funcs(_func_grad)

    def one(k, xx, b):
        q = jforward(jctx, xx)
        logp0, grad0 = jfgw(jctx, q, b)
        return j_gradient.find_reasonable_epsilon(k, jfgw, jctx, b, q, grad0, logp0)

    jeps = jax.vmap(jax.vmap(one, in_axes=(0, -1, None)))(keys, jnp.asarray(x), jnp.asarray(betas))
    # Its momenta, replayed: normal(key, theta0.shape).
    r0 = jax.vmap(jax.vmap(lambda k: jax.random.normal(k, (D,), dtype=jnp.float32),
                           out_axes=-1))(keys)

    tforward, _, tfgw = t_gradient.make_whitened_funcs(TCurved().value_grad)
    q0 = tforward(tctx, torch.tensor(x))
    logp0, grad0 = tfgw(tctx, q0, torch.tensor(betas)[:, None])
    teps = t_gradient.find_reasonable_epsilon(tfgw, tctx, torch.tensor(betas), q0, grad0, logp0,
                                              torch.tensor(np.asarray(r0)))
    np.testing.assert_array_equal(teps.numpy(), np.asarray(jeps))
    assert len(np.unique(teps.numpy())) > 2  # lanes ended at different step sizes
