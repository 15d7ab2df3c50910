"""``PTSampler`` on the wide models, on the CPU: the bound methods of the
50-D ``HierarchicalGaussian`` take the kernel route and run SCAM/AM/DE/ChEES
beside the JAX package's ``PTSampler`` on the same model, both held by the
moment gate; the card's refusal decision (jump weights x functor x device
type); and the port's closed-form and quadrature targets checked as
tests/test_hierarchical.py and tests/test_moment_targets.py check the JAX
package's.
"""

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as the other parity tests)
import numpy as np
import pytest
import torch

from ptmcmcsampler_torch import PTSampler, build_default_jumps
from ptmcmcsampler_torch.diagnostics import moment_gate
from ptmcmcsampler_torch.models import (
    CorrelatedGaussian, CurvedLikelihood, HierarchicalGaussian, IntervalTransformedGaussian,
)
from ptmcmcsampler_torch.sampler import card_refusal
from ptmcmcsampler_tpu import PTSampler as JPTSampler
from ptmcmcsampler_tpu.models import HierarchicalGaussian as JHier

torch.set_num_threads(2)

T, C, NITER, BURN = 2, 32, 1200, 400
ACC_TOL = 0.08
SAMPLE_KW = dict(burn=BURN, Tskip=5, isave=400, covUpdate=200, thin=1, SCAMweight=10,
                 AMweight=10, DEweight=10, CHEESweight=20, NUTSweight=0, HMCweight=0,
                 MALAweight=0, HMCstepsize=0.08)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("wide_pair")
    jm, pm = JHier(), HierarchicalGaussian()
    js = JPTSampler(jm.ndim, jm.lnlikefn, jm.lnpriorfn, np.eye(jm.ndim),
                    logl_grad=jm.lnlikefn_grad, logp_grad=jm.lnpriorfn_grad, ntemps=T,
                    nchains=C, seed=7, outDir=str(root / "jax"), verbose=False)
    js.sample(np.zeros(jm.ndim), NITER, **SAMPLE_KW)
    ps = PTSampler(pm.ndim, pm.lnlikefn, pm.lnpriorfn, np.eye(pm.ndim),
                   logl_grad=pm.lnlikefn_grad, logp_grad=pm.lnpriorfn_grad, ntemps=T,
                   nchains=C, seed=7, outDir=str(root / "port"), verbose=False, device="cpu")
    ps.sample(np.zeros(pm.ndim), NITER, **SAMPLE_KW)
    return js, ps


def test_port_takes_the_kernel_route(pair):
    _, ps = pair
    assert ps.route == "kernel" and ps._model.cuda_functor == "hierarchical_gaussian"
    assert ps.config.jump_names() == pair[0].config.jump_names()


def test_both_pass_the_moment_gate(pair):
    target, _ = HierarchicalGaussian().posterior_moments()
    for s in pair:
        assert s.chains.shape == (C, 1 + NITER, 50)
        ok, max_z, _ = moment_gate(s.chains[:, BURN:], target)
        assert ok, max_z


def test_acceptance_per_jump_matches_jax(pair):
    js, ps = pair
    for name in ps.config.jump_names():
        jr = np.loadtxt(f"{js.outDir}/{name}_jump.txt", ndmin=1)
        pr = np.loadtxt(f"{ps.outDir}/{name}_jump.txt", ndmin=1)
        assert len(pr) == len(jr) and abs(pr[-1] - jr[-1]) < ACC_TOL, (name, pr[-1], jr[-1])


_KINDS = {
    "chees": dict(CHEESweight=20), "nuts": dict(NUTSweight=20), "hmc": dict(HMCweight=20),
    "mala": dict(MALAweight=20), "all": dict(CHEESweight=20, NUTSweight=20, HMCweight=20,
                                             MALAweight=20),
}


@pytest.mark.parametrize("kinds", sorted(_KINDS))
@pytest.mark.parametrize("functor,ndim", [("curved", 2), ("hierarchical_gaussian", 50),
                                          ("interval_gaussian", 40),
                                          ("correlated_gaussian", 200),
                                          ("correlated_gaussian", 300),
                                          ("hierarchical_gaussian", 1024),
                                          ("correlated_gaussian", 1025), (None, 50)])
@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
def test_card_refusal_decision(kinds, functor, ndim, device_type):
    """On the card every kernel kind (ChEES, NUTS, HMC) runs on the curved
    functor and on the wide ones up to D = 1024; a D beyond the wide layout
    (1025) and a model without a functor are refused for any kernel kind;
    MALA, plain PyTorch, runs; the CPU refuses nothing."""
    jumps = build_default_jumps(SCAMweight=10, have_grads=True, **_KINDS[kinds])
    why = card_refusal(device_type, functor, jumps, ndim)
    refused = device_type == "cuda" and (ndim == 1025 or functor is None) and kinds != "mala"
    assert (why is not None) == refused
    if refused:
        assert ("got 1025" if functor else "no CUDA device functor") in why


def test_sample_refuses_before_any_iteration(tmp_path, monkeypatch):
    """The refusal of a model the card's kernels do not take (a 1025-D
    CorrelatedGaussian: the wide layout stops at 1024) is raised when
    sample() starts, naming the D and the CPU, before a state exists or a
    file is written. The device check is made as on the card (the decision
    is the card's; nothing is allocated)."""
    from ptmcmcsampler_torch import sampler as sampler_module

    m = CorrelatedGaussian(ndim=1025)
    s = PTSampler(m.ndim, m.lnlikefn, m.lnpriorfn, np.eye(m.ndim), logl_grad=m.lnlikefn_grad,
                  logp_grad=m.lnpriorfn_grad, ntemps=2, nchains=8, outDir=str(tmp_path),
                  verbose=False, device="cpu")
    real = sampler_module.card_refusal
    monkeypatch.setattr(sampler_module, "card_refusal",
                        lambda _dev, *args: real("cuda", *args))
    with pytest.raises(NotImplementedError, match="got 1025") as e:
        s.sample(np.clip(m.mu, 0.1, 9.9), 100, **SAMPLE_KW)
    assert 'device="cpu"' in str(e.value) and s.state is None
    assert not (tmp_path / "chain_1.0.txt").exists()


def test_hierarchical_analytic_moments_selfcheck():
    """The closed-form posterior satisfies its score equations (mirrors
    tests/test_hierarchical.py:19)."""
    model = HierarchicalGaussian()
    mean, cov = model.posterior_moments()
    assert mean.shape == (50,) and cov.shape == (50, 50)
    b = np.zeros(model.ndim)
    b[1:] = model.y / model.s_y**2
    np.testing.assert_allclose(np.linalg.inv(cov) @ mean, b, atol=1e-8)
    assert np.all(np.abs(mean[1:] - model.y) < 1.0)
    # The gradient of the log posterior vanishes at the mean (to the f32
    # rounding of the data y the model holds for its computations).
    _, g = model.value_grad(torch.tensor(mean, dtype=torch.float64)[:, None], 1.0)
    np.testing.assert_allclose(g[:, 0].numpy(), 0.0, atol=1e-5)


def test_interval_gaussian_moments_vs_mc():
    """Mirrors tests/test_moment_targets.py:50-64 on the port's model."""
    model = IntervalTransformedGaussian(ndim=4)
    mean_q, cov_q = model.posterior_moments()
    rng = np.random.default_rng(1)
    draws = rng.normal(size=4_000_000)
    draws = draws[(draws > 0.0) & (draws < 10.0)]
    p = np.log(draws / (10.0 - draws))
    se = p.std() / np.sqrt(len(p))
    assert abs(p.mean() - mean_q[0]) < 6 * se
    assert abs(p.var() - cov_q[0, 0]) < 0.01
    np.testing.assert_allclose(mean_q, mean_q[0])


def test_interval_gaussian_grid_converged():
    m1, c1 = IntervalTransformedGaussian(ndim=2).posterior_moments(n=500_001)
    m2, c2 = IntervalTransformedGaussian(ndim=2).posterior_moments(n=2_000_001)
    np.testing.assert_allclose(m1, m2, atol=1e-5)
    np.testing.assert_allclose(c1, c2, atol=3e-4)


def test_models_share_the_kernel_route():
    """Each of the four models' bound methods is a kernel-route object."""
    from ptmcmcsampler_torch.sampler import _functor_model

    for m in (CurvedLikelihood(), CorrelatedGaussian(), IntervalTransformedGaussian(),
              HierarchicalGaussian()):
        fns = (m.lnlikefn, m.lnpriorfn, m.lnlikefn_grad, m.lnpriorfn_grad)
        assert _functor_model(fns, (None, None, None, None)) is m
