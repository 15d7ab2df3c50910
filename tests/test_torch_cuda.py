"""The port on a CUDA card: the ChEES kernel against its plain version, the
wrapper's refusals, and the main path's launches.

Tests that need a card take the ``cuda`` fixture, which skips them where
there is none. This file imports no JAX, so on a machine with a card and
without JAX it runs alone with
``python -m pytest --noconftest tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from ptmcmcsampler_torch import SamplerConfig, build_default_jumps, build_step, init_state
from ptmcmcsampler_torch.config import KIND_CHEES
from ptmcmcsampler_torch.models import CurvedLikelihood
from ptmcmcsampler_torch.ops.chees import chees_trajectories, chees_trajectories_plain

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _inputs(dev, t=2, c=1000, max_nsteps=16, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = 0.3 * torch.randn((t, 2, c), generator=gen, device=dev)
    x[:, 1] -= 1.0
    chol = torch.tensor([[0.7, 0.0], [0.2, 0.9]], device=dev)
    q0 = (torch.linalg.inv(chol).T @ x).contiguous()
    p0 = torch.randn((t, 2, c), generator=gen, device=dev)
    betas = torch.tensor([1.0, 0.25], device=dev)[:t]
    eps = torch.full((t, c), 0.03, device=dev)
    nsteps = torch.randint(1, max_nsteps + 1, (t, c), generator=gen, device=dev,
                           dtype=torch.int32)
    return q0, p0, betas, eps, nsteps, chol


def test_kernel_matches_plain(cuda):
    args = _inputs(cuda)
    before = chees_trajectories.launches
    q1, p1, lp1 = chees_trajectories(*args, CurvedLikelihood())
    assert chees_trajectories.launches == before + 1
    q1p, p1p, lp1p = chees_trajectories_plain(*args, CurvedLikelihood())
    torch.testing.assert_close(q1, q1p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(p1, p1p, rtol=1e-4, atol=1e-4)
    assert torch.equal(torch.isneginf(lp1), torch.isneginf(lp1p))


def test_wrapper_raises_for_model_without_functor(cuda):
    class NoFunctor(CurvedLikelihood):
        cuda_functor = None

    with pytest.raises(NotImplementedError, match="NoFunctor"):
        chees_trajectories(*_inputs(cuda), NoFunctor())


def test_wrapper_rejects_bad_layout(cuda):
    q0, p0, betas, eps, nsteps, chol = _inputs(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        chees_trajectories(q0, p0, betas, eps, nsteps, chol.T, CurvedLikelihood())
    with pytest.raises(ValueError, match="nsteps"):
        chees_trajectories(q0, p0, betas, eps, nsteps.long(), chol, CurvedLikelihood())


def test_wrapper_rejects_other_devices():
    meta = [torch.empty((2, 2, 4), device="meta")] * 2
    with pytest.raises(ValueError, match="unsupported device"):
        chees_trajectories(*meta, None, None, None, None, CurvedLikelihood())


def _small_config():
    return SamplerConfig(
        ndim=2, ntemps=2, nchains=64, groups=((0, 1),),
        jumps=build_default_jumps(SCAMweight=10, AMweight=10, DEweight=10, CHEESweight=20,
                                  burn=20, have_grads=True),
        tskip=5, cov_update=25, burn=20, thin=1, de_size=100, hmc_stepsize=0.08,
    )


def test_build_step_defaults_to_the_card():
    cfg = _small_config()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_step(cfg, CurvedLikelihood())
        return
    step, _ = build_step(cfg, CurvedLikelihood())
    x0 = np.array([-0.1, -0.5])
    state = init_state(cfg, 0, x0, np.eye(2), np.array([1.0, 0.5]), np.zeros((2, 64)),
                       np.zeros((2, 64)))
    assert state.x.is_cuda
    assert step(state).x.is_cuda


def test_main_path_launches_kernel_each_chees_iteration(cuda):
    cfg = _small_config()
    model = CurvedLikelihood()
    _, run_block = build_step(cfg, model, device=cuda)
    x0 = np.array([-0.1, -0.5])
    xs = torch.tensor(x0, dtype=torch.float32, device=cuda)[None, :, None].expand(2, 2, 64)
    state = init_state(cfg, 1, x0, np.eye(2), np.array([1.0, 0.5]), model.lnlike(xs),
                       model.lnprior(xs), device=cuda)
    chees_trajectories.launches = 0
    state, out = run_block(state, 60)
    j = [s.kind for s in cfg.jumps].index(KIND_CHEES)
    assert chees_trajectories.launches == int(state.counters.jump_proposed[j, 0, 0]) > 0
    assert torch.isfinite(out.x).all()
