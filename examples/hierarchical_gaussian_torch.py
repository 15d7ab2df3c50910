#!/usr/bin/env python
"""50-D hierarchical Gaussian with a weighted jump cycle mixing SCAM/AM/DE,
a custom Gaussian jump, and a prior-draw (independence) jump — BASELINE.json
config 4 — on the PyTorch port (``ptmcmcsampler_torch``), the twin of
``hierarchical_gaussian.py``. The posterior is linear-Gaussian, so the
script checks the sampled moments against the closed form.

Run from the repository root, with the package installed (``pip install
-e .``) or ``PYTHONPATH=.``: python examples/hierarchical_gaussian_torch.py
[--device cpu] (the CUDA card by default; on the CPU, fewer chains or
iterations keep the run short: --nchains 32 --niter 6000).
"""

import argparse
from pathlib import Path

import numpy as np
import torch

from ptmcmcsampler_torch import PTSampler
from ptmcmcsampler_torch.models import HierarchicalGaussian

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda")
parser.add_argument("--nchains", type=int, default=128)
parser.add_argument("--niter", type=int, default=20000)
args = parser.parse_args()

model = HierarchicalGaussian()  # mu + 49 group effects
ndim = model.ndim

sampler = PTSampler(
    ndim,
    model.lnlikefn,
    model.lnpriorfn,
    np.eye(ndim) * 0.05,
    outDir=str(Path(__file__).parent / "chains_hierarchical_torch"),
    ntemps=2,
    nchains=args.nchains,
    seed=42,
    device=args.device,
)


def small_gauss_jump(rng, x, it, beta):
    """Custom jump, torch-native protocol (rng, x, iter, beta) -> (q, lqxy):
    ``rng`` is the sampler's generator on the device."""
    return x + 0.05 * torch.randn(x.shape, generator=rng, device=x.device), x.new_zeros(())


sampler.addProposalToCycle(small_gauss_jump, 5, name="SmallGauss")
sampler.addPriorDrawToCycle(model.draw_prior, 2)

sampler.sample(
    np.zeros(ndim), args.niter, burn=2000, thin=2, isave=2000, covUpdate=500,
    SCAMweight=20, AMweight=20, DEweight=20,
    NUTSweight=0, HMCweight=0, MALAweight=0, Tskip=100,
)

mean, cov = model.posterior_moments()
post = sampler.chains[:, 2000 // 2 :, :].reshape(-1, ndim)
err = np.abs(post.mean(axis=0) - mean) / np.sqrt(np.diag(cov))
print("\nmax |mean error| / posterior sd:", float(err.max()))
print("sd ratio (sampled/analytic):",
      float((post.std(axis=0) / np.sqrt(np.diag(cov))).mean()))
