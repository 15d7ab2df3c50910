#!/usr/bin/env python
"""20-D correlated-Gaussian example, the reference's examples/simple.py
workload, with a custom uniform jump, on the PyTorch port
(``ptmcmcsampler_torch``): the twin of ``simple.py``. It prints the largest
error of the cold chain's posterior mean against the Gaussian's centre.

Run from the repository root, with the package installed (``pip install
-e .``) or ``PYTHONPATH=.``: python examples/simple_torch.py [--device cpu]
(the CUDA card by default; on the CPU, fewer chains or iterations keep the
run short: --nchains 8 --niter 400).
"""

import argparse
from pathlib import Path

import numpy as np
import torch

from ptmcmcsampler_torch import PTSampler
from ptmcmcsampler_torch.models import CorrelatedGaussian

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda")
parser.add_argument("--nchains", type=int, default=64)
parser.add_argument("--niter", type=int, default=10000)
parser.add_argument("--outdir", default=str(Path(__file__).parent / "chains_simple_torch"))
args = parser.parse_args()

ndim = 20
pmin, pmax = 0.0, 10.0
glo = CorrelatedGaussian(ndim=ndim, pmin=pmin, pmax=pmax)

p0 = np.random.default_rng(0).uniform(pmin, pmax, ndim)
cov = np.eye(ndim) * 0.1**2

sampler = PTSampler(
    ndim,
    glo.lnlikefn,
    glo.lnpriorfn,
    np.copy(cov),
    outDir=args.outdir,
    ntemps=1,
    nchains=args.nchains,
    seed=0,
    device=args.device,
)


class UniformJump:
    """Custom jump, torch-native protocol (rng, x, iter, beta) -> (q, lqxy):
    ``rng`` is the sampler's generator on the device."""

    def __init__(self, pmin, pmax):
        self.pmin, self.pmax = pmin, pmax

    def jump(self, rng, x, it, beta):
        u = torch.rand(x.shape, generator=rng, device=x.device, dtype=x.dtype)
        return self.pmin + (self.pmax - self.pmin) * u, x.new_zeros(())


sampler.addProposalToCycle(UniformJump(pmin, pmax).jump, 5, name="UniformJump")

burn = args.niter // 20
sampler.sample(p0, args.niter, burn=burn, thin=1, covUpdate=burn, SCAMweight=20, AMweight=20,
               DEweight=20)

chain = sampler.chain[args.niter // 10:]
print("\nposterior mean error:", np.abs(chain.mean(axis=0) - glo.mu).max())
