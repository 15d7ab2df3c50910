#!/usr/bin/env python
"""40-D interval-transformed Gaussian, the reference's
``examples/gaussian_likelihood.ipynb`` workload (a multivariate normal
restricted to a box by the logit ``intervalTransform``), sampled with the
full jump cycle including NUTS and HMC, on the PyTorch port
(``ptmcmcsampler_torch``): the twin of ``gaussian_likelihood.py``. The
samples go back to the box through the model's ``backward``, and the script
prints their moments there (a standard normal truncated to the box (0, 10):
mean 0.798, standard deviation 0.603).

Run from the repository root, with the package installed (``pip install
-e .``) or ``PYTHONPATH=.``: python examples/gaussian_likelihood_torch.py
[--device cpu] (the CUDA card by default; on the CPU, fewer chains or
iterations keep the run short: --nchains 8 --niter 400).
"""

import argparse
from pathlib import Path

import numpy as np

from ptmcmcsampler_torch import PTSampler
from ptmcmcsampler_torch.models import IntervalTransformedGaussian

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda")
parser.add_argument("--nchains", type=int, default=128)
parser.add_argument("--niter", type=int, default=60000)
parser.add_argument("--outdir", default=str(Path(__file__).parent / "chains_gaussian_torch"))
args = parser.parse_args()

ndim = 40
model = IntervalTransformedGaussian(ndim=ndim, pmin=0.0, pmax=10.0)

# Start near the center of the box in the transformed coordinates.
p0 = np.zeros(ndim)
cov = np.eye(ndim) * 0.1

sampler = PTSampler(
    ndim,
    model.lnlikefn,
    model.lnpriorfn,
    np.copy(cov),
    logl_grad=model.lnlikefn_grad,
    logp_grad=model.lnpriorfn_grad,
    outDir=args.outdir,
    ntemps=4,
    nchains=args.nchains,
    seed=0,
    device=args.device,
)

# Reference notebook: 60k iterations, SCAM/AM/DE + NUTS/HMC (MALA off).
sampler.sample(
    p0, args.niter, burn=args.niter // 10, thin=10,
    SCAMweight=10, AMweight=10, DEweight=10, NUTSweight=10, HMCweight=10,
    MALAweight=0, HMCsteps=50, HMCstepsize=0.1,
)

chain = sampler.chain[args.niter // 60:]
x = model.backward(chain)  # back to the box
print("\nposterior mean (box coords):", x.mean(axis=0)[:5], "...")
print("posterior std  (box coords):", x.std(axis=0)[:5], "...")
