#!/usr/bin/env python
"""The curved ("banana") likelihood, the reference's headline workload
(examples/curved_likelihood.ipynb), with parallel tempering and the full
jump cycle including NUTS and HMC, on the PyTorch port
(``ptmcmcsampler_torch``): the twin of ``curved_likelihood.py``. The model's
bound methods take the kernel route (the NUTS and HMC CUDA kernels on the
card, their plain versions on the CPU). It prints the cold chain's mean.

Run from the repository root, with the package installed (``pip install
-e .``) or ``PYTHONPATH=.``: python examples/curved_likelihood_torch.py
[--device cpu] (the CUDA card by default; on the CPU, fewer chains or
iterations keep the run short: --nchains 8 --niter 400).
"""

import argparse
from pathlib import Path

import numpy as np

from ptmcmcsampler_torch import PTSampler
from ptmcmcsampler_torch.models import CurvedLikelihood

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda")
parser.add_argument("--nchains", type=int, default=256)
parser.add_argument("--niter", type=int, default=100000)
parser.add_argument("--outdir", default=str(Path(__file__).parent / "chains_curved_torch"))
args = parser.parse_args()

cl = CurvedLikelihood()
p0 = np.array([-0.1, -0.5])
cov = np.diag([1.0, 1.0])

sampler = PTSampler(
    2,
    cl.lnlikefn,
    cl.lnpriorfn,
    np.copy(cov),
    logl_grad=cl.lnlikefn_grad,
    logp_grad=cl.lnpriorfn_grad,
    outDir=args.outdir,
    ntemps=8,
    nchains=args.nchains,
    seed=0,
    device=args.device,
)
print("route:", sampler.route)

sampler.sample(
    p0, args.niter, burn=args.niter // 10, thin=1,
    SCAMweight=10, AMweight=10, DEweight=10, NUTSweight=10, HMCweight=10,
    MALAweight=0, HMCsteps=50, HMCstepsize=0.08,
)

chain = sampler.chain[args.niter // 5:]
print("\ncold-chain mean:", chain.mean(axis=0))
