"""Chain diagnostics: the integrated autocorrelation time of one chain (the
sampler's single-chain ``neff`` stop), split R-hat, cross-chain ESS and the
bench's posterior-moment gate.

``split_rhat``, ``multichain_ess`` and ``moment_gate`` take numpy arrays or
torch tensors and compute the heavy part in f64 on the tensor's device (a
numpy array on the CPU), chunked over chains: at 50-D and 200-D a run's
retained cold chains are about 10**9 values, which the host's FFTs take
minutes over.
"""

from __future__ import annotations

import numpy as np
import torch

#: Cap on the complex FFT intermediate per multichain_ess chunk (bytes).
_ESS_FFT_CHUNK_BYTES = 128e6
#: The same cap on a CUDA device.
_ESS_FFT_CHUNK_BYTES_CUDA = 2e9


def _next_pow_two(n):
    i = 1
    while i < n:
        i <<= 1
    return i


def autocorr_function(x):
    """Normalized autocorrelation function of a 1-D series."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    if n < 2:
        return np.ones(1)
    f = np.fft.fft(x - np.mean(x), n=2 * _next_pow_two(n))
    acf = np.fft.ifft(f * np.conjugate(f))[:n].real
    if acf[0] <= 0:
        return np.ones(n)
    return acf / acf[0]


def integrated_autocorr_time(x, c=5.0):
    """Integrated autocorrelation time with Sokal's automatic window."""
    f = autocorr_function(x)
    taus = 2.0 * np.cumsum(f) - 1.0
    window = np.arange(len(taus)) < c * taus
    if np.any(~window):
        m = int(np.argmin(window))
        return max(taus[m], 1.0)
    return max(taus[-1], 1.0)


def max_autocorr_time(chain):
    """Largest integrated autocorrelation time over the columns of ``chain
    [n, ndim]``: the reference's ``max_i acor(chain[:, i])``
    (PTMCMCSampler.py:512-517)."""
    chain = np.atleast_2d(np.asarray(chain))
    taus = [integrated_autocorr_time(chain[:, i]) for i in range(chain.shape[1])]
    return float(np.nanmax(taus)) if taus else 1.0


def effective_samples(chain, niter=None):
    """``niter / max tau``, the reference's N_eff (PTMCMCSampler.py:512)."""
    n = niter if niter is not None else len(chain)
    return n / max(1.0, max_autocorr_time(chain))


def _as_tensor(chains):
    """``chains`` as a torch tensor (numpy arrays on the CPU, unchanged)."""
    return chains if isinstance(chains, torch.Tensor) else torch.as_tensor(np.asarray(chains))


def split_rhat(chains):
    """Split-chain potential scale reduction factor (Gelman-Rubin R-hat).

    chains: [nchains, nsteps, ndim], numpy or torch. Each chain is split in
    half, then the between/within variance ratio is computed per parameter.
    Returns a numpy array [ndim].
    """
    chains = _as_tensor(chains)
    m, n, d = chains.shape
    half = n // 2
    if half < 2:
        return np.full(d, np.nan)
    parts = (chains[:, :half], chains[:, half : 2 * half])
    sn = half
    means = torch.cat([p.double().mean(dim=1) for p in parts]).cpu().numpy()
    variances = torch.cat([p.double().var(dim=1, correction=1) for p in parts]).cpu().numpy()
    w = variances.mean(axis=0)
    b = sn * means.var(axis=0, ddof=1)
    var_plus = (sn - 1) / sn * w + b / sn
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.sqrt(var_plus / w)


def multichain_ess(chains):
    """Cross-chain effective sample size per parameter (Stan-style).

    chains: [nchains, nsteps, ndim], numpy or torch. Per-chain
    autocovariances averaged and corrected by the between-chain variance,
    with Geyer initial-monotone truncation, so chains stuck in different
    modes are penalised. Returns a numpy array [ndim].
    """
    chains = _as_tensor(chains)
    m, n, d = chains.shape
    if n < 2:
        return np.full(d, float(m * n))
    chain_means, chain_vars, acov_sum = _acov(chains)
    w = chain_vars.mean(axis=0)
    b = n * chain_means.var(axis=0, ddof=1) if m > 1 else np.zeros(d)
    var_plus = w * (n - 1) / n + b / n
    acov = acov_sum / m
    with np.errstate(divide="ignore", invalid="ignore"):
        rho = 1.0 - (w - acov) / var_plus
    npairs = n // 2
    pair = rho[0 : 2 * npairs : 2] + rho[1 : 2 * npairs : 2]
    included = np.cumprod(pair >= 0, axis=0).astype(bool)
    mono = np.minimum.accumulate(pair, axis=0)
    s = np.where(included, mono, 0.0).sum(axis=0)
    tau = np.maximum(1.0, -1.0 + 2.0 * s)
    ess = m * n / tau
    return np.where(np.isfinite(var_plus) & (var_plus > 0), ess, float(m * n))


def _acov(chains):
    """Per-chain means and variances [m, d], and the sum over chains of the
    normalised autocovariances scaled by each chain's variance [n, d], in
    f64 on the tensor's device; numpy results. A batched rFFT, chunked over
    chains so the complex intermediate stays near the device's cap."""
    m, n, d = chains.shape
    cap = _ESS_FFT_CHUNK_BYTES_CUDA if chains.is_cuda else _ESS_FFT_CHUNK_BYTES
    nfft = 2 * _next_pow_two(n)
    chunk_m = max(1, int(cap // (nfft * max(d, 1) * 16)))
    blocks = [slice(i0, min(m, i0 + chunk_m)) for i0 in range(0, m, chunk_m)]
    chain_means = torch.cat([chains[b].double().mean(dim=1) for b in blocks])
    chain_vars = torch.cat([chains[b].double().var(dim=1, correction=1) for b in blocks])
    acov_sum = torch.zeros((n, d), dtype=torch.float64, device=chains.device)
    scale = chain_vars * (n - 1) / n
    for blk in blocks:
        xc = chains[blk].double() - chain_means[blk, None, :]
        f = torch.fft.rfft(xc, n=nfft, dim=1)
        acf = torch.fft.irfft(f * torch.conj(f), n=nfft, dim=1)[:, :n, :]
        acf0 = acf[:, :1, :]
        ok0 = acf0 > 0
        fnorm = torch.where(ok0, acf / torch.where(ok0, acf0, 1.0), 1.0)
        acov_sum += (fnorm * scale[blk, None, :]).sum(dim=0)
    return chain_means.cpu().numpy(), chain_vars.cpu().numpy(), acov_sum.cpu().numpy()


def _pooled_mean_sd(chains):
    """Per-dimension mean and standard deviation (ddof 0) of all samples."""
    blocks = torch.split(chains.reshape(-1, chains.shape[-1]), 1 << 22)
    mean = sum(b.double().sum(dim=0) for b in blocks) / (chains.numel() // chains.shape[-1])
    var = sum(((b.double() - mean) ** 2).sum(dim=0) for b in blocks) / (
        chains.numel() // chains.shape[-1])
    return mean.cpu().numpy(), var.sqrt().cpu().numpy()


def moment_gate(chains, target_mean):
    """The bench's posterior-moment check (bench.py:294-304).

    ``chains [nchains, nsteps, ndim]`` of cold-chain samples, numpy or
    torch. Passes when every dimension's pooled mean is within 8 standard
    errors (from the pooled ESS) plus 2% of a standard deviation of
    ``target_mean``. Returns ``(ok, max_z, ess)``.
    """
    chains = _as_tensor(chains)
    ess = multichain_ess(chains)
    mean, sd = _pooled_mean_sd(chains)
    se = sd / np.sqrt(np.maximum(ess, 1.0))
    err = np.abs(mean - np.asarray(target_mean))
    z = err / np.maximum(se, 1e-9)
    ok = bool(np.all(err < 8.0 * np.maximum(se, 1e-9) + 0.02 * np.maximum(sd, 1e-9)))
    return ok, float(z.max()), ess
