"""Chain diagnostics (host numpy): the integrated autocorrelation time of
one chain (the sampler's single-chain ``neff`` stop), split R-hat,
cross-chain ESS and the bench's posterior-moment gate."""

from __future__ import annotations

import numpy as np

#: Cap on the complex FFT intermediate per multichain_ess chunk (bytes).
_ESS_FFT_CHUNK_BYTES = 128e6


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


def split_rhat(chains):
    """Split-chain potential scale reduction factor (Gelman-Rubin R-hat).

    chains: [nchains, nsteps, ndim]. Each chain is split in half, then the
    between/within variance ratio is computed per parameter.
    """
    chains = np.asarray(chains, dtype=np.float64)
    m, n, d = chains.shape
    half = n // 2
    if half < 2:
        return np.full(d, np.nan)
    split = np.concatenate([chains[:, :half], chains[:, half : 2 * half]], axis=0)
    sn = split.shape[1]
    means = split.mean(axis=1)
    variances = split.var(axis=1, ddof=1)
    w = variances.mean(axis=0)
    b = sn * means.var(axis=0, ddof=1)
    var_plus = (sn - 1) / sn * w + b / sn
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.sqrt(var_plus / w)


def multichain_ess(chains):
    """Cross-chain effective sample size per parameter (Stan-style).

    chains: [nchains, nsteps, ndim]. Per-chain autocovariances averaged and
    corrected by the between-chain variance, with Geyer initial-monotone
    truncation, so chains stuck in different modes are penalised. Returns
    an array [ndim].
    """
    chains = np.asarray(chains)
    m, n, d = chains.shape
    if n < 2:
        return np.full(d, float(m * n))
    chain_means = chains.mean(axis=1, dtype=np.float64)
    chain_vars = chains.var(axis=1, ddof=1, dtype=np.float64)
    w = chain_vars.mean(axis=0)
    b = n * chain_means.var(axis=0, ddof=1) if m > 1 else np.zeros(d)
    var_plus = w * (n - 1) / n + b / n
    # Batched rFFT, chunked over chains so the complex intermediate stays
    # near _ESS_FFT_CHUNK_BYTES.
    nfft = 2 * _next_pow_two(n)
    chunk_m = max(1, int(_ESS_FFT_CHUNK_BYTES // (nfft * max(d, 1) * 16)))
    acov_sum = np.zeros((n, d))
    scale = chain_vars * (n - 1) / n
    for i0 in range(0, m, chunk_m):
        blk = slice(i0, min(m, i0 + chunk_m))
        xc = chains[blk].astype(np.float64) - chain_means[blk, None, :]
        f = np.fft.rfft(xc, n=nfft, axis=1)
        acf = np.fft.irfft(f * np.conj(f), n=nfft, axis=1)[:, :n, :]
        acf0 = acf[:, :1, :]
        ok0 = acf0 > 0
        fnorm = np.where(ok0, acf / np.where(ok0, acf0, 1.0), 1.0)
        acov_sum += (fnorm * scale[blk, None, :]).sum(axis=0)
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


def moment_gate(chains, target_mean):
    """The bench's posterior-moment check (bench.py:294-304).

    ``chains [nchains, nsteps, ndim]`` of cold-chain samples. Passes when
    every dimension's pooled mean is within 8 standard errors (from the
    pooled ESS) plus 2% of a standard deviation of ``target_mean``.
    Returns ``(ok, max_z, ess)``.
    """
    chains = np.asarray(chains)
    ess = multichain_ess(chains)
    flat = chains.reshape(-1, chains.shape[-1])
    mean = flat.mean(axis=0, dtype=np.float64)
    sd = flat.std(axis=0, dtype=np.float64)
    se = sd / np.sqrt(np.maximum(ess, 1.0))
    err = np.abs(mean - np.asarray(target_mean))
    z = err / np.maximum(se, 1e-9)
    ok = bool(np.all(err < 8.0 * np.maximum(se, 1e-9) + 0.02 * np.maximum(sd, 1e-9)))
    return ok, float(z.max()), ess
