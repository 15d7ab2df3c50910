"""Small shared numerical helpers."""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def resolve_device(device, caller):
    """``torch.device(device)``, with a bare ``"cuda"`` pinned to the current
    card; raises when it names the card and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{caller}: device='cuda' but no CUDA device is available; "
                "pass device='cpu' to run on the CPU"
            )
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def tempered_lnprob(lnlike, lnprior, beta):
    """Tempered log-posterior ``beta * lnlike + lnprior``.

    Two guards keep the reference's semantics (PTMCMCSampler.py:481-487):

    * ``beta == 0`` (the hot chain): ``0 * -inf`` is NaN in torch as in IEEE,
      but a ``-inf`` likelihood must stay ``-inf`` at any temperature;
    * ``lnprior == -inf`` dominates whatever the likelihood is.
    """
    tempered = torch.where(torch.isneginf(lnlike), NEG_INF, beta * lnlike)
    return torch.where(torch.isneginf(lnprior), NEG_INF, tempered + lnprior)


def cholesky_psd(mat, jitter=1e-10):
    """Cholesky factor of a (possibly barely-) PSD matrix with a jitter retry.

    Uses ``cholesky_ex`` so that a failed factorisation yields NaNs to test
    for instead of an exception that would need the device to report back.
    """
    d = mat.shape[-1]
    eye = torch.eye(d, dtype=mat.dtype, device=mat.device)
    scale = torch.clamp(torch.mean(torch.diagonal(mat)), min=1.0)
    chol, info = torch.linalg.cholesky_ex(mat + jitter * scale * eye)
    ok = (info == 0) & torch.all(torch.isfinite(chol))
    bigger, _ = torch.linalg.cholesky_ex(mat + 1e-4 * scale * eye)
    return torch.where(ok, chol, bigger)
