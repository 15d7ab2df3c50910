"""Example posteriors, batched over chain-minor tensors ``x[..., D, C]``.

``CurvedLikelihood`` is the 2-D curved (banana) likelihood of the
reference's examples/curved_likelihood.ipynb, the main path's workload. Its
gradient is written out in closed form: it is the same function, in the same
operation order, as the device functor ``CurvedLikelihood`` in
``ptmcmcsampler_torch/csrc/models.cuh``, which the trajectory and tree
kernels call. ``cuda_functor`` names that functor; on the card the kernel
wrappers launch the kernels for a model that names one, and run their plain
versions for a model without one.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_LOG_HALF = math.log(0.5)


class CurvedLikelihood:
    """ll = log[ exp(-x^2 - (9 + 4x^2 + 9y)^2) + 0.5 exp(-8x^2 - 8(y-2)^2) ]
    with a uniform prior on the open box (-10, 10)^2.

    The batched methods (``lnlike``, ``lnprior``, ``value_grad``) take
    chain-minor ``x [..., 2, C]``; the per-point methods (``lnlikefn``,
    ``lnpriorfn`` and their ``*_grad``) take ``x [2]``, as the JAX model's
    user API. Both run the same operations in the same order.
    """

    ndim = 2
    cuda_functor = "curved"

    @staticmethod
    def _terms(x0, y):
        s = 9.0 + 4.0 * (x0 * x0) + 9.0 * y
        e0 = -(x0 * x0) - s * s
        ym2 = y - 2.0
        e1 = -8.0 * (x0 * x0) - 8.0 * (ym2 * ym2)
        a, b = e0, _LOG_HALF + e1
        # logaddexp, in the form jnp.logaddexp evaluates it: safe where the
        # reference's log(exp(e0) + 0.5 exp(e1)) underflows to log(0).
        delta = a - b
        ll = torch.where(
            torch.isnan(delta),
            a + b,
            torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(delta))),
        )
        return x0, s, ym2, a, b, ll

    @staticmethod
    def _grad(x0, s, ym2, a, b, ll):
        """``(d ll / dx, d ll / dy)`` from the terms."""
        w0 = torch.exp(a - ll)  # d ll / d e0, as logaddexp's derivative
        w1 = torch.exp(b - ll)  # d ll / d e1
        gx = w0 * (-2.0 * x0 - 16.0 * (x0 * s)) + w1 * (-16.0 * x0)
        gy = w0 * (-18.0 * s) + w1 * (-16.0 * ym2)
        return gx, gy

    def lnlike(self, x):
        """``x [..., 2, C] -> [..., C]``."""
        return self._terms(x[..., 0, :], x[..., 1, :])[-1]

    def lnprior(self, x):
        """0 inside the open box, -inf outside (strict, as the reference)."""
        inside = torch.all((x > -10.0) & (x < 10.0), dim=-2)
        return torch.where(inside, 0.0, float("-inf")).to(x.dtype)

    def value_grad(self, x, beta):
        """Tempered value and gradient ``(beta*ll + lp, beta*grad ll)``.

        ``x [..., 2, C]``, ``beta`` broadcastable to ``[..., C]``; returns
        ``(val [..., C], grad [..., 2, C])``.
        """
        terms = self._terms(x[..., 0, :], x[..., 1, :])
        gx, gy = self._grad(*terms)
        val = beta * terms[-1] + self.lnprior(x)
        return val, torch.stack([beta * gx, beta * gy], dim=-2)

    def lnlikefn(self, x):
        """Per-point log-likelihood, ``x [2] -> ()``."""
        return self._terms(x[0], x[1])[-1]

    def lnpriorfn(self, x):
        """Per-point log-prior, ``x [2] -> ()``."""
        return self.lnprior(x[:, None])[0]

    def lnlikefn_grad(self, x):
        """Per-point ``(ll, grad ll)``, ``x [2] -> ((), [2])``."""
        terms = self._terms(x[0], x[1])
        return terms[-1], torch.stack(self._grad(*terms))

    def lnpriorfn_grad(self, x):
        """Per-point ``(lp, 0)``: the prior is flat inside the box."""
        return self.lnpriorfn(x), torch.zeros_like(x)

    def posterior_moments(self, n=2001):
        """Posterior mean and covariance by 2-D quadrature (f64).

        The grid covers [-6, 6] x [-9, 5]; outside, the log-density is below
        -17, so the truncation error is negligible against the banana
        ridge's ~0.08 y-width resolved at dy ~ 0.007.
        """
        xs = np.linspace(-6.0, 6.0, n)
        ys = np.linspace(-9.0, 5.0, n)
        X, Y = np.meshgrid(xs, ys, indexing="ij")
        e0 = -(X**2) - (9 + 4 * X**2 + 9 * Y) ** 2
        e1 = -8 * X**2 - 8 * (Y - 2) ** 2
        ll = np.logaddexp(e0, np.log(0.5) + e1)
        w = np.exp(ll - ll.max())
        z = w.sum()
        mx = float((w * X).sum() / z)
        my = float((w * Y).sum() / z)
        cxx = float((w * (X - mx) ** 2).sum() / z)
        cyy = float((w * (Y - my) ** 2).sum() / z)
        cxy = float((w * (X - mx) * (Y - my)).sum() / z)
        return np.array([mx, my]), np.array([[cxx, cxy], [cxy, cyy]])
