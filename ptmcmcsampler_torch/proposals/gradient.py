"""Whitened leapfrog dynamics for the gradient jumps.

Whitening goes through the Cholesky factor of the mass-matrix inverse, as
the reference's ``set_cf``/``forward``/``backward``/``func_grad_white``
(nutsjump.py:51-90): ``q = chol_inv^T x``, ``x = chol^T q``, and the
whitened gradient is ``chol @ grad``. Everything acts on ``[T, D, C]``.
"""

from __future__ import annotations


def make_whitened_funcs(value_grad):
    """Whitened-space helpers around a tempered ``value_grad(x, beta)``
    (``x [T, D, C]``, ``beta`` broadcastable to ``[T, C]``)."""

    def forward(ctx, x):
        return ctx.chol_inv.T @ x

    def backward(ctx, q):
        return ctx.chol.T @ q

    def func_grad_white(ctx, q, beta):
        fv, fg = value_grad(backward(ctx, q), beta)
        return fv, ctx.chol @ fg

    return forward, backward, func_grad_white


def leapfrog(func_grad_white, ctx, beta, theta, r, grad, epsilon):
    """One leapfrog step in whitened coordinates (nutsjump.py:149-169);
    ``epsilon`` broadcasts against ``theta``."""
    rprime = r + 0.5 * epsilon * grad
    thetaprime = theta + epsilon * rprime
    logpprime, gradprime = func_grad_white(ctx, thetaprime, beta)
    rprime = rprime + 0.5 * epsilon * gradprime
    return thetaprime, rprime, gradprime, logpprime
