"""Example posteriors, batched over chain-minor tensors ``x[..., D, C]``.

The JAX package's four example models (``ptmcmcsampler_tpu/models/
examples.py``), with the same constructor arguments and the same numpy
set-up, so that one seed gives both packages the same constants:

* ``CurvedLikelihood``, the 2-D curved (banana) likelihood of the
  reference's examples/curved_likelihood.ipynb, the main path's workload;
* ``CorrelatedGaussian``, the correlated Gaussian with a box prior of the
  reference's examples/simple.py (``bench.py``'s ``gaussian200`` at 200-D);
* ``IntervalTransformedGaussian``, a standard normal on a box in logit
  coordinates (``bench.py``'s ``gaussian``, 40-D);
* ``HierarchicalGaussian``, a 50-D linear-Gaussian hierarchy
  (``bench.py``'s ``hierarchical``).

Each gradient is written out in closed form. ``value_grad`` is the same
function, in the same operation order with every sum over ``D`` an ordered
sum (``ops.common.rsum``), as the model's device functor in
``ptmcmcsampler_torch/csrc/models.cuh``, which the kernels call; it is the
kernels' plain version. ``cuda_functor`` names that functor, and
``cuda_params`` gives a wide functor its constants on the card
(``ops/common.py`` says which kernel takes which functor at which D). The
batched ``lnlike`` and ``lnprior``, which the tempered accept evaluates
outside any kernel, may sum in any order (``torch.sum``, ``torch.matmul``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.common import matvec, rsum

_LOG_HALF = math.log(0.5)


def _beta_d(beta, x):
    """``beta`` (a number, or broadcastable to ``x[..., C]``) as a tensor
    that broadcasts against ``x [..., D, C]``."""
    beta = torch.as_tensor(beta, dtype=x.dtype, device=x.device)
    return beta.unsqueeze(-2) if beta.dim() else beta


class _Wide:
    """The per-point user API and the device constants of the wide models
    around their batched ``_ll_grad(x) -> (ll, grad ll)`` and
    ``_lp_grad(x) -> (lp, grad lp)`` (ordered sums)."""

    _params = None

    def lnlikefn(self, x):
        """Per-point log-likelihood, ``x [D] -> ()``."""
        return self._ll_grad(x[:, None])[0][0]

    def lnpriorfn(self, x):
        """Per-point log-prior, ``x [D] -> ()``."""
        return self._lp_grad(x[:, None])[0][0]

    def lnlikefn_grad(self, x):
        """Per-point ``(ll, grad ll)``, ``x [D] -> ((), [D])``."""
        ll, g = self._ll_grad(x[:, None])
        return ll[0], g[:, 0]

    def lnpriorfn_grad(self, x):
        """Per-point ``(lp, grad lp)``, ``x [D] -> ((), [D])``."""
        lp, g = self._lp_grad(x[:, None])
        return lp[0], g[:, 0]

    def cuda_params(self, device):
        """The functor's constants as one contiguous f32 array on ``device``
        (layout in ``csrc/models.cuh``), made once a device and cached."""
        device = torch.device(device)
        if self._params is None or self._params.device != device:
            self._params = torch.tensor(self._param_values(), dtype=torch.float32,
                                        device=device).contiguous()
        return self._params


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


class CorrelatedGaussian(_Wide):
    """Reference examples/simple.py model: a Gaussian likelihood with a
    random correlated covariance and a uniform prior on the closed box
    ``[pmin, pmax]^ndim``. No closed-form moments: the box truncates it.

    The JAX gradient, ``-(icov diff + icov^T diff) / 2``, is computed as
    ``-0.5 * (S diff)`` with ``S = icov + icov^T`` formed once in f32 (one
    product a step, not two; ``S`` is exactly symmetric, the f32 ``icov`` of
    ``np.linalg.inv`` need not be). The log-likelihood ``-diff.(icov diff)/2``
    is ``-0.25 * diff.(S diff)``: the same function.
    """

    cuda_functor = "correlated_gaussian"

    def __init__(self, ndim=20, pmin=0.0, pmax=10.0, seed=0):
        self.ndim = int(ndim)
        rng = np.random.default_rng(seed)
        self.a = np.ones(ndim) * pmin
        self.b = np.ones(ndim) * pmax
        self.mu = rng.uniform(pmin, pmax, ndim)
        cov = 0.5 - rng.random(ndim**2).reshape((ndim, ndim))
        cov = np.triu(cov)
        cov += cov.T - np.diag(cov.diagonal())
        self.cov = np.dot(cov, cov)
        self.icov = np.linalg.inv(self.cov)
        icov32 = self.icov.astype(np.float32)
        self._sym = icov32 + icov32.T  # f32, exactly symmetric
        self._t = {}

    def _consts(self, x):
        """``(mu [D, 1], a, b [D, 1], S [D, D])`` on ``x``'s device."""
        key = x.device
        if key not in self._t:
            def col(v):
                return torch.tensor(np.asarray(v, np.float32)[:, None], device=key)
            self._t[key] = (col(self.mu), col(self.a), col(self.b),
                            torch.tensor(self._sym, device=key))
        return self._t[key]

    def _box(self, x):
        _, a, b, _ = self._consts(x)
        inside = torch.all((a <= x) & (b >= x), dim=-2)
        return torch.where(inside, 0.0, float("-inf")).to(x.dtype)

    def _ll_grad(self, x):
        mu, _, _, sym = self._consts(x)
        diff = x - mu
        sd = matvec(sym, diff)
        return -0.25 * rsum(diff * sd), -0.5 * sd

    def _lp_grad(self, x):
        return self._box(x), torch.zeros_like(x)

    def lnlike(self, x):
        """``x [..., D, C] -> [..., C]`` (a matmul; see the module docstring)."""
        mu, _, _, sym = self._consts(x)
        diff = x - mu
        return -0.25 * torch.sum(diff * torch.matmul(sym, diff), dim=-2)

    def lnprior(self, x):
        """0 inside the closed box, -inf outside."""
        return self._box(x)

    def value_grad(self, x, beta):
        """Tempered ``(beta*ll + lp, beta*grad ll)`` for ``x [..., D, C]``;
        the functor ``correlated_gaussian``'s operation order."""
        ll, gll = self._ll_grad(x)
        return beta * ll + self._box(x), _beta_d(beta, x) * gll

    def _param_values(self):
        """``[mu (D), a (D), b (D), S (D*D, row-major)]``."""
        return np.concatenate([self.mu, self.a, self.b, self._sym.ravel()]).astype(np.float32)

    def cuda_params_len(self):
        """Length of ``_param_values``, which the kernel wrappers check."""
        return 3 * self.ndim + self.ndim * self.ndim


class IntervalTransformedGaussian(_Wide):
    """Standard normal on the box ``(pmin, pmax)^ndim``, sampled in logit
    coordinates ``p`` (reference tests/test_nuts.py:50-162); a flat prior.

    The gradient is the one ``jax.value_and_grad`` gives for the JAX model,
    in closed form: ``-x (b-a) s(1-s) + 1 - 2 e / (1 + e)`` with ``s`` the
    sigmoid of ``p``, ``x = (b-a) s + a`` and ``e = exp(p)``. As there,
    ``exp(p)`` overflows for ``p`` above about 88.7: the log-likelihood is
    then -inf and the gradient NaN.
    """

    cuda_functor = "interval_gaussian"

    def __init__(self, ndim=40, pmin=0.0, pmax=10.0):
        self.ndim = int(ndim)
        self.pmin, self.pmax = float(pmin), float(pmax)
        # f32 constants, held as Python floats (exact) for the operations.
        f32 = np.float32
        self._lo = float(f32(pmin))
        self._w = float(f32(pmax) - f32(pmin))
        self._lw = float(f32(np.log(f32(self._w))))
        self._c0 = float(f32(self.ndim * 0.5) * f32(np.log(f32(2 * np.pi))))

    def _terms(self, p):
        s = torch.reciprocal(1.0 + torch.exp(-p))
        x = self._w * s + self._lo
        e = torch.exp(p)
        return s, x, e

    def _jac(self, p, e):
        """``log(b - a) + p - 2 log1p(e)`` elementwise, ``e = exp(p)``."""
        return (self._lw + p) - 2.0 * torch.log1p(e)

    @staticmethod
    def _as_tensor(p):
        """``(tensor, back)``: a numpy ``p`` as an f32 tensor (so that
        ``exp`` overflows where the model's does), and the function that
        returns a result in ``p``'s kind."""
        if isinstance(p, torch.Tensor):
            return p, lambda r: r
        return torch.as_tensor(np.asarray(p, np.float32)), lambda r: r.numpy()

    def backward(self, p):
        """The box coordinates ``(b - a) sigmoid(p) + a`` of logit
        coordinates ``p`` (the JAX model's ``backward``): elementwise, so a
        point ``[D]`` or any batch; numpy in, numpy out."""
        t, back = self._as_tensor(p)
        return back(self._terms(t)[1])

    def _log_jacobian(self, p):
        """The sum over ``D`` of ``log(b - a) + p - 2 log1p(exp(p))`` (the
        JAX model's ``_log_jacobian``): a point ``[D]`` gives a scalar, a
        batch ``[..., D, C]`` one value a chain ``[..., C]``."""
        t, back = self._as_tensor(p)
        jac = self._jac(t, self._terms(t)[2])
        return back(torch.sum(jac) if t.dim() == 1 else torch.sum(jac, dim=-2))

    def _ll_grad(self, p):
        s, x, e = self._terms(p)
        jac = self._jac(p, e)
        ll = (-0.5 * rsum(x * x) - self._c0) + rsum(jac)
        g = -x * self._w * (s * (1.0 - s)) + (1.0 + (-2.0 * torch.reciprocal(e + 1.0)) * e)
        return ll, g

    def _lp_grad(self, p):
        return self.lnprior(p), torch.zeros_like(p)

    def lnlike(self, p):
        """``p [..., D, C] -> [..., C]`` (``torch.sum``)."""
        _, x, e = self._terms(p)
        jac = self._jac(p, e)
        return (-0.5 * torch.sum(x * x, dim=-2) - self._c0) + torch.sum(jac, dim=-2)

    def lnprior(self, p):
        return torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=p.dtype, device=p.device)

    def value_grad(self, p, beta):
        """Tempered ``(beta*ll, beta*grad ll)``; the functor
        ``interval_gaussian``'s operation order."""
        ll, gll = self._ll_grad(p)
        return beta * ll, _beta_d(beta, p) * gll

    def _param_values(self):
        """``[a, b - a, log(b - a), ndim/2 log(2 pi)]``."""
        return np.array([self._lo, self._w, self._lw, self._c0], np.float32)

    def cuda_params_len(self):
        """Length of ``_param_values``, which the kernel wrappers check."""
        return 4

    def posterior_moments(self, n=2_000_001):
        """Posterior mean and covariance of the sampled (logit-space) vector.

        Dimensions are independent and identical: x ~ N(0,1) truncated to
        (a, b), p = logit((x-a)/(b-a)). Moments of p come from midpoint
        quadrature in x-space (E[g(p)] = int g(p(x)) phi(x) dx / Z).
        """
        a, b = self.pmin, self.pmax
        h = (b - a) / n
        xs = a + (np.arange(n) + 0.5) * h
        w = np.exp(-0.5 * xs**2)
        p = np.log(xs - a) - np.log(b - xs)
        z = w.sum()
        mean = float((w * p).sum() / z)
        var = float((w * (p - mean) ** 2).sum() / z)
        d = int(self.ndim)
        return np.full(d, mean), np.eye(d) * var


class HierarchicalGaussian(_Wide):
    """Linear-Gaussian hierarchy, 50-D by default (BASELINE.json config 4):

        mu       ~ N(0, s_mu^2)                      (hyper-parameter)
        theta_i  ~ N(mu, s_t^2),  i = 1..ngroups     (group effects)
        y_i      ~ N(theta_i, s_y^2)                 (data, fixed at init)

    Parameter vector x = (mu, theta_1..theta_ngroups); closed-form posterior
    moments. The prior is the hierarchical one, with its gradient. Each
    division by a sigma is a product with its f32 reciprocal, on the CPU and
    the card alike. The prior is exactly samplable (:meth:`draw_prior`),
    which is what the prior-draw jump needs.
    """

    cuda_functor = "hierarchical_gaussian"

    def __init__(self, ngroups=49, s_mu=3.0, s_t=1.0, s_y=0.5, seed=0):
        self.ngroups = int(ngroups)
        self.ndim = self.ngroups + 1
        self.s_mu, self.s_t, self.s_y = float(s_mu), float(s_t), float(s_y)
        rng = np.random.default_rng(seed)
        true_mu = rng.normal(0.0, s_mu)
        true_theta = true_mu + rng.normal(0.0, s_t, self.ngroups)
        self.y = true_theta + rng.normal(0.0, s_y, self.ngroups)
        # 1/s_mu, 1/s_t, 1/s_y in f32, held as Python floats (exact).
        self._r = tuple(float(np.float32(1.0) / np.float32(s)) for s in (s_mu, s_t, s_y))
        self._t = {}

    def _y(self, x):
        if x.device not in self._t:
            self._t[x.device] = torch.tensor(self.y.astype(np.float32)[:, None], device=x.device)
        return self._t[x.device]

    def _parts(self, x):
        r_mu, r_t, r_y = self._r
        mu, th = x[..., 0, :], x[..., 1:, :]
        u = (th - mu.unsqueeze(-2)) * r_t
        r = (self._y(x) - th) * r_y
        return mu * r_mu, u, r

    def _ll_grad(self, x):
        _, _, r = self._parts(x)
        g = torch.cat([torch.zeros_like(x[..., :1, :]), r * self._r[2]], dim=-2)
        return -0.5 * rsum(r * r), g

    def _lp_grad(self, x):
        m, u, _ = self._parts(x)
        wv = u * self._r[1]
        g = torch.cat([(-(m * self._r[0]) + rsum(wv)).unsqueeze(-2), -wv], dim=-2)
        return -0.5 * (m * m) - 0.5 * rsum(u * u), g

    def lnlike(self, x):
        """``x [..., D, C] -> [..., C]`` (``torch.sum``)."""
        _, _, r = self._parts(x)
        return -0.5 * torch.sum(r * r, dim=-2)

    def lnprior(self, x):
        m, u, _ = self._parts(x)
        return -0.5 * (m * m) - 0.5 * torch.sum(u * u, dim=-2)

    def value_grad(self, x, beta):
        """Tempered ``(beta*ll + lp, beta*grad ll + grad lp)``; the functor
        ``hierarchical_gaussian``'s operation order (the hyper-parameter's
        likelihood gradient is 0 and not added)."""
        m, u, r = self._parts(x)
        wv = u * self._r[1]
        ll = -0.5 * rsum(r * r)
        lp = -0.5 * (m * m) - 0.5 * rsum(u * u)
        g_mu = -(m * self._r[0]) + rsum(wv)
        g_th = _beta_d(beta, x) * (r * self._r[2]) - wv
        return beta * ll + lp, torch.cat([g_mu.unsqueeze(-2), g_th], dim=-2)

    def _param_values(self):
        """``[1/s_mu, 1/s_t, 1/s_y, y (ngroups)]``."""
        return np.concatenate([np.array(self._r, np.float32), self.y]).astype(np.float32)

    def cuda_params_len(self):
        """Length of ``_param_values``, which the kernel wrappers check."""
        return 3 + self.ngroups

    def draw_prior(self, rng):
        """Exact ancestral sample ``[D]`` from the hierarchical prior, drawn
        with the generator ``rng`` on its device (the prior-draw jump's
        torch-native ``draw(rng)``): ``mu = s_mu z0``, ``theta = mu + s_t z``,
        each sigma the f32 value the reciprocals above invert."""
        s_mu, s_t = (float(np.float32(s)) for s in (self.s_mu, self.s_t))
        mu = s_mu * torch.randn((), generator=rng, device=rng.device)
        th = mu + s_t * torch.randn((self.ngroups,), generator=rng, device=rng.device)
        return torch.cat([mu[None], th])

    def posterior_moments(self):
        """Closed-form posterior mean and covariance of (mu, theta)."""
        g = self.ngroups
        prec = np.zeros((self.ndim, self.ndim))
        prec[0, 0] = 1.0 / self.s_mu**2 + g / self.s_t**2
        prec[0, 1:] = prec[1:, 0] = -1.0 / self.s_t**2
        np.fill_diagonal(prec[1:, 1:], 1.0 / self.s_t**2 + 1.0 / self.s_y**2)
        b = np.zeros(self.ndim)
        b[1:] = self.y / self.s_y**2
        cov = np.linalg.inv(prec)
        return cov @ b, cov
