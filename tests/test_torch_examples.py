"""The port's example twins and the public names it shares with the JAX
package.

* ``examples/simple_torch.py``, ``curved_likelihood_torch.py`` and
  ``gaussian_likelihood_torch.py`` run to their end on the CPU in a
  subprocess at small counts (``--device cpu --nchains 8 --niter 200``) and
  print what their JAX twins print; the simple twin's custom jump is
  torch-native, the curved twin takes the kernel route with NUTS and HMC.
* ``IntervalTransformedGaussian.backward`` and ``._log_jacobian`` against
  the JAX model's on 256 seeded points with ``p`` in [-30, 30]
  (``rtol=1e-6, atol=1e-6`` and ``rtol=1e-5, atol=1e-5``: the two packages
  round their f32 sigmoid and ``log1p(exp)`` sums apart), on a point, a
  numpy batch and a chain-minor tensor batch.
* ``ladder_betas`` and ``temperature_ladder`` exported as the JAX
  package's, and equal to them.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ptmcmcsampler_torch
import ptmcmcsampler_tpu
from ptmcmcsampler_torch.models import IntervalTransformedGaussian
from ptmcmcsampler_tpu.models import IntervalTransformedGaussian as JInterval

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 8

TWINS = {
    "simple_torch.py": "posterior mean error:",
    "curved_likelihood_torch.py": "cold-chain mean:",
    "gaussian_likelihood_torch.py": "posterior mean (box coords):",
}


@pytest.mark.parametrize("script", sorted(TWINS))
def test_example_twin_runs_on_the_cpu(script, tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", script), "--device", "cpu",
         "--nchains", "8", "--niter", "200", "--outdir", str(tmp_path / "chains")],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = next(x for x in proc.stdout.splitlines() if x.startswith(TWINS[script]))
    values = [float(v) for v in line[len(TWINS[script]):].replace("[", " ").replace(
        "]", " ").replace("...", " ").split()]
    assert values and np.all(np.isfinite(values)), line
    assert os.path.isfile(tmp_path / "chains" / "chain_1.0.txt")
    if script == "curved_likelihood_torch.py":
        assert "route: kernel" in proc.stdout


def _points(seed=0):
    return np.random.default_rng(seed).uniform(-30.0, 30.0, (256, D)).astype(np.float32)


def test_backward_matches_jax():
    p = _points()
    want = np.asarray(jax.vmap(JInterval(D).backward)(jnp.asarray(p)))
    port = IntervalTransformedGaussian(D)
    got = port.backward(p)  # a numpy batch, elementwise
    assert isinstance(got, np.ndarray) and got.shape == p.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port.backward(p[3]), want[3], rtol=1e-6, atol=1e-6)
    t = port.backward(torch.as_tensor(p.T[None]))  # chain-minor [1, D, C]
    assert isinstance(t, torch.Tensor)
    np.testing.assert_allclose(t[0].numpy().T, want, rtol=1e-6, atol=1e-6)


def test_log_jacobian_matches_jax():
    p = _points(1)
    want = np.asarray(jax.vmap(JInterval(D)._log_jacobian)(jnp.asarray(p)))
    port = IntervalTransformedGaussian(D)
    got = np.array([port._log_jacobian(x) for x in p])  # one point at a time
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    batch = port._log_jacobian(torch.as_tensor(p.T[None]))  # [1, C]
    assert batch.shape == (1, 256)
    np.testing.assert_allclose(batch[0].numpy(), want, rtol=1e-5, atol=1e-5)


def test_log_jacobian_is_the_likelihood_term():
    """``lnlike`` is the base Gaussian of ``backward(p)`` plus ``_log_jacobian``
    (the JAX model's ``lnlikefn``), in the port's own operations."""
    port = IntervalTransformedGaussian(D)
    p = torch.as_tensor(_points(2).T[None])
    x = port.backward(p)
    base = -0.5 * torch.sum(x * x, dim=-2) - port._c0
    np.testing.assert_allclose((base + port._log_jacobian(p)).numpy(),
                               port.lnlike(p).numpy(), rtol=1e-6, atol=1e-4)


def test_ladder_names_exported_as_in_the_jax_package():
    for name in ("ladder_betas", "temperature_ladder"):
        assert name in ptmcmcsampler_torch.__all__
        assert hasattr(ptmcmcsampler_tpu, name)
    ladder = ptmcmcsampler_torch.temperature_ladder(D, 6, tmax=40.0)
    np.testing.assert_array_equal(ladder, ptmcmcsampler_tpu.temperature_ladder(D, 6, tmax=40.0))
    got = ptmcmcsampler_torch.ladder_betas(ladder, hot_chain=True)
    want = ptmcmcsampler_tpu.ladder_betas(ladder, hot_chain=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
