"""PyTorch/CUDA port of ptmcmcsampler_tpu for an NVIDIA H100.

The JAX package ``ptmcmcsampler_tpu`` is the reference; this package ports
it module by module (same module names) and replaces its Pallas kernels with
kernels written by hand for Hopper. Entry points (``PTSampler``,
``build_step``) run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``. ``register_functor`` (``ops/user.py``) puts a user's
model into the CUDA kernels.
"""

from .config import JumpSpec, SamplerConfig, build_default_jumps
from .kernel import build_step
from .ladder import ladder_betas, temperature_ladder
from .ops.user import register_functor
from .sampler import PTSampler
from .state import init_state, state_from_numpy, state_to_numpy

__all__ = [
    "JumpSpec",
    "PTSampler",
    "SamplerConfig",
    "build_default_jumps",
    "build_step",
    "init_state",
    "ladder_betas",
    "register_functor",
    "state_from_numpy",
    "state_to_numpy",
    "temperature_ladder",
]
