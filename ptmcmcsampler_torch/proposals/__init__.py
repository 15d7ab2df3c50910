"""Batched proposal kernels."""
