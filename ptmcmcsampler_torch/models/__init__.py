from .examples import (
    CorrelatedGaussian,
    CurvedLikelihood,
    HierarchicalGaussian,
    IntervalTransformedGaussian,
)

__all__ = [
    "CorrelatedGaussian",
    "CurvedLikelihood",
    "HierarchicalGaussian",
    "IntervalTransformedGaussian",
]
