from .examples import CurvedLikelihood

__all__ = ["CurvedLikelihood"]
