"""Core numeric ops: eigensolvers (the eigh9 kernel in `ops.eigh9` and its
plain Jacobi version) and the weighted 8-point solve."""

from .eigh import DEFAULT_GAP_EPS, safe_eigh, smallest_eigvec, smallest_singular_vec_gram
from .fmatrix import FitResult, weighted_eight_point
from .jacobi import jacobi_eigh
from .svd3 import project_E_110, rank2_projection, singular_values_3x3

__all__ = [k for k in dir() if not k.startswith("_")]
