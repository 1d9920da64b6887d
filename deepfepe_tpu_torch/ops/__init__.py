"""Core numeric ops: eigensolvers (the eigh9 kernel in `ops.eigh9` and its
plain Jacobi version), the weighted 8-point solve and the NaN scrub. The
other kernels' modules are imported by name: `ops.mlp` (K2, K2b),
`ops.conv` (K5, K5b), `ops.matcher` (K4), `ops.epi_residual` (K3 and
its backward, behind `geometry.compute_epi_residual`) and
`ops.conv_formulations` (X1-X4, behind the conv-formulation tool)."""

import torch as _torch


def set_nan2zero(x, name: str = "network"):
    """NaN/Inf scrub (parity: models/model_utils.set_nan2zero :5), for input
    sanitization of external data; the solver path needs none."""
    return _torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


from .eigh import DEFAULT_GAP_EPS, safe_eigh, smallest_eigvec, smallest_singular_vec_gram
from .fmatrix import FitResult, weighted_eight_point
from .jacobi import jacobi_eigh
from .svd3 import project_E_110, rank2_projection, singular_values_3x3

__all__ = [k for k in dir() if not k.startswith("_")]
