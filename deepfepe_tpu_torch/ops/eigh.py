"""Batched symmetric eigendecomposition with degenerate-safe gradients.

Counterpart of `deepfepe_tpu/ops/eigh.py`. `safe_eigh`'s backward is the
eigh VJP with Lorentzian-broadened gap reciprocals
    F_ij = (λ_j - λ_i) / ((λ_j - λ_i)² + eps),
exact for well-separated spectra and bounded at degeneracies.

Routing: a 9x9 CUDA tensor goes to the eigh9 kernel at any batch size;
everything else (CPU tensors, the 3x3 solves) goes to the plain Jacobi.
Both return eigenpairs sorted ascending with the sign convention of
`ops.jacobi.sort_and_fix_signs`.
"""

from __future__ import annotations

import torch

from .eigh9 import eigh9
from .jacobi import jacobi_eigh

DEFAULT_GAP_EPS = 1e-10


def _eigh_forward(A: torch.Tensor):
    # Both solvers symmetrize A themselves.
    if A.is_cuda and A.shape[-1] == 9:
        return eigh9(A.contiguous())
    return jacobi_eigh(A)


class _SafeEigh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, gap_eps):
        w, V = _eigh_forward(A)
        ctx.gap_eps = gap_eps
        ctx.save_for_backward(w, V)
        return w, V

    @staticmethod
    def backward(ctx, dw, dV):
        w, V = ctx.saved_tensors
        Vt = V.transpose(-1, -2)
        gaps = w[..., None, :] - w[..., :, None]  # [..., i, j] = λ_j - λ_i
        Fmat = gaps / (gaps * gaps + ctx.gap_eps)
        inner = Fmat * (Vt @ dV)
        dA = V @ (torch.diag_embed(dw) + inner) @ Vt
        return (dA + dA.transpose(-1, -2)) * 0.5, None


def safe_eigh(A: torch.Tensor, gap_eps: float = DEFAULT_GAP_EPS):
    """Eigendecomposition of symmetric [..., n, n] -> (w, V), ascending, with
    the degenerate-safe backward. `A` is symmetrized first."""
    return _SafeEigh.apply(A, gap_eps)


def smallest_eigvec(A: torch.Tensor, gap_eps: float = DEFAULT_GAP_EPS):
    """Smallest eigenpair of symmetric [..., n, n] -> (λ_min [...], v [..., n])."""
    w, V = safe_eigh(A, gap_eps)
    return w[..., 0], V[..., :, 0]


def smallest_singular_vec_gram(X: torch.Tensor, gap_eps: float = DEFAULT_GAP_EPS,
                               accumulate: torch.dtype = torch.float32):
    """Smallest right singular vector of [..., N, k] via the k x k Gram
    matrix XᵀX (a plain matmul, summed in at least `accumulate` and
    rounded back to X's type)."""
    acc = torch.promote_types(X.dtype, accumulate)
    Xa = X.to(acc)
    G = (Xa.transpose(-1, -2) @ Xa).to(X.dtype)
    _, v = smallest_eigvec(G, gap_eps)
    return v

