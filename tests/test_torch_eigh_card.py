"""The eigh9 kernels on the card (`csrc/eigh9.cu`) against their plain
version, `ops.jacobi.jacobi_eigh`.

This file imports torch and the port only, so it runs on a machine with
the card and without JAX or flax:

    python3 -m pytest tests/test_torch_eigh_card.py -m cuda -q

Every test is marked `cuda` and skips without a card; the card is looked
for inside the `cuda` fixture. Inputs come from numpy seeds.

- The routed wrapper at B = 1, 8, 4096 and 4097: one launch a call,
  eigenvalues within 1e-5 of ||A||_2 and the residual within 1e-5.
- Both kernels do the plain version's operations in its order, each
  rounded on its own: the same bits at B = 4 and 800.
- The fused sort and sign fix alone (no sweeps), repeated eigenvalues and
  tied largest components within 1e-6 of the plain version, every
  column's pivot positive; a NaN matrix stays in its row;
  `safe_eigh` sends 9x9 (not 3x3) matrices to the kernel.
"""

import numpy as np
import pytest
import torch

from deepfepe_tpu_torch.ops import eigh as t_eigh
from deepfepe_tpu_torch.ops import eigh9 as t_eigh9
from deepfepe_tpu_torch.ops.jacobi import jacobi_eigh as t_jacobi
from deepfepe_tpu_torch.ops.jacobi import sort_and_fix_signs


def _gram(rng, b, rows, dtype):
    X = rng.randn(b, rows, 9)
    X /= np.linalg.norm(X, axis=-1, keepdims=True)
    return (X.transpose(0, 2, 1) @ X).astype(dtype)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8, 4096, 4097])
def test_eigh9_kernel_matches_plain_on_card(rng, cuda, B):
    A = torch.from_numpy(_gram(rng, B, 8 if B > 8 else 1000, "float32")).to(cuda)
    before = t_eigh9.eigh9.launches
    w, V = t_eigh9.eigh9(A)
    torch.cuda.synchronize()
    assert t_eigh9.eigh9.launches == before + 1
    wr, Vr = t_jacobi(A)
    scale = wr.abs().amax(-1, keepdim=True)  # ||A||_2
    assert ((w - wr).abs() / scale).max() < 1e-5
    resid = (A @ V - V * w[:, None, :]).norm(dim=(-1, -2)) / scale[:, 0]
    assert resid.max() < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["warp", "thread"])
@pytest.mark.parametrize("B", [4, 800])
def test_eigh9_both_kernels_match_plain_on_card(rng, cuda, kernel, B):
    """Both kernels do the plain version's operations in its order, each
    rounded on its own: the same bits."""
    A = torch.from_numpy(_gram(rng, B, 20 if B > 8 else 1000, "float32")).to(cuda)
    w, V = t_eigh9.launch(A, kernel=kernel)
    wr, Vr = t_jacobi(A)
    assert torch.equal(w, wr) and torch.equal(V, Vr)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["warp", "thread"])
def test_eigh9_fused_sort_is_stable_on_card(rng, cuda, kernel):
    """With no sweeps the fused epilogue alone runs: the diagonal of the
    symmetrized input, with repeated values, sorted stably, and V the
    matching permutation, as sort_and_fix_signs gives them."""
    A = rng.randn(6, 9, 9).astype(np.float32)
    A[:, range(9), range(9)] = rng.randint(0, 3, (6, 9))
    A = torch.from_numpy(A).to(cuda)
    w, V = t_eigh9.launch(A, sweeps=0, kernel=kernel)
    eye = torch.eye(9, device=cuda).expand(6, 9, 9)
    wr, Vr = sort_and_fix_signs(torch.diagonal((A + A.transpose(-1, -2)) * 0.5, dim1=-2, dim2=-1),
                                eye)
    assert torch.equal(w, wr) and torch.equal(V, Vr)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["warp", "thread"])
@pytest.mark.parametrize("case", ["rank_deficient", "abs_ties"])
def test_eigh9_fused_epilogue_matches_sort_and_fix_signs_on_card(rng, cuda, kernel, case):
    """Repeated eigenvalues (a Gram of 4 rows: five zeros) and eigenvectors
    whose largest |.| ties ((1, -1) / sqrt(2) in 2x2 blocks: the first
    index is the pivot): the kernel against the plain version on the card,
    and every column's first largest-|.| entry positive."""
    if case == "rank_deficient":
        A = _gram(rng, 16, 4, "float32")
    else:
        A = np.zeros((4, 9, 9), np.float32)
        for i in range(0, 8, 2):
            A[:, i:i + 2, i:i + 2] = [[1.0 + i, 0.5], [0.5, 1.0 + i]]
        A[:, 8, 8] = 0.25
    A = torch.from_numpy(A).to(cuda)
    w, V = t_eigh9.launch(A, kernel=kernel)
    wr, Vr = t_jacobi(A)
    assert (w - wr).abs().max() <= 1e-6 and (V - Vr).abs().max() <= 1e-6
    pivot = torch.gather(V, -2, torch.argmax(V.abs(), dim=-2, keepdim=True))
    assert (pivot > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["warp", "thread"])
def test_eigh9_nan_matrix_stays_in_its_row_on_card(rng, cuda, kernel):
    A = torch.from_numpy(_gram(rng, 8, 50, "float32")).to(cuda)
    bad = A.clone()
    bad[3, 2, 5] = float("nan")
    w, V = t_eigh9.launch(bad, kernel=kernel)
    w0, V0 = t_eigh9.launch(A, kernel=kernel)
    wr, Vr = t_jacobi(bad)
    assert torch.equal(torch.isfinite(w), torch.isfinite(wr))
    assert torch.equal(torch.isfinite(V), torch.isfinite(Vr))
    assert not torch.isfinite(w[3]).any()
    keep = torch.arange(8, device=cuda) != 3
    assert torch.equal(w[keep], w0[keep]) and torch.equal(V[keep], V0[keep])


@pytest.mark.cuda
def test_safe_eigh_routes_9x9_to_the_kernel_on_card(rng, cuda):
    A = torch.from_numpy(_gram(rng, 3, 50, "float32")).to(cuda)
    before = t_eigh9.eigh9.launches
    t_eigh.safe_eigh(A)
    t_eigh.safe_eigh(A[:, :3, :3])
    assert t_eigh9.eigh9.launches == before + 1
