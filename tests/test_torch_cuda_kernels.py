"""Kernels on the card against their plain versions: K5 and K5b
(`csrc/conv3x3.cu`), K4 (`csrc/matcher.cu`) and K3 with its backward
(`csrc/epi_residual.cu`).

This file imports torch and the port only, so it runs on a machine with
the card and without JAX:

    python3 -m pytest tests/test_torch_cuda_kernels.py -m cuda -q

Every test is marked `cuda` and skips without a card. Inputs come from
numpy seeds.

- K5 at tests/test_conv_pallas.py's three shapes and a 64 -> 128 one:
  within 5e-5 of max(1, max|y|) of the plain version (that test's atol,
  for outputs of magnitude about 1-10; float32 sums in another order).
- K5b at the same shapes: dx, dw, dscale and dbias each within 1e-4 of
  the plain version's largest entry (tests/test_conv_pallas.py's bar for
  the gradients). With need_dx=False dx is exactly zero and dw within
  rtol = atol = 1e-5 of the plain version's (that file's need_dx test).
  Through autograd, the Function launches K5 once and K5b once and its
  gradients are the plain backward's on the same inputs.
- K4 on sign-vector descriptors (every similarity exact in any summation
  order, ties frequent): nn12, nn21, dist12 and mutual equal the plain
  version's exactly, ties to the lowest index.
- K3 at DeepFNet's, the F-loss's and a ragged sample-loss shape: the
  residual at tests/test_jacobi.py's bar (rtol 1e-4, atol 1e-5), each
  gradient within 1e-5 of its largest entry, the zero-row F's exactly 0;
  through `compute_epi_residual` with exact launch counts.
"""

import importlib

import numpy as np
import pytest
import torch

conv = importlib.import_module("deepfepe_tpu_torch.ops.conv")
epi = importlib.import_module("deepfepe_tpu_torch.ops.epi_residual")
matcher = importlib.import_module("deepfepe_tpu_torch.ops.matcher")

CONV_SHAPES = [(2, 13, 17, 1, 64), (1, 16, 32, 64, 64), (3, 9, 21, 5, 8), (2, 40, 150, 64, 128)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CONV_SHAPES,
                         ids=["cin1_pad", "aligned64", "odd_small", "c64to128"])
def test_k5_matches_plain_on_the_card(cuda, shape):
    B, H, W, Cin, C = shape
    rng = np.random.RandomState(0)
    args = (rng.randn(B, H, W, Cin), rng.randn(3, 3, Cin, C) * 0.1, rng.randn(C) * 0.5 + 1.0,
            rng.randn(C) * 0.1)
    x, w, s, t = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in args)
    with torch.no_grad():
        y = conv.conv3x3_affine_relu(x, w, s, t)
        ref = conv.conv3x3_affine_relu_ref(x, w, s, t)
    torch.cuda.synchronize()
    assert (y - ref).abs().max().item() <= 5e-5 * max(1.0, ref.abs().max().item())


def _bwd_inputs(shape, device, seed=0):
    """Forward inputs, the plain forward's y and a cotangent dy."""
    B, H, W, Cin, C = shape
    rng = np.random.RandomState(seed)
    args = (rng.randn(B, H, W, Cin), rng.randn(3, 3, Cin, C) * 0.1, rng.randn(C) * 0.5 + 1.0,
            rng.randn(C) * 0.1, rng.randn(B, H, W, C))
    x, w, s, t, dy = (torch.from_numpy(a.astype(np.float32)).to(device) for a in args)
    return x, w, s, t, conv.conv3x3_affine_relu_ref(x, w, s, t), dy


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CONV_SHAPES,
                         ids=["cin1_pad", "aligned64", "odd_small", "c64to128"])
def test_k5b_matches_plain_on_the_card(cuda, shape):
    args = _bwd_inputs(shape, cuda)
    before = conv.conv3x3_affine_relu_bwd.launches
    got = conv.conv3x3_affine_relu_bwd(*args)
    want = conv.conv3x3_affine_relu_bwd_ref(*args)
    torch.cuda.synchronize()
    assert conv.conv3x3_affine_relu_bwd.launches == before + 1
    for name, a, b in zip(("dx", "dw", "dscale", "dbias"), got, want):
        assert a.shape == b.shape, name
        rel = (a - b).abs().max().item() / (b.abs().max().item() + 1e-9)
        assert rel < 1e-4, (name, rel)


@pytest.mark.cuda
def test_k5b_need_dx_false_on_the_card(cuda):
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(1, 12, 20, 1).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.randn(3, 3, 1, 8).astype(np.float32)).to(cuda)
    s, t = torch.ones(8, device=cuda), torch.zeros(8, device=cuda)
    y = conv.conv3x3_affine_relu_ref(x, w, s, t)
    dy = torch.ones_like(y)
    dx, dw, _, _ = conv.conv3x3_affine_relu_bwd(x, w, s, t, y, dy, need_dx=False)
    _, dw_ref, _, _ = conv.conv3x3_affine_relu_bwd_ref(x, w, s, t, y, dy, need_dx=True)
    torch.cuda.synchronize()
    assert dx.abs().max().item() == 0.0
    torch.testing.assert_close(dw, dw_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_k5_k5b_through_autograd_on_the_card(cuda):
    x, w, s, t, _, dy = _bwd_inputs((2, 40, 150, 64, 128), cuda, seed=3)
    leaves = [a.clone().requires_grad_(True) for a in (x, w, s, t)]
    counts = conv.conv3x3_affine_relu.launches, conv.conv3x3_affine_relu_bwd.launches
    y = conv.conv3x3_affine_relu(*leaves)
    (y * dy).sum().backward()
    torch.cuda.synchronize()
    assert (conv.conv3x3_affine_relu.launches, conv.conv3x3_affine_relu_bwd.launches) == \
        (counts[0] + 1, counts[1] + 1)
    want = conv.conv3x3_affine_relu_bwd_ref(x, w, s, t, y.detach(), dy)
    for leaf, b in zip(leaves, want):
        rel = (leaf.grad - b).abs().max().item() / (b.abs().max().item() + 1e-9)
        assert rel < 1e-4, rel


@pytest.mark.cuda
@pytest.mark.parametrize("B,K", [(2, 1000), (4, 2048)])
def test_k4_matches_plain_on_the_card(cuda, B, K):
    rng = np.random.RandomState(B)
    D = 256
    d1, d2 = ((rng.choice([-1.0, 1.0], (B, K, D)) / np.sqrt(D)).astype(np.float32)
              for _ in range(2))
    v1, v2 = rng.rand(B, K) < 0.8, rng.rand(B, K) < 0.8
    args = [torch.from_numpy(a).to(cuda) for a in (d1, d2, v1, v2)]
    got = matcher.mutual_nn_kernel(*args)
    want = matcher.mutual_nn_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _epi_case(P, M, N, cuda, seed):
    """Points near the epipolar lines of a sideways translation, matrices
    that translation plus noise: some residuals clamped at 0.02, most not."""
    rng = np.random.RandomState(seed)
    x1 = np.concatenate([rng.uniform(-1, 1, (P, N, 2)), np.ones((P, N, 1))], -1)
    x2 = x1.copy()
    x2[..., 0] = rng.uniform(-1, 1, (P, N))
    x2[..., 1] += 0.01 * rng.randn(P, N)
    F = np.array([0.0, 0, 0, 0, 0, -1, 0, 1, 0]) + 0.002 * rng.randn(P, M, 9)
    F[0, 0, :6] = 0.0  # a zero-row F: (F x1)_xy = 0
    return [torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (x1, x2, F)]


@pytest.mark.cuda
@pytest.mark.parametrize("P,M,N", [(3, 1, 1000), (2, 5, 100), (2, 130, 37)])
def test_k3_matches_plain_on_the_card(cuda, P, M, N):
    """K3 (csrc/epi_residual.cu) and its backward kernels against the plain
    versions on the card: the residual at tests/test_jacobi.py's bar for
    the Pallas kernel (rtol 1e-4, atol 1e-5), each gradient within 1e-5 of
    its largest entry (float32 sums of up to 1,000 terms in another order),
    the zero-row F's gradient exactly 0."""
    x1, x2, F9 = _epi_case(P, M, N, cuda, seed=M)
    g = torch.randn(P, M, N, device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    d = epi.epi_residual_fwd(x1, x2, F9, 0.02, 1e-6)
    got = epi.epi_residual_bwd(x1, x2, F9, g, 0.02, 1e-6)
    want = epi.epi_residual_bwd_ref(x1, x2, F9, g, 0.02, 1e-6)
    ref = epi.epi_residual_ref(x1[:, None], x2[:, None], F9.view(P, M, 3, 3), 0.02)
    torch.cuda.synchronize()
    torch.testing.assert_close(d, ref, rtol=1e-4, atol=1e-5)
    assert 0.05 < (ref < 0.02).float().mean().item() < 0.95
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()
    assert got[0][0, 0].abs().max().item() == 0.0


@pytest.mark.cuda
def test_k3_through_compute_epi_residual_on_the_card(cuda):
    """The F-loss's broadcast through the route: one forward and one
    backward launch, gradients as the plain version's; a float64 CUDA
    tensor raises, never falls back."""
    from deepfepe_tpu_torch.geometry.epipolar import compute_epi_residual

    x1, x2, F9 = _epi_case(4, 3, 50, cuda, seed=7)
    pts1, pts2 = x1[None], x2[None]                      # [1, B, V, 3]
    F = F9.view(4, 3, 3, 3).transpose(0, 1).contiguous().requires_grad_()  # [L, B, 3, 3]
    counts = epi.epi_residual.launches, epi.epi_residual_bwd.launches
    out = compute_epi_residual(pts1, pts2, F, clamp_at=0.02)
    (gF,) = torch.autograd.grad(out.mean(), F)
    ref = epi.epi_residual_ref(pts1, pts2, F, 0.02)
    (gF_ref,) = torch.autograd.grad(ref.mean(), F)
    torch.cuda.synchronize()
    assert (epi.epi_residual.launches, epi.epi_residual_bwd.launches) == \
        (counts[0] + 1, counts[1] + 1)
    assert out.shape == (3, 4, 50)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    assert (gF - gF_ref).abs().max().item() <= 1e-5 * gF_ref.abs().max().item()
    with pytest.raises(ValueError, match="float32"):
        compute_epi_residual(pts1.double(), pts2.double(), F.detach().double())
