"""The frontend kernels on the card: K5 and K5b (`csrc/conv3x3.cu`) and
K4 (`csrc/matcher.cu`) against their plain versions.

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
"""

import importlib

import numpy as np
import pytest
import torch

conv = importlib.import_module("deepfepe_tpu_torch.ops.conv")
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
