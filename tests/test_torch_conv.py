"""Port parity: the fused 3x3 conv + affine + ReLU (kernel K5).

- The plain version (`conv3x3_affine_relu_ref`) against the JAX kernel
  `conv3x3_affine_relu(backend="pallas")` in interpret mode, at
  tests/test_conv_pallas.py's three shapes (Cin = 1 with ragged edges, an
  aligned 64 -> 64, an odd small one), with that test's forward bar: atol
  5e-5 (float32 sums of up to 576 products in another order).
- The wrapper on a CPU tensor is the plain version, bit for bit.
- The wrapper refuses a tensor that is not on the CPU, with or without
  grad, and never falls back to the plain version off the CPU; the `meta`
  device stands in for a card here.
- The kernel itself against the plain version on the card is in
  tests/test_torch_cuda_kernels.py, which imports no JAX; the backward
  (K5b) is tested in tests/test_torch_conv_bwd.py.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepfepe_tpu.ops.pallas.conv_pallas import conv3x3_affine_relu as jconv

conv = importlib.import_module("deepfepe_tpu_torch.ops.conv")

SHAPES = [(2, 13, 17, 1, 64), (1, 16, 32, 64, 64), (3, 9, 21, 5, 8)]
IDS = ["cin1_pad", "aligned64", "odd_small"]


def _inputs(shape, seed=0):
    B, H, W, Cin, C = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, Cin).astype(np.float32)
    w = (rng.randn(3, 3, Cin, C) * 0.1).astype(np.float32)
    s = (rng.randn(C) * 0.5 + 1.0).astype(np.float32)
    t = (rng.randn(C) * 0.1).astype(np.float32)
    return x, w, s, t


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_matches_the_jax_kernel(shape):
    args = _inputs(shape)
    want = np.asarray(jconv(*map(jnp.asarray, args), backend="pallas"))
    targs = [torch.from_numpy(a) for a in args]
    got = conv.conv3x3_affine_relu_ref(*targs)
    assert got.shape == want.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)
    before = conv.conv3x3_affine_relu.launches
    assert torch.equal(conv.conv3x3_affine_relu(*targs), got)
    assert conv.conv3x3_affine_relu.launches == before


def test_images_do_not_bleed_into_each_other():
    """SAME padding per image: an image's output depends on it alone."""
    x, w, s, t = (torch.from_numpy(a) for a in _inputs((3, 9, 21, 5, 8), seed=1))
    whole = conv.conv3x3_affine_relu_ref(x, w, s, t)
    for b in range(3):
        one = conv.conv3x3_affine_relu_ref(x[b:b + 1].contiguous(), w, s, t)
        torch.testing.assert_close(whole[b:b + 1], one, rtol=0, atol=0)


def test_off_cpu_the_wrapper_raises_and_never_falls_back():
    x, w, s, t = (torch.empty(a.shape, device="meta") for a in _inputs((1, 8, 8, 4, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        conv.conv3x3_affine_relu(x.requires_grad_(True), w, s, t)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        conv.conv3x3_affine_relu(x, w, s, t)


def test_full_f32_restores_the_cudnn_flag():
    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        with conv.full_f32():
            assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = saved
