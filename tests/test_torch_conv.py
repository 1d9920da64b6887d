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
- The kernels' arithmetic, emulated in torch: three TF32 passes (each
  float32 operand split into hi, rounded to TF32 to nearest on the float32
  bits, and lo = the rest, of which the tensor cores read the top 19 bits;
  products lo hi + hi lo + hi hi, the sum folded in float32 once an
  input-channel chunk as `csrc/conv3x3.cu` does) land
  within chip_smoke.py's CONV_ATOL of float64 at Cin = 64 and 128 (K = 576
  and 1152), where one TF32 pass does not; and the weight gradient's three
  passes, folded once a 128-pixel tile, within its CONV_BWD_REL.
- The kernel itself against the plain version on the card is in
  tests/test_torch_cuda_kernels.py, which imports no JAX; the backward
  (K5b) is tested in tests/test_torch_conv_bwd.py.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import torch.nn.functional as F

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


# chip_smoke.py's bars: K5 within CONV_ATOL x max(1, max|y|) of float64, each
# K5b gradient within CONV_BWD_REL of its largest float64 entry.
CONV_ATOL, CONV_BWD_REL = 5e-5, 1e-4
CHUNK, TILE_PX = 8, 128  # the kernels' input-channel chunk and wgrad pixel tile


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 stored mantissa bits), to nearest with
    ties away from zero, on the bits: the kernels' cvt.rna.tf32.f32."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(a: torch.Tensor):
    """The kernels' split: hi = TF32 to nearest, lo = a - hi (exact in
    float32) as the MMA reads it, its low 13 bits dropped."""
    hi = _tf32(a)
    lo = (a - hi).contiguous().view(torch.int32) & -0x2000
    return hi, lo.view(torch.float32)


def _path_inputs(Cin: int, C: int = 64, B: int = 2, H: int = 12, W: int = 20, seed: int = 0):
    """chip_smoke.py's conv inputs: ReLU outputs, lecun-scaled weights,
    folded-BN-like affines; float32 from numpy."""
    rng = np.random.RandomState(seed)
    x = np.maximum(rng.randn(B, H, W, Cin), 0.0)
    w = rng.randn(3, 3, Cin, C) / np.sqrt(9 * Cin)
    s, t = rng.rand(C) + 0.5, 0.1 * rng.randn(C)
    return [torch.from_numpy(a.astype(np.float32)) for a in (x, w, s, t)]


def _conv64(x, w):
    return F.conv2d(x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1),
                    padding=1).permute(0, 2, 3, 1)


def _tf32_forward(x, w, s, t, passes: int):
    """K5 with products in `passes` TF32 passes (1: hi hi; 3: lo hi + hi lo +
    hi hi), each exact (float64), summed a chunk of CHUNK input channels at
    a time and the chunks added in float32, in the kernel's order."""
    (xh, xl), (wh, wl) = _split(x), _split(w)
    pairs = [(xh, wh)] if passes == 1 else [(xl, wh), (xh, wl), (xh, wh)]
    total = torch.zeros(*x.shape[:3], w.shape[-1])
    for k in range(0, x.shape[-1], CHUNK):
        part = sum(_conv64(a[..., k:k + CHUNK], b[:, :, k:k + CHUNK]) for a, b in pairs)
        total = total + part.float()
    return torch.relu(total * s + t)


def _within_conv_atol(Cin: int, passes: int) -> tuple[float, float]:
    x, w, s, t = _path_inputs(Cin)
    y64 = torch.relu(_conv64(x, w) * s.double() + t.double())
    err = (_tf32_forward(x, w, s, t, passes).double() - y64).abs().max().item()
    return err, CONV_ATOL * max(1.0, y64.abs().max().item())


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10  # the TF32 step above 1
    v = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, one + 2.0 ** -11,
                      3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one, -one, 1.0, one + 2.0 ** -10, 3.0, 0.0], dtype=torch.float32)
    assert torch.equal(_tf32(v), want)
    hi, lo = _split(torch.tensor([1.0 + 2.0 ** -11 + 2.0 ** -20, 1.0 + 2.0 ** -20]))
    assert hi.tolist() == [one, 1.0]
    assert lo.tolist() == [-(2.0 ** -11) + 2.0 ** -20, 2.0 ** -20]


@pytest.mark.parametrize("Cin", [64, 128], ids=["K576", "K1152"])
def test_three_tf32_passes_hold_conv_atol(Cin):
    err, bar = _within_conv_atol(Cin, passes=3)
    assert err <= bar / 10, (err, bar)


@pytest.mark.parametrize("Cin", [64, 128], ids=["K576", "K1152"])
def test_one_tf32_pass_misses_conv_atol(Cin):
    """The bar discriminates: a single TF32 pass (about 11 bits a factor)
    lands outside it at the path's K."""
    err, bar = _within_conv_atol(Cin, passes=1)
    assert err > bar, (err, bar)


def test_three_tf32_passes_hold_the_weight_gradient_bar():
    """dw[tap, ci, c] = sum_p x_shift(tap)[p, ci] dz[p, c] over 3,840 pixels
    with three TF32 passes, summed a 128-pixel tile at a time in float32 as
    K5b's weight gradient does: within CONV_BWD_REL of float64."""
    x, w, s, t = _path_inputs(64, B=2, H=16, W=120, seed=1)
    rng = np.random.RandomState(2)
    dz = torch.from_numpy(rng.randn(*x.shape[:3], 64).astype(np.float32))
    xpad = F.pad(x, (0, 0, 1, 1, 1, 1))
    B, H, W, _ = x.shape
    shifted = [xpad[:, ky:ky + H, kx:kx + W].reshape(-1, 64) for ky in range(3) for kx in range(3)]
    flat_dz = dz.reshape(-1, 64)
    dw64 = torch.stack([a.double().T @ flat_dz.double() for a in shifted])
    (dh, dl) = _split(flat_dz)
    dw = torch.zeros(9, 64, 64)
    for p in range(0, flat_dz.shape[0], TILE_PX):
        for tap, a in enumerate(shifted):
            ah, al = _split(a[p:p + TILE_PX])
            part = sum(u.double().T @ v[p:p + TILE_PX].double()
                       for u, v in ((al, dh), (ah, dl), (ah, dh)))
            dw[tap] += part.float()
    rel = (dw.double() - dw64).abs().max().item() / dw64.abs().max().item()
    assert rel <= CONV_BWD_REL / 10, rel
