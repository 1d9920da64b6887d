"""The bf16 K5 and K5b kernels (`csrc/conv3x3_bf16.cu`) on the card against
their plain versions (`ops/conv_bf16.py`).

This file imports torch and the port only, so it runs on a machine with
the card and without JAX:

    python3 -m pytest tests/test_torch_conv_bf16_card.py -m cuda -q

Every test but the last two is marked `cuda` and skips without a card.
Inputs come from numpy seeds.

- K5 at every (Cin, C) the kernels take, at a ragged small size and at the
  SuperPoint path's widths reduced in B and H: within one bf16 ulp of the
  plain version plus a float32 floor, |d| <= 2^-7 |plain| + 1e-5 (both sum
  exact bf16 products in float32, in other orders, and round once; the
  conv-formulation kernels' bar).
- K5b at the same shapes, need_dx both ways: dx and dw (bf16) within one
  ulp plus 1e-4 of the largest entry (float32 sums of up to 10^5 terms in
  another order; the f32 K5b's bar for its float32 gradients), dscale and
  dbias (float32) within 1e-4 of their largest entry; with need_dx=False
  dx is exactly zero. Two calls give the same bits.
- Through autograd the Function launches the bf16 kernels once each and
  returns their gradients; the forward's block layout matches the C
  source's rule (resident weights beside two or more halo stages, else
  streamed).
- Off the card the wrappers take the plain versions, and on a device that
  is not the CPU they raise rather than fall back.
"""

import importlib

import numpy as np
import pytest
import torch

conv = importlib.import_module("deepfepe_tpu_torch.ops.conv")
cb = importlib.import_module("deepfepe_tpu_torch.ops.conv_bf16")

CHANNELS = [(1, 64), (64, 64), (64, 128), (128, 128)]
SMALL = [(2, 13, 22, cin, c) for cin, c in CHANNELS]
# The path's layer shapes (inc at 376 x 1240, down1 at 188 x 620, down2 at
# 94 x 310), B and H cut.
PATH = [(1, 24, 1240, 1, 64), (1, 20, 1240, 64, 64), (2, 36, 620, 64, 64),
        (2, 94, 310, 64, 128), (2, 94, 310, 128, 128)]
ULP, FLOOR, REL = 2.0 ** -7, 1e-5, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _inputs(shape, device, seed=0):
    B, H, W, Cin, C = shape
    rng = np.random.RandomState(seed)
    x = rng.rand(B, H, W, Cin) if Cin == 1 else np.maximum(rng.randn(B, H, W, Cin), 0)
    w = rng.randn(3, 3, Cin, C) / np.sqrt(9 * Cin)
    s = rng.rand(C) + 0.5
    s[::4] = 1 + 2.0 ** -9  # dy s rounds back to dy in bf16: the dz rounding shows
    t = rng.randn(C) * 0.1
    dy = rng.randn(B, H, W, C)
    f = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device).to(dt)
    return (f(x, torch.bfloat16), f(w, torch.bfloat16), f(s, torch.float32),
            f(t, torch.float32), f(dy, torch.bfloat16))


def _over_ulp(got, want, floor):
    """max |got - want| / (ULP |want| + floor)."""
    g, w = got.double(), want.double()
    return float(((g - w).abs() / (ULP * w.abs() + floor)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SMALL + PATH, ids=[str(s) for s in SMALL + PATH])
def test_bf16_k5_and_k5b_match_plain_on_the_card(cuda, shape):
    x, w, s, t, dy = _inputs(shape, cuda)
    with torch.no_grad():
        y = cb.conv3x3_affine_relu_bf16(x, w, s, t)
        ref = cb.conv3x3_affine_relu_bf16_ref(x, w, s, t)
        torch.cuda.synchronize()
        assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y.float()).all())
        assert _over_ulp(y, ref, FLOOR) <= 1.0
        for need_dx in (True, False):
            got = cb.conv3x3_affine_relu_bwd_bf16(x, w, s, t, ref, dy, need_dx)
            again = cb.conv3x3_affine_relu_bwd_bf16(x, w, s, t, ref, dy, need_dx)
            want = cb.conv3x3_affine_relu_bwd_bf16_ref(x, w, s, t, ref, dy, need_dx)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, again))
            dx, dw, ds, db = got
            assert dx.dtype == dw.dtype == torch.bfloat16 and ds.dtype == torch.float32
            if need_dx:
                assert _over_ulp(dx, want[0], REL * float(want[0].float().abs().max())) <= 1.0
            else:
                assert float(dx.float().abs().max()) == 0.0
            assert _over_ulp(dw, want[1], REL * float(want[1].float().abs().max())) <= 1.0
            for a, b in ((ds, want[2]), (db, want[3])):
                assert float((a - b).abs().max()) <= REL * float(b.abs().max())


@pytest.mark.cuda
def test_the_function_launches_the_bf16_kernels(cuda):
    x, w, s, t, dy = _inputs((2, 20, 70, 64, 64), cuda, seed=1)
    w32 = w.float().requires_grad_(True)
    xr = x.clone().requires_grad_(True)
    f0, b0 = cb.conv3x3_affine_relu_bf16.launches, cb.conv3x3_affine_relu_bwd_bf16.launches
    k0 = conv.conv3x3_affine_relu.launches
    y = conv.conv3x3_affine_relu(xr, w32, s, t)
    (y.float() * dy.float()).sum().backward()
    torch.cuda.synchronize()
    assert cb.conv3x3_affine_relu_bf16.launches == f0 + 1
    assert cb.conv3x3_affine_relu_bwd_bf16.launches == b0 + 1
    assert conv.conv3x3_affine_relu.launches == k0  # the f32 counter stays
    dx, dw, _, _ = cb.conv3x3_affine_relu_bwd_bf16(x, w, s, t, y.detach(), dy)
    assert torch.equal(xr.grad, dx) and torch.equal(w32.grad, dw.float())


@pytest.mark.cuda
def test_the_forward_block_layout(cuda):
    lay = {c: cb.fwd_layout(*c) for c in CHANNELS[1:]}
    assert lay[(64, 64)]["nwg"] == 4 and not lay[(64, 64)]["stream"]
    assert lay[(64, 128)]["nwg"] == 2 and not lay[(64, 128)]["stream"]
    assert lay[(128, 128)]["stream"] and lay[(128, 128)]["w_stages"] >= 2
    assert all(v["halo_stages"] >= 2 and v["smem_bytes"] <= 232448 for v in lay.values())
    with pytest.raises(ValueError, match="takes no"):
        cb.fwd_layout(128, 64)


def test_on_the_cpu_the_wrappers_take_the_plain_versions():
    x, w, s, t, dy = _inputs((1, 6, 9, 64, 64), "cpu")
    f0, b0 = cb.conv3x3_affine_relu_bf16.launches, cb.conv3x3_affine_relu_bwd_bf16.launches
    y = cb.conv3x3_affine_relu_bf16(x, w, s, t)
    assert torch.equal(y, cb.conv3x3_affine_relu_bf16_ref(x, w, s, t))
    got = cb.conv3x3_affine_relu_bwd_bf16(x, w, s, t, y, dy)
    want = cb.conv3x3_affine_relu_bwd_bf16_ref(x, w, s, t, y, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (cb.conv3x3_affine_relu_bf16.launches,
            cb.conv3x3_affine_relu_bwd_bf16.launches) == (f0, b0)


def test_off_the_cpu_the_bf16_wrappers_raise_and_never_fall_back():
    B, H, W, Cin, C = 1, 8, 8, 64, 64
    x, y, dy = (torch.empty(sh, device="meta", dtype=torch.bfloat16)
                for sh in ((B, H, W, Cin), (B, H, W, C), (B, H, W, C)))
    w = torch.empty(3, 3, Cin, C, device="meta", dtype=torch.bfloat16)
    s, t = (torch.empty(C, device="meta") for _ in range(2))
    with pytest.raises(ValueError, match="CUDA"):
        cb.conv3x3_affine_relu_bf16(x, w, s, t)
    with pytest.raises(ValueError, match="CUDA"):
        cb.conv3x3_affine_relu_bwd_bf16(x, w, s, t, y, dy)
