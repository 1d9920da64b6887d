"""Port parity: the bf16 K5 and K5b plain versions (`ops/conv_bf16.py`, the
arithmetic of `csrc/conv3x3_bf16.cu`) against the JAX kernel
`conv3x3_affine_relu(backend="pallas")` in interpret mode, with bf16 x and
w, on the same numpy inputs.

- The forward at (Cin, C) in {(1, 64), (64, 64), (64, 128), (128, 128)},
  B = 2 at 13 x 22: every element within one bf16 ulp of JAX's, |d| <=
  2^-7 |jax| + 1e-5 (both sum exact bf16 products in float32 in other
  orders and round once); measured: at least 99.9% of the elements equal
  (`EXACT_SHARE`).
- The backward through `jax.vjp` on the same bf16 cotangent, need_dx both
  ways: dx (bf16), dw (bf16, w's dtype), dscale and dbias (float32) of
  the right dtypes, and each of them no farther from the float64 formula
  on the same bf16 operands and bf16 dz (Frobenius norm) than 1.3 times
  the JAX kernel's own distance plus a float32 floor; dscale and dbias also
  within 1e-4 of JAX's largest entry.
- Where rounding dz to bf16 matters (scale 1 + 2^-9: dy s rounds back to
  dy), a twin that keeps dz in float32 misses JAX's dbias and dscale by
  about 2^-9 relative, far outside the 1e-4 bar the real twin holds.
- The bf16 Function on the CPU: gradients in the inputs' dtypes, the
  float32 weight's gradient the bf16 one cast up.
- `chip_smoke.py`'s bf16 plants each change one line of the CUDA source.
"""

import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfepe_tpu.ops.pallas.conv_pallas import conv3x3_affine_relu as jconv
from _torch_threads import one_torch_thread  # noqa: F401

cb = importlib.import_module("deepfepe_tpu_torch.ops.conv_bf16")
conv = importlib.import_module("deepfepe_tpu_torch.ops.conv")

REPO = Path(__file__).resolve().parents[1]
CHANNELS = [(1, 64), (64, 64), (64, 128), (128, 128)]
B, H, W = 2, 13, 22
ULP, FLOOR = 2.0 ** -7, 1e-5
EXACT_SHARE = 0.999
F64_FACTOR = 1.3


def _inputs(cin, c, seed=0, scale=None):
    """bf16 x (ReLU-like, or an image for Cin = 1) and w, float32 s and t,
    a bf16 cotangent; as numpy float32 holding bf16 values."""
    rng = np.random.RandomState(seed)
    x = rng.rand(B, H, W, cin) if cin == 1 else np.maximum(rng.randn(B, H, W, cin), 0)
    w = rng.randn(3, 3, cin, c) / np.sqrt(9 * cin)
    s = rng.rand(c) + 0.5 if scale is None else np.full(c, scale)
    t = rng.randn(c) * 0.1
    dy = rng.randn(B, H, W, c)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16().float().numpy()
    return bf(x), bf(w), s.astype(np.float32), t.astype(np.float32), bf(dy)


def _torch(x, w, s, t, dy):
    b = lambda a: torch.from_numpy(a).bfloat16()
    return b(x), b(w), torch.from_numpy(s), torch.from_numpy(t), b(dy)


def _jax(x, w, s, t, dy, need_dx):
    """The JAX kernel's y and VJP (dx, dw, ds, dt) on bf16 x, w, dy."""
    xb, wb, dyb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, dy))
    y, vjp = jax.vjp(lambda *a: jconv(*a, need_dx=need_dx, backend="pallas"),
                     xb, wb, jnp.asarray(s), jnp.asarray(t))
    return y, vjp(dyb)


def _f64(x, w, s, t, y, dy, need_dx):
    """The backward's formula in float64 on the bf16 operands and bf16 dz."""
    xt, wt = torch.from_numpy(x).double(), torch.from_numpy(w).double()
    st, tt = torch.from_numpy(s).double(), torch.from_numpy(t).double()
    yt = torch.from_numpy(np.asarray(y, np.float32)).double()
    dz = cb.dz_bf16(torch.from_numpy(np.asarray(y, np.float32)).bfloat16(),
                    torch.from_numpy(dy).bfloat16(), torch.from_numpy(s)).double()
    safe = torch.where(st.abs() < 1e-8, torch.ones_like(st), st)
    m = dz / safe
    xn, dzn, wn = xt.permute(0, 3, 1, 2), dz.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1)
    dw = torch.nn.grad.conv2d_weight(xn, wn.shape, dzn, padding=1).permute(2, 3, 1, 0)
    dx = torch.nn.grad.conv2d_input(xn.shape, wn, dzn, padding=1).permute(0, 2, 3, 1) \
        if need_dx else torch.zeros_like(xt)
    return [dx, dw, (m * (yt - tt) / safe).sum((0, 1, 2)), m.sum((0, 1, 2))]


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else jnp.asarray(a, jnp.float32),
                      np.float64)


@pytest.mark.parametrize("cin,c", CHANNELS, ids=[f"{a}to{b}" for a, b in CHANNELS])
def test_bf16_twins_match_the_jax_kernel(cin, c):
    x, w, s, t, dy = _inputs(cin, c)
    tx, tw, ts, tt, tdy = _torch(x, w, s, t, dy)
    y = cb.conv3x3_affine_relu_bf16_ref(tx, tw, ts, tt)
    for need_dx in (True, False):
        jy, jgrads = _jax(x, w, s, t, dy, need_dx)
        assert jy.dtype == jnp.bfloat16 and y.dtype == torch.bfloat16
        a, b = _np(y), _np(jy)
        assert np.all(np.abs(a - b) <= ULP * np.abs(b) + FLOOR)
        assert np.mean(a == b) >= EXACT_SHARE, np.mean(a == b)
        # The backward on JAX's own y, so both hold the same ReLU mask.
        grads = cb.conv3x3_affine_relu_bwd_bf16_ref(tx, tw, ts, tt,
                                                    torch.from_numpy(_np(jy).astype(np.float32))
                                                    .bfloat16(), tdy, need_dx)
        assert [g.dtype for g in grads] == [torch.bfloat16, torch.bfloat16, torch.float32,
                                            torch.float32]
        assert [str(g.dtype) for g in jgrads] == ["bfloat16", "bfloat16", "float32", "float32"]
        ref = [r.numpy() for r in _f64(x, w, s, t, jy, dy, need_dx)]
        for name, g, jg, r in zip(("dx", "dw", "dscale", "dbias"), grads, jgrads, ref):
            mine, theirs = np.linalg.norm(_np(g) - r), np.linalg.norm(_np(jg) - r)
            assert mine <= F64_FACTOR * theirs + 1e-6 * np.linalg.norm(r), (name, mine, theirs)
        if not need_dx:
            assert float(grads[0].float().abs().max()) == 0.0
        for g, jg in zip(grads[2:], jgrads[2:]):
            assert np.abs(_np(g) - _np(jg)).max() <= 1e-4 * np.abs(_np(jg)).max()


def test_dz_is_rounded_to_bf16_before_the_sums(monkeypatch):
    """scale 1 + 2^-9: dy s is dy in bf16, so JAX's dz is dy while a float32
    dz is dy (1 + 2^-9); dbias and dscale then move by ~2^-9 relative."""
    x, w, s, t, dy = _inputs(64, 64, seed=3, scale=1 + 2.0 ** -9)
    _, jgrads = _jax(x, w, s, t, dy, True)
    tx, tw, ts, tt, tdy = _torch(x, w, s, t, dy)
    ty = cb.conv3x3_affine_relu_bf16_ref(tx, tw, ts, tt)

    def off(grads):
        return max(float(np.abs(_np(g) - _np(jg)).max() / np.abs(_np(jg)).max())
                   for g, jg in zip(grads[2:], jgrads[2:]))

    sound = off(cb.conv3x3_affine_relu_bwd_bf16_ref(tx, tw, ts, tt, ty, tdy))
    monkeypatch.setattr(cb, "dz_bf16", lambda y, dy, scale: dy.float() * (y > 0).float()
                        * scale.float())
    kept_f32 = off(cb.conv3x3_affine_relu_bwd_bf16_ref(tx, tw, ts, tt, ty, tdy))
    assert sound <= 1e-4 < 5e-4 <= kept_f32, (sound, kept_f32)


def test_the_bf16_function_on_the_cpu():
    x, w, s, t, dy = _inputs(64, 128, seed=1)
    tx, tw, ts, tt, tdy = _torch(x, w, s, t, dy)
    xr, w32 = tx.clone().requires_grad_(True), tw.float().requires_grad_(True)
    sr, trr = ts.clone().requires_grad_(True), tt.clone().requires_grad_(True)
    y = conv.conv3x3_affine_relu(xr, w32, sr, trr)
    assert y.dtype == torch.bfloat16
    y.backward(tdy)
    want = cb.conv3x3_affine_relu_bwd_bf16_ref(tx, tw, ts, tt, y.detach(), tdy)
    assert xr.grad.dtype == torch.bfloat16 and torch.equal(xr.grad, want[0])
    assert w32.grad.dtype == torch.float32 and torch.equal(w32.grad, want[1].float())
    assert torch.equal(sr.grad, want[2]) and torch.equal(trr.grad, want[3])


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("fault", ["conv_bf16_drop_tap", "conv_bf16_dz_f32"])
def test_the_bf16_plants_name_one_source_line(fault):
    smoke = _chip_smoke()
    assert fault in smoke.FAULTS
    name, line, changed = smoke.SOURCE_FAULTS[fault]
    mod = importlib.import_module(f"deepfepe_tpu_torch.ops.{name}")
    src = (REPO / "deepfepe_tpu_torch" / "csrc" / mod.SOURCE).read_text()
    assert mod.SOURCE == "conv3x3_bf16.cu"
    assert src.count(line) == 1 and changed not in src
