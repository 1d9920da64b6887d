"""The fused 3x3 conv + per-channel affine + ReLU in bf16: kernels K5 and
K5b at the SuperPoint's production dtype (`csrc/conv3x3_bf16.cu`).

Replaces `deepfepe_tpu/ops/pallas/conv_pallas.py`'s `_fwd_pallas` and
`_bwd_pallas` for bf16 activations (the JAX kernel takes the activations'
dtype; `frontend/sp_pallas.py` casts x and each conv kernel to the net's
dtype, bf16 on the production path). Layout NHWC: x [B, H, W, Cin] and w
[3, 3, Cin, C] bf16, scale and bias [C] float32, y [B, H, W, C] bf16.
`ops.conv.conv3x3_affine_relu` dispatches here on x's dtype; this module
holds the two wrappers, their plain versions and the C interface.

The plain versions repeat the TPU kernel's arithmetic:

- `conv3x3_affine_relu_bf16_ref`: the bf16 operands convolved in float32
  (under `full_f32`; every bf16 product is exact in float32), then acc *
  scale, then + bias, the ReLU, and one rounding to bf16 (conv_pallas.py
  :111-132). It is not `ops.conv.conv3x3_affine_relu_ref`, the JAX
  package's XLA route, which convolves in bf16 (one rounding) and then
  applies the affine (a second).
- `conv3x3_affine_relu_bwd_bf16_ref`: dz = dy * (y > 0) * scale in float32,
  held in bf16 (conv_pallas.py :196-202, :313-318); dbias = sum dz / s_safe
  and dscale = sum (dz / s_safe) (y - bias) / s_safe from that bf16 dz, in
  float32; dw = the nine x-shift^T dz contractions and dx = the transposed
  conv of dz, each summed in float32 from the bf16 operands and rounded
  once, dw to w's dtype (:327) and dx to x's.

`conv3x3_affine_relu_bf16` and `conv3x3_affine_relu_bwd_bf16` take the
plain versions for tensors on the CPU and launch the kernels for CUDA
tensors, or raise; `.launches` on each counts the calls that launched.
The kernels take (Cin, C) in {1, 64} x {64, 128} and (128, 128), every
layer of the SuperPoint that takes K5; other channel counts raise on the
card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils import build
from .conv import SAFE_EPS, full_f32

SOURCE = "conv3x3_bf16.cu"
CIN = (1, 64, 128)
COUT = (64, 128)
MAX_GRID_Z = 65535
_BF16 = torch.bfloat16

_lib = None


def conv3x3_affine_relu_bf16_ref(x, w, scale, bias):
    """Plain version of the bf16 K5: the bf16 x and w (w cast to x's dtype)
    convolved in float32, acc * scale, then + bias, the ReLU, one rounding
    to x's dtype."""
    with full_f32():
        z = F.conv2d(x.float().permute(0, 3, 1, 2),
                     w.to(x.dtype).float().permute(3, 2, 0, 1), padding=1)
    y = torch.relu(z.permute(0, 2, 3, 1) * scale.float() + bias.float())
    return y.to(x.dtype).contiguous()


def dz_bf16(y, dy, scale):
    """dz = dy * (y > 0) * scale in float32, rounded to dy's dtype."""
    return (dy.float() * (y > 0).float() * scale.float()).to(dy.dtype)


def conv3x3_affine_relu_bwd_bf16_ref(x, w, scale, bias, y, dy, need_dx: bool = True):
    """Plain version of the bf16 K5b: (dx, dw, dscale, dbias) with dz held
    in bf16; dw in w's dtype, dx in x's (exactly zero when `need_dx` is
    False), dscale and dbias float32."""
    s = scale.float()
    s_safe = torch.where(s.abs() < SAFE_EPS, torch.ones_like(s), s)
    dz = dz_bf16(y, dy, scale).float()
    m = dz / s_safe
    dbias = m.sum((0, 1, 2))
    dscale = (m * (y.float() - bias.float()) / s_safe).sum((0, 1, 2))
    x_nchw, dz_nchw = x.float().permute(0, 3, 1, 2), dz.permute(0, 3, 1, 2)
    w_oihw = w.to(x.dtype).float().permute(3, 2, 0, 1)
    with full_f32():
        dw = torch.nn.grad.conv2d_weight(x_nchw, w_oihw.shape, dz_nchw, padding=1)
        dx = (torch.nn.grad.conv2d_input(x_nchw.shape, w_oihw, dz_nchw, padding=1)
              .permute(0, 2, 3, 1).to(x.dtype).contiguous() if need_dx
              else torch.zeros_like(x))
    return dx, dw.permute(2, 3, 1, 0).to(w.dtype).contiguous(), dscale, dbias


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from SOURCE."""
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.conv3x3_affine_relu_bf16.argtypes = [P, P, P, P, P, I, I, I, I, I, P]
    lib.conv3x3_affine_relu_bf16.restype = I
    lib.conv3x3_bf16_fwd_layout.argtypes = [I, I, ctypes.POINTER(LL)]
    lib.conv3x3_bf16_fwd_layout.restype = I
    lib.conv3x3_bwd_bf16_scratch_floats.argtypes = [I, I, I, I, I]
    lib.conv3x3_bwd_bf16_scratch_floats.restype = LL
    lib.conv3x3_affine_relu_bwd_bf16.argtypes = [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, P]
    lib.conv3x3_affine_relu_bwd_bf16.restype = I
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(build.load(SOURCE))
    return _lib


def fwd_layout(cin: int, cout: int) -> dict:
    """The card's forward block for (cin, cout): warpgroups, strip rows,
    halo stages, weight stages, shared bytes, streamed weights."""
    out = (ctypes.c_longlong * 6)()
    if _load().conv3x3_bf16_fwd_layout(cin, cout, out) != 0:
        raise ValueError(f"the bf16 K5 takes no ({cin}, {cout}) block")
    return dict(zip(("nwg", "th", "halo_stages", "w_stages", "smem_bytes", "stream"), out))


def _check(x, w, scale, bias, *saved):
    """Raise unless the bf16 kernels take these tensors (`saved`: y and dy
    of the backward)."""
    ts = (x, w, scale, bias, *saved)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError(f"the bf16 K5 kernels take CUDA tensors on one device, got "
                         f"{[str(t.device) for t in ts]}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[:3] != (3, 3, x.shape[-1]):
        raise ValueError(f"K5 takes x [B, H, W, Cin] and w [3, 3, Cin, C], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    B, H, W, Cin = x.shape
    C = w.shape[-1]
    if scale.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"K5 takes scale and bias [{C}], got {tuple(scale.shape)}, "
                         f"{tuple(bias.shape)}")
    if any(t.shape != (B, H, W, C) for t in saved):
        raise ValueError(f"K5b takes y and dy [{B}, {H}, {W}, {C}], got "
                         f"{[tuple(t.shape) for t in saved]}")
    if any(t.dtype != _BF16 for t in (x, w, *saved)) or \
            any(t.dtype != torch.float32 for t in (scale, bias)):
        raise ValueError("the bf16 K5 kernels take bf16 x, w, y and dy and float32 scale and bias")
    if not all(t.is_contiguous() for t in ts) or any(t.data_ptr() % 16 for t in (x, w, *saved)):
        raise ValueError("the bf16 K5 kernels take contiguous tensors, the bf16 ones 16-byte "
                         "aligned")
    if Cin not in CIN or C not in COUT or (Cin == 128 and C != 128):
        raise ValueError(f"the bf16 K5 kernels take (Cin, C) in (1, 64) x {COUT} and "
                         f"(128, 128), got ({Cin}, {C})")
    if B * max(1, Cin // 64) > MAX_GRID_Z:
        raise ValueError(f"the bf16 K5 kernels take at most {MAX_GRID_Z} images x 64-channel "
                         f"groups, got B = {B}, Cin = {Cin}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def conv3x3_affine_relu_bf16(x, w, scale, bias) -> torch.Tensor:
    """The bf16 K5 on CUDA tensors, its plain version on CPU tensors."""
    if x.device.type == "cpu":
        return conv3x3_affine_relu_bf16_ref(x, w, scale, bias)
    _check(x, w, scale, bias)
    B, H, W, Cin = x.shape
    C = w.shape[-1]
    lib = _load()
    y = torch.empty((B, H, W, C), dtype=_BF16, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.conv3x3_affine_relu_bf16(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                                          bias.data_ptr(), y.data_ptr(), B, H, W, Cin, C,
                                          _stream(x))
    if rc != 0:
        raise RuntimeError(f"bf16 K5 kernel launch failed: cudaError {rc}")
    conv3x3_affine_relu_bf16.launches += 1
    return y


conv3x3_affine_relu_bf16.launches = 0


def conv3x3_affine_relu_bwd_bf16(x, w, scale, bias, y, dy, need_dx: bool = True):
    """(dx, dw, dscale, dbias): the bf16 K5b on CUDA tensors, the plain
    version on CPU tensors. The kernel sums each weight and affine gradient
    in a fixed order (partial sums per pixel group, then one pass over the
    groups): the same bits every run."""
    if x.device.type == "cpu":
        return conv3x3_affine_relu_bwd_bf16_ref(x, w, scale, bias, y, dy, need_dx)
    _check(x, w, scale, bias, y, dy)
    B, H, W, Cin = x.shape
    C = w.shape[-1]
    lib = _load()
    with torch.cuda.device(x.device):
        part = torch.empty(lib.conv3x3_bwd_bf16_scratch_floats(B, H, W, Cin, C),
                           dtype=torch.float32, device=x.device)
        dw = torch.empty_like(w)
        dst = torch.empty(2 * C, dtype=torch.float32, device=x.device)
        dx = torch.empty_like(x) if need_dx else None
        rc = lib.conv3x3_affine_relu_bwd_bf16(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            dy.data_ptr(), dx.data_ptr() if need_dx else None, part.data_ptr(), dw.data_ptr(),
            dst.data_ptr(), B, H, W, Cin, C, _stream(x))
    if rc != 0:
        raise RuntimeError(f"bf16 K5b kernel launch failed: cudaError {rc}")
    conv3x3_affine_relu_bwd_bf16.launches += 1
    return dx if need_dx else torch.zeros_like(x), dw, dst[:C], dst[C:]


conv3x3_affine_relu_bwd_bf16.launches = 0
