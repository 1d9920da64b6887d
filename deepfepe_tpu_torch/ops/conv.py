"""The fused 3x3 conv + per-channel affine + ReLU: kernel K5.

Replaces `deepfepe_tpu/ops/pallas/conv_pallas.py` (`conv3x3_affine_relu`,
`_fwd_pallas`, `conv3x3_affine_relu_ref`). Layout is NHWC: x [B, H, W, Cin],
w [3, 3, Cin, C], scale and bias [C] float32, y [B, H, W, C] =
relu(conv3x3_same(x, w) * scale + bias).

`conv3x3_affine_relu` runs the plain version for a tensor on the CPU; for
a CUDA tensor it launches `csrc/conv3x3.cu` or raises. Only the forward is
ported: on a CUDA tensor that requires grad it raises, since the backward
kernel (K5b) is not. `conv3x3_affine_relu.launches` counts launches.

A float32 convolution on the card goes through cuDNN in TF32 by default
(`torch.backends.cudnn.allow_tf32` is True); `full_f32` turns that off, and
the plain version and the SuperPoint modules run under it, so every conv
of the port is float32 end to end, as the kernel is.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from ..utils import build

SOURCE = "conv3x3.cu"
CIN1_MAX_C = 256  # widest output of the kernel's Cin = 1 path
MAX_GRID_Z = 65535

_lib = None


@contextlib.contextmanager
def full_f32():
    """cuDNN convolutions in full float32 (no TF32) inside the block."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def conv3x3_affine_relu_ref(x, w, scale, bias):
    """Plain version: relu(conv3x3_same(x, w) * scale + bias) in NHWC,
    float32, with `F.conv2d` in full float32."""
    with full_f32():
        z = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return torch.relu(z.permute(0, 2, 3, 1) * scale + bias).contiguous()


def _load():
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.conv3x3_affine_relu_f32.argtypes = [P, P, P, P, P, I, I, I, I, I, P]
        lib.conv3x3_affine_relu_f32.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x, w, scale, bias):
    if not all(t.is_cuda and t.device == x.device for t in (x, w, scale, bias)):
        raise ValueError(f"the K5 kernel takes CUDA tensors on one device, got x on {x.device}, "
                         f"w on {w.device}, scale on {scale.device}, bias on {bias.device}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[:3] != (3, 3, x.shape[-1]):
        raise ValueError(f"K5 takes x [B, H, W, Cin] and w [3, 3, Cin, C], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    B, H, W, Cin = x.shape
    C = w.shape[-1]
    if scale.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"K5 takes scale and bias [{C}], got {tuple(scale.shape)}, "
                         f"{tuple(bias.shape)}")
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in (x, w, scale, bias)):
        raise ValueError("K5 takes contiguous float32 tensors")
    if Cin == 1 and C > CIN1_MAX_C:
        raise ValueError(f"K5 takes C <= {CIN1_MAX_C} for Cin = 1, got {C}")
    if B * -(-C // 64) > MAX_GRID_Z:
        raise ValueError(f"K5 takes at most {MAX_GRID_Z} images x 64-channel groups, "
                         f"got B = {B}, C = {C}")


def conv3x3_affine_relu(x, w, scale, bias) -> torch.Tensor:
    """Fused 3x3 SAME conv + affine + ReLU, NHWC float32. CPU tensors take
    the plain version; CUDA tensors launch K5 (forward only)."""
    if x.device.type == "cpu":
        return conv3x3_affine_relu_ref(x, w, scale, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, scale, bias)):
        raise NotImplementedError(
            "K5 has no backward on the card: its backward kernel, K5b "
            "(conv_pallas.py _bwd_kernel), is not ported yet (ROADMAP Queue 1 item 2); "
            "call it under torch.no_grad()")
    _check(x, w, scale, bias)
    B, H, W, Cin = x.shape
    C = w.shape[-1]
    lib = _load()
    y = torch.empty((B, H, W, C), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.conv3x3_affine_relu_f32(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                                         bias.data_ptr(), y.data_ptr(), B, H, W, Cin, C,
                                         stream)
    if rc != 0:
        raise RuntimeError(f"K5 kernel launch failed: cudaError {rc}")
    conv3x3_affine_relu.launches += 1
    return y


conv3x3_affine_relu.launches = 0
