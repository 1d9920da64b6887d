"""The fused 3x3 conv + per-channel affine + ReLU: kernels K5 (forward) and
K5b (backward).

Replaces `deepfepe_tpu/ops/pallas/conv_pallas.py` (`conv3x3_affine_relu`,
`_fwd_pallas`, `_bwd_pallas`, `conv3x3_affine_relu_ref`). Layout is NHWC:
x [B, H, W, Cin], w [3, 3, Cin, C], scale and bias [C] float32, y [B, H, W,
C] = relu(conv3x3_same(x, w) * scale + bias).

`conv3x3_affine_relu` is differentiable: a `torch.autograd.Function` that
saves x, w, scale, bias and y, as the JAX custom VJP does. For tensors on
the CPU its forward and backward are the plain versions,
`conv3x3_affine_relu_ref` and `conv3x3_affine_relu_bwd_ref` (the TPU
backward kernel's formula, not autograd of the plain forward: dscale
recovers the pre-affine sum as (y - bias) / scale). For CUDA tensors they
launch `csrc/conv3x3.cu` (K5, then K5b in the backward) or raise.
`need_dx=False` declares the input's gradient unused: it is exactly zero
and K5b launches no dx kernel. `conv3x3_affine_relu.launches` and
`conv3x3_affine_relu_bwd.launches` count the wrapper calls that launched
K5 and K5b. The kernels take their products on the tensor cores in three
TF32 passes (each float32 operand split into a TF32 high and low part,
only low x low dropped), which keeps them within float32's bars; Cin = 1
runs FP32 kernels of its own.

A float32 convolution on the card goes through cuDNN in TF32 by default
(`torch.backends.cudnn.allow_tf32` is True), and on the CPU through oneDNN;
`full_f32` turns off both, and the plain versions and the SuperPoint
modules run under it, so every conv of the port is float32 end to end, as
the kernels are. A SuperPoint train step (the joint step, `frontend/
train_sp.py`'s steps) takes `step_convs`: a float32 net runs forward and
backward under `exact_convs`, `full_f32` and, on the card, no cuDNN, whose
weight gradient takes Winograd for some layers.

bf16 activations take the bf16 kernels instead (`ops/conv_bf16.py`,
`csrc/conv3x3_bf16.cu`): `conv3x3_affine_relu` dispatches on x's dtype,
casting w to it as the JAX package's callers do. Their launches are
counted apart, on `conv_bf16.conv3x3_affine_relu_bf16` and
`conv_bf16.conv3x3_affine_relu_bwd_bf16`.

`record_calls` keeps each call's inputs and outputs (and, once the
backward has run, its cotangent and gradients), so a check can hold the
kernel calls of a whole step against the plain versions.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from ..utils import build

SOURCE = "conv3x3.cu"
CIN1_MAX_C = 256  # widest output of the kernels' Cin = 1 paths
MAX_GRID_Z = 65535
SAFE_EPS = 1e-8  # |scale| below this divides as 1 (the TPU kernel's `_safe`)

_lib = None
_recorded = None  # the list `record_calls` fills, or None


@contextlib.contextmanager
def full_f32():
    """Convolutions in full float32 inside the block: cuDNN without TF32,
    and on the CPU without oneDNN, whose float32 conv backward lost up to 4%
    of some SuperPoint weight gradients' largest entry (float64 against
    3e-6 without it, at 128x128)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.mkldnn.enabled
    torch.backends.cudnn.allow_tf32 = torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.mkldnn.enabled = saved


@contextlib.contextmanager
def exact_convs():
    """Convolutions to be differentiated, in full float32 inside the block:
    `full_f32`, and on the card without cuDNN, whose float32 weight
    gradient takes a Winograd algorithm (winograd_nonfused, 4x4) for some
    SuperPoint layers and lost up to 1.9% of a weight leaf's largest entry
    against float64 (a 128x128 frozen-BN joint step on an H100). PyTorch's
    own CUDA convolution (im2col and a GEMM) has no such algorithm. A
    convolution's backward stays on the backend its forward took, so the
    block holds both."""
    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        with full_f32():
            yield
    finally:
        torch.backends.cudnn.enabled = saved


def step_convs(net: torch.nn.Module):
    """The conv block of a SuperPoint train step: `exact_convs` for a
    float32 net (a float64 one too: `net.dtype` is its compute dtype),
    `full_f32` for a bf16 one, whose plain convs take the library's bf16
    conv, the counterpart of the JAX package's XLA convs."""
    return exact_convs() if getattr(net, "dtype", torch.float32) == torch.float32 else full_f32()


def conv3x3_affine_relu_ref(x, w, scale, bias):
    """Plain version: relu(conv3x3_same(x, w) * scale + bias) in NHWC, as the
    JAX package's `conv3x3_affine_relu_ref`: w is cast to x's dtype and the
    conv runs in it (`F.conv2d`, in full float32 for float32), the affine
    and ReLU run in float32 (float64 for float64), and the result comes
    back in x's dtype. For bf16 that is cuDNN's bf16 conv on the card,
    rounded twice."""
    with full_f32():
        z = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1), padding=1)
    acc = torch.promote_types(x.dtype, torch.float32)
    y = torch.relu(z.permute(0, 2, 3, 1).to(acc) * scale.to(acc) + bias.to(acc))
    return y.to(x.dtype).contiguous()


def conv3x3_affine_relu_bwd_ref(x, w, scale, bias, y, dy, need_dx: bool = True):
    """Plain version of K5b: (dx, dw, dscale, dbias) from the forward's
    inputs, its output y and the cotangent dy, with the TPU kernel's math:
    dz = dy * (y > 0) * scale; dbias = sum dz / s_safe; dscale = sum
    (dz / s_safe) * (y - bias) / s_safe, where s_safe is scale with entries
    below 1e-8 in magnitude replaced by 1; dw the nine x-shift^T dz
    contractions and dx the transposed conv of dz (exactly zero when
    `need_dx` is False). Convs in full float32."""
    s_safe = torch.where(scale.abs() < SAFE_EPS, torch.ones_like(scale), scale)
    dz = dy * (y > 0).to(dy.dtype) * scale
    m = dz / s_safe
    dbias = m.sum((0, 1, 2))
    dscale = (m * (y - bias) / s_safe).sum((0, 1, 2))
    x_nchw, dz_nchw = x.permute(0, 3, 1, 2), dz.permute(0, 3, 1, 2)
    w_oihw = w.permute(3, 2, 0, 1)
    with full_f32():
        dw = torch.nn.grad.conv2d_weight(x_nchw, w_oihw.shape, dz_nchw, padding=1)
        dx = (torch.nn.grad.conv2d_input(x_nchw.shape, w_oihw, dz_nchw, padding=1)
              .permute(0, 2, 3, 1).contiguous() if need_dx else torch.zeros_like(x))
    return dx, dw.permute(2, 3, 1, 0).contiguous(), dscale, dbias


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from SOURCE."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.conv3x3_affine_relu_f32.argtypes = [P, P, P, P, P, I, I, I, I, I, P]
    lib.conv3x3_affine_relu_f32.restype = ctypes.c_int
    lib.conv3x3_bwd_scratch_floats.argtypes = [I, I, I, I, I]
    lib.conv3x3_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.conv3x3_affine_relu_bwd_f32.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, P]
    lib.conv3x3_affine_relu_bwd_f32.restype = ctypes.c_int
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(build.load(SOURCE))
    return _lib


def _check(x, w, scale, bias, *saved):
    """Raise unless the kernels take these tensors (`saved`: y and dy of the
    backward, [B, H, W, C])."""
    ts = (x, w, scale, bias, *saved)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError(f"the K5 kernels take CUDA tensors on one device, got "
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
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in ts):
        raise ValueError("the K5 kernels take contiguous float32 tensors")
    if Cin == 1 and C > CIN1_MAX_C:
        raise ValueError(f"the K5 kernels take C <= {CIN1_MAX_C} for Cin = 1, got {C}")
    # The forward's and dx's grids hold B x 64-channel groups in z.
    if B * -(-max(C, Cin) // 64) > MAX_GRID_Z:
        raise ValueError(f"the K5 kernels take at most {MAX_GRID_Z} images x 64-channel "
                         f"groups, got B = {B}, Cin = {Cin}, C = {C}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def conv3x3_affine_relu_fwd(x, w, scale, bias) -> torch.Tensor:
    """K5 on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return conv3x3_affine_relu_ref(x, w, scale, bias)
    _check(x, w, scale, bias)
    B, H, W, Cin = x.shape
    C = w.shape[-1]
    lib = _load()
    y = torch.empty((B, H, W, C), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.conv3x3_affine_relu_f32(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                                         bias.data_ptr(), y.data_ptr(), B, H, W, Cin, C,
                                         _stream(x))
    if rc != 0:
        raise RuntimeError(f"K5 kernel launch failed: cudaError {rc}")
    conv3x3_affine_relu.launches += 1
    return y


def conv3x3_affine_relu_bwd(x, w, scale, bias, y, dy, need_dx: bool = True):
    """(dx, dw, dscale, dbias): K5b on CUDA tensors, the plain version on
    CPU tensors. K5b sums each weight and affine gradient in a fixed order
    (partial sums per pixel group, then one pass over the groups), so its
    result does not change from run to run."""
    if x.device.type == "cpu":
        return conv3x3_affine_relu_bwd_ref(x, w, scale, bias, y, dy, need_dx)
    _check(x, w, scale, bias, y, dy)
    B, H, W, Cin = x.shape
    C = w.shape[-1]
    lib = _load()
    with torch.cuda.device(x.device):
        part = torch.empty(lib.conv3x3_bwd_scratch_floats(B, H, W, Cin, C),
                           dtype=torch.float32, device=x.device)
        out = torch.empty(9 * Cin * C + 2 * C, dtype=torch.float32, device=x.device)
        dx = torch.empty_like(x) if need_dx else None
        rc = lib.conv3x3_affine_relu_bwd_f32(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            dy.data_ptr(), dx.data_ptr() if need_dx else None, part.data_ptr(),
            out.data_ptr(), B, H, W, Cin, C, _stream(x))
    if rc != 0:
        raise RuntimeError(f"K5b kernel launch failed: cudaError {rc}")
    conv3x3_affine_relu_bwd.launches += 1
    n = 9 * Cin * C
    dw, dscale, dbias = out[:n].view(3, 3, Cin, C), out[n:n + C], out[n + C:]
    return dx if need_dx else torch.zeros_like(x), dw, dscale, dbias


conv3x3_affine_relu_bwd.launches = 0


class FusedConv3x3AffineReLU(torch.autograd.Function):
    """Forward K5, backward K5b on CUDA tensors (the float32 or the bf16
    kernels, by x's dtype); the plain versions on CPU tensors. Inputs: (x,
    w, scale, bias, need_dx)."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, need_dx):
        from . import conv_bf16

        fwd = conv_bf16.conv3x3_affine_relu_bf16 if x.dtype == torch.bfloat16 \
            else conv3x3_affine_relu_fwd
        y = fwd(x, w, scale, bias)
        ctx.save_for_backward(x, w, scale, bias, y)
        ctx.need_dx = need_dx
        ctx.record = None
        if _recorded is not None:
            ctx.record = {"x": x.detach().clone(), "w": w.detach().clone(),
                          "scale": scale.detach().clone(), "bias": bias.detach().clone(),
                          "need_dx": need_dx, "y": y.detach().clone()}
            _recorded.append(ctx.record)
        return y

    @staticmethod
    def backward(ctx, dy):
        from . import conv_bf16

        x, w, scale, bias, y = ctx.saved_tensors
        bwd = conv_bf16.conv3x3_affine_relu_bwd_bf16 if x.dtype == torch.bfloat16 \
            else conv3x3_affine_relu_bwd
        dy = dy.contiguous()
        grads = bwd(x, w, scale, bias, y, dy, ctx.need_dx)
        if ctx.record is not None:
            ctx.record.update(dy=dy.detach().clone(),
                              **{k: g.detach().clone() for k, g in
                                 zip(("dx", "dw", "dscale", "dbias"), grads)})
        return (*grads, None)


def conv3x3_affine_relu(x, w, scale, bias, need_dx: bool = True) -> torch.Tensor:
    """Fused 3x3 SAME conv + affine + ReLU, NHWC, differentiable in x
    (unless `need_dx` is False), w, scale and bias; float32 x, or bf16 x
    (w cast to x's dtype). CPU tensors take the plain versions; CUDA
    tensors launch K5 and, in the backward, K5b."""
    return FusedConv3x3AffineReLU.apply(x, w.to(x.dtype), scale, bias, need_dx)


conv3x3_affine_relu.launches = 0


@contextlib.contextmanager
def record_calls():
    """Within the block, keep one dict per `conv3x3_affine_relu` call: its
    inputs as they were at the call (`x`, `w` in x's dtype, `scale`,
    `bias`, `need_dx`) and its output `y`; once the backward has run, the
    cotangent `dy` that reached y and the gradients `dx`, `dw`, `dscale`
    and `dbias` that the backward returned. A call whose forward is rerun
    (`remat`) is recorded once a run."""
    global _recorded
    calls = []
    _recorded = calls
    try:
        yield calls
    finally:
        _recorded = None
