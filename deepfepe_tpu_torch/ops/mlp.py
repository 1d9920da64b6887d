"""The fused PointNet weight MLP: kernels K2 (forward) and K2b (backward).

Replaces `deepfepe_tpu/ops/pallas/mlp_pallas.py` (`fused_pointnet_mlp`,
`_fwd_rule`, `_bwd_rule`, `reference_pointnet_mlp`). The stack is L
hidden layers of Dense -> InstanceNorm over the N points of each item ->
affine -> LeakyReLU, then a final Dense, with bf16 matrix products summed
in f32 and no hidden Dense biases (InstanceNorm cancels them).

Parameters use the port's `nn.Linear` layout: hidden weights `Ws[i]`
[C_{i+1}, C_i], norm affines `gammas[i]`, `betas[i]` [C_{i+1}], final
weight `Wf` [out, C_L] and bias `bf` [out], all float32.

`fused_pointnet_mlp` is differentiable. On CPU tensors it runs the plain
versions: `reference_pointnet_mlp` (the forward's math) and
`reference_pointnet_mlp_bwd` (the TPU backward kernel's formula, with its
bf16 rounding points, not autograd of the plain forward). On CUDA tensors
its forward calls `mlp_forward` (K2) and its backward `mlp_backward`
(K2b), which launch `csrc/mlp.cu`, or raise. `mlp_forward.launches` and
`mlp_backward.launches` count wrapper calls that launched the kernels.
`record_calls` keeps each call's inputs and gradients, so a check can hold
the kernel calls of a whole train step against the plain versions.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import List, Sequence

import torch

from ..utils import build

SOURCE = "mlp.cu"
EPS = 1e-5
MAX_IN = 128  # widest C_in and output the routing sends here (as in JAX)
# Split the weight-gradient products over rows until about this many
# blocks are in flight (two per SM of an H100), keeping >= 512 rows each.
TARGET_BLOCKS = 264
MIN_ROWS_PER_SPLIT = 512
TILE = 64

_lib = None
_recorded = None  # the list `record_calls` fills, or None
_F32, _BF16 = torch.float32, torch.bfloat16


def _bf(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16, keep float32."""
    return t.to(_BF16).float()


def _leaky(z: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(z >= 0, z, slope * z)


def _layer_plain(h_in, W, gamma, beta, slope):
    """One hidden layer on bf16-valued f32 input [B, N, C_in]; returns
    (y, xhat, inv) with y and xhat bf16-valued."""
    n = h_in.shape[-2]
    h = h_in @ _bf(W).T  # exact bf16 products, f32 sums
    hb = _bf(h)
    mean = hb.sum(-2, keepdim=True) / n
    var = torch.clamp(_bf(hb * hb).sum(-2, keepdim=True) / n - mean * mean, min=0.0)
    inv = torch.rsqrt(var + EPS)
    scale = gamma * inv
    shift = beta - mean * scale
    y = _bf(_leaky(h * scale + shift, slope))
    return y, _bf((h - mean) * inv), inv


def reference_pointnet_mlp(x, Ws, gammas, betas, Wf, bf, slope: float = 0.01):
    """Plain forward: x [B, N, C_in] -> logits [B, N, out] float32."""
    h = _bf(x.float())
    for W, gamma, beta in zip(Ws, gammas, betas):
        h, _, _ = _layer_plain(h, W, gamma, beta, slope)
    return h @ _bf(Wf).T + bf


def reference_pointnet_mlp_bwd(x, g, Ws, gammas, betas, Wf, slope: float = 0.01):
    """Plain backward of `reference_pointnet_mlp` for the cotangent g
    [B, N, out], as the TPU backward kernel computes it: recompute the
    forward, then per layer r1 = sum dz, r2 = sum dz*xhat (per item),
    dh = dz*a - xhat*(a*r2/n) - a*r1/n with a = gamma*inv, in bf16.
    Returns (dx, dWs, dgammas, dbetas, dWf, dbf), float32, parameter
    gradients summed over items."""
    n = x.shape[-2]
    h = _bf(x.float())
    acts = []
    for W, gamma, beta in zip(Ws, gammas, betas):
        y, xhat, inv = _layer_plain(h, W, gamma, beta, slope)
        acts.append((h, xhat, inv))
        h = y
    gb = _bf(g.float())
    dWf = torch.einsum("bno,bnc->oc", gb, h)
    dbf = gb.sum((0, 1))
    dy = _bf(gb @ _bf(Wf))
    sl = float(_bf(torch.tensor(slope)))
    L = len(Ws)
    dWs: List[torch.Tensor] = [None] * L
    dgammas: List[torch.Tensor] = [None] * L
    dbetas: List[torch.Tensor] = [None] * L
    for i in range(L - 1, -1, -1):
        x_in, xhat, inv = acts[i]
        zb = _bf(_bf(xhat * _bf(gammas[i])) + _bf(betas[i]))
        dz = torch.where(zb >= 0, dy, _bf(sl * dy))
        r2 = _bf(dz * xhat).sum(-2, keepdim=True)  # [B, 1, C] per item
        r1 = dz.sum(-2, keepdim=True)
        dgammas[i] = r2.sum((0, 1))
        dbetas[i] = r1.sum((0, 1))
        a = gammas[i] * inv
        c2 = _bf(a * (r2 / n))
        c1 = _bf(a * (r1 / n))
        dh = _bf(_bf(_bf(dz * _bf(a)) - _bf(xhat * c2)) - c1)
        dWs[i] = torch.einsum("bnc,bnk->ck", dh, x_in)
        dy = dh @ _bf(Ws[i])
        if i > 0:
            dy = _bf(dy)
    return dy, dWs, dgammas, dbetas, dWf, dbf


# ---------------------------------------------------------------------------
# The kernels (csrc/mlp.cu)
# ---------------------------------------------------------------------------

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "mlp_gemm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _LL, _P],
    "mlp_sum_splits": [_P, _P, _LL, _I, _P],
    "mlp_cast_bf16": [_P, _P, _LL, _P],
    "mlp_in_stats": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "mlp_in_apply": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "mlp_bwd_reduce": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "mlp_sum_items": [_P, _P, _P, _P, _I, _I, _P],
    "mlp_bwd_dh": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "mlp_colsum_bf16": [_P, _P, _LL, _I, _P],
}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from SOURCE."""
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(build.load(SOURCE))
    return _lib


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


class _Launcher:
    """Calls into the library on one stream; raises on a failed launch."""

    def __init__(self, lib, stream: int):
        self.lib, self.stream = lib, stream

    def __call__(self, name: str, *args):
        args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        rc = getattr(self.lib, name)(*args, self.stream)
        if rc != 0:
            raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")

    def gemm(self, A, B, C, M, N, K, a_t, b_t, bias=None):
        """C [M, N] f32 = op(A) @ op(B) (+ bias); A is [M, K] or, with a_t,
        [K, M]; B is [K, N] or, with b_t, [N, K]; all contiguous. A long
        depth is split over row ranges whose partial sums are added in a
        fixed order."""
        lda = M if a_t else K
        ldb = K if b_t else N
        tiles = -(-M // TILE) * -(-N // TILE)
        splits = max(1, min(-(-TARGET_BLOCKS // tiles), K // MIN_ROWS_PER_SPLIT))
        if splits == 1:
            self("mlp_gemm", A, B, C, bias, M, N, K, lda, ldb, N, a_t, b_t, 1, 0)
            return
        if bias is not None:
            raise ValueError("a bias is added only to an unsplit product")
        part = torch.empty((splits, M, N), dtype=_F32, device=C.device)
        self("mlp_gemm", A, B, part, None, M, N, K, lda, ldb, N, a_t, b_t, splits, M * N)
        self("mlp_sum_splits", part, C, M * N, splits)


def _require_cuda(x: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    if not x.is_cuda:
        raise ValueError(f"the MLP kernels take CUDA tensors, got x on {x.device}")
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"MLP parameter on {t.device}, x on {x.device}")


def _check_args(x, Ws, gammas, betas, Wf, bf) -> List[int]:
    """Shape, dtype and contiguity checks; returns the widths
    [C_in, C_1, ..., C_L, out]."""
    if x.dtype != _F32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"MLP kernels take a contiguous float32 [B, N, C_in] x, got "
                         f"{tuple(x.shape)} {x.dtype}"
                         f"{'' if x.is_contiguous() else ' (not contiguous)'}")
    B, N, c_in = x.shape
    if not (len(Ws) == len(gammas) == len(betas) and Ws):
        raise ValueError("MLP kernels need one (W, gamma, beta) per hidden layer")
    dims = [c_in]
    for W, g, b in zip(Ws, gammas, betas):
        if W.dim() != 2 or W.shape[1] != dims[-1]:
            raise ValueError(f"hidden weight {tuple(W.shape)} does not take width {dims[-1]}")
        dims.append(W.shape[0])
        if g.shape != (dims[-1],) or b.shape != (dims[-1],):
            raise ValueError(f"norm affine {tuple(g.shape)}/{tuple(b.shape)} for width "
                             f"{dims[-1]}")
    if Wf.dim() != 2 or Wf.shape[1] != dims[-1] or (bf is not None and
                                                    bf.shape != (Wf.shape[0],)):
        raise ValueError(f"final weight {tuple(Wf.shape)} does not take width {dims[-1]}")
    dims.append(Wf.shape[0])
    if c_in > MAX_IN or dims[-1] > MAX_IN:
        raise ValueError(f"MLP kernels take C_in and out <= {MAX_IN}, got {c_in}, {dims[-1]}")
    params = [*Ws, *gammas, *betas, Wf] + ([bf] if bf is not None else [])
    for t in params:
        if t.dtype != _F32 or not t.is_contiguous():
            raise ValueError("MLP parameters must be contiguous float32")
    if B * N * max(dims) >= 2**31 or -(-B * N // TILE) > 65535:
        raise ValueError(f"MLP kernels take at most 4M rows, got B*N = {B * N}")
    return dims


def _forward_pass(run: _Launcher, x, Wb, gammas, betas, dims, slope, stash: bool):
    """The hidden layers. Returns the last layer's output [B*N, C_L] bf16
    and, with `stash`, the per-layer (x_in, xhat, inv) for the backward."""
    B, N, c_in = x.shape
    rows, cmax, dev = B * N, max(dims[1:-1]), x.device
    cur = torch.empty((rows, c_in), dtype=_BF16, device=dev)
    run("mlp_cast_bf16", x, cur, rows * c_in)
    h = torch.empty(rows * cmax, dtype=_F32, device=dev)
    mean, inv, scale, shift = torch.empty((4, B * cmax), dtype=_F32, device=dev)
    ping = [] if stash else [torch.empty(rows * cmax, dtype=_BF16, device=dev)
                             for _ in range(2)]
    acts = []
    for i, (W, gamma, beta) in enumerate(zip(Wb, gammas, betas)):
        cin, cout = dims[i], dims[i + 1]
        hv = h[: rows * cout].view(rows, cout)
        run.gemm(cur, W, hv, rows, cout, cin, a_t=0, b_t=1)
        if stash:
            inv = torch.empty(B * cout, dtype=_F32, device=dev)
            y = torch.empty((rows, cout), dtype=_BF16, device=dev)
            xhat = torch.empty((rows, cout), dtype=_BF16, device=dev)
        else:
            y, xhat = ping[i % 2][: rows * cout].view(rows, cout), None
        run("mlp_in_stats", hv, gamma, beta, mean, inv, scale, shift, B, N, cout)
        run("mlp_in_apply", hv, mean, inv, scale, shift, y, xhat, B, N, cout, slope)
        if stash:
            acts.append((cur, xhat, inv))
        cur = y
    return cur, acts


def mlp_forward(x, Ws, gammas, betas, Wf, bf, slope: float = 0.01) -> torch.Tensor:
    """K2: logits [B, N, out] float32 of contiguous CUDA float32 x [B, N,
    C_in]. Raises on anything else."""
    _require_cuda(x, [*Ws, *gammas, *betas, Wf, bf])
    dims = _check_args(x, Ws, gammas, betas, Wf, bf)
    B, N, _ = x.shape
    rows, out_size = B * N, dims[-1]
    run = _Launcher(_load(), _stream(x))
    Wb = [W.to(_BF16).contiguous() for W in Ws]
    y, _ = _forward_pass(run, x, Wb, gammas, betas, dims, slope, stash=False)
    out = torch.empty((B, N, out_size), dtype=_F32, device=x.device)
    run.gemm(y, Wf.to(_BF16).contiguous(), out, rows, out_size, dims[-2], a_t=0, b_t=1,
             bias=bf)
    mlp_forward.launches += 1
    return out


def mlp_backward(x, g, Ws, gammas, betas, Wf, slope: float = 0.01):
    """K2b: the gradients of `mlp_forward` for the cotangent g [B, N, out]:
    (dx, dWs, dgammas, dbetas, dWf, dbf), float32, as
    `reference_pointnet_mlp_bwd` returns them."""
    _require_cuda(x, [g, *Ws, *gammas, *betas, Wf])
    dims = _check_args(x, Ws, gammas, betas, Wf, None)
    B, N, c_in = x.shape
    rows, out_size, dev = B * N, dims[-1], x.device
    if g.shape != (B, N, out_size) or g.dtype != _F32 or not g.is_contiguous():
        raise ValueError(f"cotangent must be contiguous float32 {(B, N, out_size)}, got "
                         f"{tuple(g.shape)} {g.dtype}")
    run = _Launcher(_load(), _stream(x))
    Wb = [W.to(_BF16).contiguous() for W in Ws]
    Wfb = Wf.to(_BF16).contiguous()
    y, acts = _forward_pass(run, x, Wb, gammas, betas, dims, slope, stash=True)

    L, c_last, cmax = len(Ws), dims[-2], max(dims[1:-1])
    gb = torch.empty((rows, out_size), dtype=_BF16, device=dev)
    run("mlp_cast_bf16", g, gb, rows * out_size)
    dWf = torch.empty((out_size, c_last), dtype=_F32, device=dev)
    run.gemm(gb, y, dWf, out_size, c_last, rows, a_t=1, b_t=0)
    dbf = torch.empty(out_size, dtype=_F32, device=dev)
    run("mlp_colsum_bf16", gb, dbf, rows, out_size)
    dy_buf = torch.empty(rows * cmax, dtype=_F32, device=dev)
    dy = dy_buf[: rows * c_last].view(rows, c_last)
    run.gemm(gb, Wfb, dy, rows, c_last, out_size, a_t=0, b_t=0)

    r1, r2, ab, c1b, c2b = torch.empty((5, B * cmax), dtype=_F32, device=dev)
    dh_buf = torch.empty(rows * cmax, dtype=_BF16, device=dev)
    dx = torch.empty((B, N, c_in), dtype=_F32, device=dev)
    dWs, dgammas, dbetas = [None] * L, [None] * L, [None] * L
    for i in range(L - 1, -1, -1):
        cin, cout = dims[i], dims[i + 1]
        x_in, xhat, inv = acts[i]
        run("mlp_bwd_reduce", dy, xhat, gammas[i], betas[i], inv, r1, r2, ab, c1b, c2b,
            B, N, cout, slope)
        dgammas[i] = torch.empty(cout, dtype=_F32, device=dev)
        dbetas[i] = torch.empty(cout, dtype=_F32, device=dev)
        run("mlp_sum_items", r1, r2, dgammas[i], dbetas[i], B, cout)
        dh = dh_buf[: rows * cout].view(rows, cout)
        run("mlp_bwd_dh", dy, xhat, gammas[i], betas[i], ab, c1b, c2b, dh, B, N, cout, slope)
        dWs[i] = torch.empty((cout, cin), dtype=_F32, device=dev)
        run.gemm(dh, x_in, dWs[i], cout, cin, rows, a_t=1, b_t=0)
        dy = dx if i == 0 else dy_buf[: rows * cin].view(rows, cin)
        run.gemm(dh, Wb[i], dy, rows, cin, cout, a_t=0, b_t=0)
    mlp_backward.launches += 1
    return dx, dWs, dgammas, dbetas, dWf, dbf


mlp_forward.launches = 0
mlp_backward.launches = 0


class FusedPointNetMLP(torch.autograd.Function):
    """Forward K2, backward K2b on CUDA tensors; the plain versions on CPU
    tensors. Inputs: (x, slope, L, Wf, bf, *Ws, *gammas, *betas)."""

    @staticmethod
    def forward(ctx, x, slope, L, Wf, bf, *params):
        Ws, gammas, betas = params[:L], params[L:2 * L], params[2 * L:]
        ctx.slope, ctx.L = slope, L
        ctx.save_for_backward(x, Wf, *params)
        if x.device.type == "cpu":
            return reference_pointnet_mlp(x, Ws, gammas, betas, Wf, bf, slope)
        return mlp_forward(x, Ws, gammas, betas, Wf, bf, slope)

    @staticmethod
    def backward(ctx, g):
        x, Wf, *params = ctx.saved_tensors
        L = ctx.L
        Ws, gammas, betas = params[:L], params[L:2 * L], params[2 * L:]
        if x.device.type == "cpu":
            grads = reference_pointnet_mlp_bwd(x, g, Ws, gammas, betas, Wf, ctx.slope)
        else:
            grads = mlp_backward(x, g.contiguous(), Ws, gammas, betas, Wf, ctx.slope)
        dx, dWs, dgammas, dbetas, dWf, dbf = grads
        return (dx, None, None, dWf, dbf, *dWs, *dgammas, *dbetas)


def fused_pointnet_mlp(x, Ws, gammas, betas, Wf, bf, slope: float = 0.01) -> torch.Tensor:
    """x [B, N, C_in] -> logits [B, N, out] float32, differentiable in x
    and every parameter."""
    x = x.float().contiguous()
    if _recorded is not None:
        return _record(x, Ws, gammas, betas, Wf, bf, slope)
    return FusedPointNetMLP.apply(x, slope, len(Ws), Wf, bf, *Ws, *gammas, *betas)


@contextlib.contextmanager
def record_calls():
    """Within the block, keep one dict per `fused_pointnet_mlp` call: its
    inputs as they were at the call (`x`, `Ws`, `gammas`, `betas`, `Wf`,
    `bf`, `slope`) and its logits `out`; once the backward has run, the
    cotangent `g` that reached the logits and the x-gradient `dx` that the
    backward returned (absent where x needs no gradient)."""
    global _recorded
    calls = []
    _recorded = calls
    try:
        yield calls
    finally:
        _recorded = None


def _record(x, Ws, gammas, betas, Wf, bf, slope):
    keep = lambda ts: [t.detach().clone() for t in ts]  # noqa: E731
    rec = {"x": x.detach().clone(), "Ws": keep(Ws), "gammas": keep(gammas),
           "betas": keep(betas), "Wf": Wf.detach().clone(), "bf": bf.detach().clone(),
           "slope": slope}
    if x.requires_grad:
        x = x.view_as(x)  # used only by this call: its gradient is the backward's dx
        x.register_hook(lambda d: rec.__setitem__("dx", d.detach().clone()))
    out = FusedPointNetMLP.apply(x, slope, len(Ws), Wf, bf, *Ws, *gammas, *betas)
    if out.requires_grad:
        out.register_hook(lambda g: rec.__setitem__("g", g.detach().clone()))
    rec["out"] = out.detach().clone()
    _recorded.append(rec)
    return out
