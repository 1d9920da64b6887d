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
MAX_LAST = 1024  # widest last hidden layer the final passes take
MAX_SEGMENTS = 16  # buffers one pack launch casts: x, the hidden weights, Wf
TILE = 64  # rows of a statistics tile (one warpgroup's wgmma M)
BLOCK_ROWS = 128  # rows of a product block (two warpgroups)
K_ALIGN = 16  # the first layer's depth is padded to wgmma's k16
# Split the weight-gradient products over row ranges until about this many
# blocks are in flight (two waves of one block an SM of an H100).
TARGET_BLOCKS = 264

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
    "mlp_pack": [_P, _I, _P],
    "mlp_gemm_fwd": [_P] * 11 + [_I] * 5 + [_F, _P],
    "mlp_fold": [_I] + [_P] * 10 + [_I] * 4 + [_P, _P, _LL, _I, _P, _P, _LL, _I, _P],
    "mlp_final_fwd": [_P] * 6 + [_I] * 4 + [_F, _P],
    "mlp_final_bwd": [_P] * 14 + [_I] * 5 + [_F, _P],
    "mlp_gemm_dw": [_P] * 7 + [_I, _P] + [_I] * 6 + [_P],
    "mlp_gemm_dy": [_P, _P, _I] + [_P] * 7 + [_I] * 5 + [_F, _P],
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
    """Calls into the library on one stream; raises on a failed launch.
    Buffers are passed as addresses (ints)."""

    def __init__(self, lib, stream: int):
        self.lib, self.stream = lib, stream

    def __call__(self, name: str, *args):
        rc = getattr(self.lib, name)(*args, self.stream)
        if rc != 0:
            raise RuntimeError(f"{name} kernel launch failed: error {rc}")


# Host-side geometry of the kernels: 64-row tiles over the B*N rows (a
# product block holds two), items of N rows each. A tile's statistics are
# kept per item it holds ("slots"), and folded per item over its tiles in
# tile order.

def pad_k(c_in: int) -> int:
    """The first layer's depth, padded with zero columns to wgmma's k16."""
    return -(-c_in // K_ALIGN) * K_ALIGN


def tile_slots(n_points: int, B: int) -> int:
    """Most items a 64-row tile can hold: a tile starts on a multiple of 64
    and spans 63 further rows."""
    return min(B, -(-(TILE - 1) // n_points) + 1)


def dw_splits(rows: int, cout: int, cin: int) -> tuple:
    """(rows a split, splits) of a weight-gradient product: row ranges of
    whole 64-row stages, enough of them for about TARGET_BLOCKS blocks."""
    tiles = -(-cout // BLOCK_ROWS) * -(-cin // _tile_cols(cin))
    stages = -(-rows // TILE)
    per = -(-stages // max(1, min(stages, -(-TARGET_BLOCKS // tiles))))
    return per * TILE, -(-stages // per)


def _tile_cols(n: int) -> int:
    """A product tile's width for n output columns (csrc/mlp.cu nb_for)."""
    return 256 if n > 128 else 128 if n > 64 else 64


class _Workspace:
    """Addresses of named buffers in one byte allocation, each 256-byte
    aligned: `name` is an int, or a list of `count` ints."""

    def __init__(self, device, specs):
        """specs: (name, count or None, bytes of one buffer)."""
        sizes = [(name, count, -(-nbytes // 256) * 256) for name, count, nbytes in specs]
        self.buf = torch.empty(sum((c or 1) * n for _, c, n in sizes) or 1, dtype=torch.uint8,
                               device=device)
        addr = self.buf.data_ptr()
        for name, count, size in sizes:
            setattr(self, name, addr if count is None else [addr + k * size for k in range(count)])
            addr += (count or 1) * size


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
    if len(Ws) + 2 > MAX_SEGMENTS:
        raise ValueError(f"MLP kernels take at most {MAX_SEGMENTS - 2} hidden layers")
    dims = [c_in]
    for W, g, b in zip(Ws, gammas, betas):
        if W.dim() != 2 or W.shape[1] != dims[-1]:
            raise ValueError(f"hidden weight {tuple(W.shape)} does not take width {dims[-1]}")
        dims.append(W.shape[0])
        if g.shape != (dims[-1],) or b.shape != (dims[-1],):
            raise ValueError(f"norm affine {tuple(g.shape)}/{tuple(b.shape)} for width "
                             f"{dims[-1]}")
        if dims[-1] % 8:
            raise ValueError(f"MLP kernels take hidden widths that are multiples of 8, got "
                             f"{dims[-1]}")
    if Wf.dim() != 2 or Wf.shape[1] != dims[-1] or (bf is not None and
                                                    bf.shape != (Wf.shape[0],)):
        raise ValueError(f"final weight {tuple(Wf.shape)} does not take width {dims[-1]}")
    dims.append(Wf.shape[0])
    if c_in > MAX_IN or dims[-1] > MAX_IN:
        raise ValueError(f"MLP kernels take C_in and out <= {MAX_IN}, got {c_in}, {dims[-1]}")
    if dims[-2] > MAX_LAST:
        raise ValueError(f"MLP kernels take a last hidden width <= {MAX_LAST}, got {dims[-2]}")
    params = [*Ws, *gammas, *betas, Wf] + ([bf] if bf is not None else [])
    for t in params:
        if t.dtype != _F32 or not t.is_contiguous():
            raise ValueError("MLP parameters must be contiguous float32")
    if B * N * max(dims) >= 2**31 or -(-B * N // TILE) > 65535:
        raise ValueError(f"MLP kernels take at most 4M rows, got B*N = {B * N}")
    return dims


def _packed_shapes(dims) -> List[tuple]:
    """[rows, cols] of the packed bf16 weights W_0 (padded), ..., Wf."""
    cp = pad_k(dims[0])
    shapes = [(dims[i + 1], cp if i == 0 else dims[i]) for i in range(len(dims) - 2)]
    return shapes + [(dims[-1], dims[-2])]


def _packed_bytes(dims) -> int:
    return sum(-(-2 * r * c // 256) * 256 for r, c in _packed_shapes(dims))


def _pack(run: _Launcher, x, Ws, Wf, dims, ws) -> List[int]:
    """One launch: x and every weight cast to bf16 into the workspace, x and
    W_0 padded to pad_k(C_in) columns. Returns the packed weights'
    addresses [W_0, ..., W_{L-1}, Wf]."""
    rows = x.shape[0] * x.shape[1]
    segs, packed, addr = [x.data_ptr(), ws.xp, rows, dims[0], pad_k(dims[0])], [], ws.w
    for W, (r, c) in zip([*Ws, Wf], _packed_shapes(dims)):
        segs += [W.data_ptr(), addr, r, W.shape[1], c]
        packed.append(addr)
        addr += -(-2 * r * c // 256) * 256
    table = (ctypes.c_longlong * len(segs))(*segs)
    run("mlp_pack", ctypes.addressof(table), len(segs) // 5)
    return packed


def mlp_forward(x, Ws, gammas, betas, Wf, bf, slope: float = 0.01) -> torch.Tensor:
    """K2: logits [B, N, out] float32 of contiguous CUDA float32 x [B, N,
    C_in]. Raises on anything else."""
    _require_cuda(x, [*Ws, *gammas, *betas, Wf, bf])
    dims = _check_args(x, Ws, gammas, betas, Wf, bf)
    B, N, _ = x.shape
    rows, L, cp = B * N, len(Ws), pad_k(dims[0])
    cmax, tiles, slots = max(dims[1:-1]), -(-rows // TILE), tile_slots(N, B)
    run = _Launcher(_load(), _stream(x))
    ws = _Workspace(x.device, [("xp", None, 2 * rows * cp), ("w", None, _packed_bytes(dims)),
                               ("h", 2, 4 * rows * cmax), ("st", 2, 4 * B * cmax),
                               ("part", 2, 4 * tiles * slots * cmax)])
    Wp = _pack(run, x, Ws, Wf, dims, ws)
    gp, bp = [t.data_ptr() for t in gammas], [t.data_ptr() for t in betas]
    scale, shift = ws.st
    prev = ws.xp
    for i in range(L):
        h = ws.h[i % 2]
        if i == 0:
            run("mlp_gemm_fwd", prev, None, None, None, None, None, None, Wp[0], h, *ws.part,
                rows, dims[1], cp, N, slots, slope)
        else:
            run("mlp_gemm_fwd", prev, scale, shift, None, None, None, None, Wp[i], h, *ws.part,
                rows, dims[i + 1], dims[i], N, slots, slope)
        run("mlp_fold", 0, *ws.part, gp[i], bp[i], None, None, None, scale, shift, None,
            B, N, dims[i + 1], slots, None, None, 0, 0, None, None, 0, 0)
        prev = h
    out = torch.empty((B, N, dims[-1]), dtype=_F32, device=x.device)
    run("mlp_final_fwd", prev, scale, shift, Wp[L], bf.data_ptr(), out.data_ptr(), rows,
        dims[-2], dims[-1], N, slope)
    mlp_forward.launches += 1
    return out


def mlp_backward(x, g, Ws, gammas, betas, Wf, slope: float = 0.01):
    """K2b: the gradients of `mlp_forward` for the cotangent g [B, N, out]:
    (dx, dWs, dgammas, dbetas, dWf, dbf), float32, as
    `reference_pointnet_mlp_bwd` returns them."""
    _require_cuda(x, [g, *Ws, *gammas, *betas, Wf])
    dims = _check_args(x, Ws, gammas, betas, Wf, None)
    B, N, c_in = x.shape
    rows, L, cp, out_size, dev = B * N, len(Ws), pad_k(c_in), dims[-1], x.device
    if g.shape != (B, N, out_size) or g.dtype != _F32 or not g.is_contiguous():
        raise ValueError(f"cotangent must be contiguous float32 {(B, N, out_size)}, got "
                         f"{tuple(g.shape)} {g.dtype}")
    cmax, tiles, slots, c_last = max(dims[1:-1]), -(-rows // TILE), tile_slots(N, B), dims[-2]
    splits = [dw_splits(rows, dims[i + 1], dims[i]) for i in range(L)]
    gf_row = out_size * c_last + out_size  # a tile's Wf and bf gradient partials
    run = _Launcher(_load(), _stream(x))
    ws = _Workspace(dev, [
        ("xp", None, 2 * rows * cp), ("w", None, _packed_bytes(dims)),
        ("h", 2, 4 * rows * cmax), ("st", 4 * L, 4 * B * cmax),
        ("xin", L - 1, 2 * rows * cmax), ("xhat", L, 2 * rows * cmax),
        ("dz", 2, 2 * rows * cmax), ("dh", None, 2 * rows * cmax),
        ("part", 2, 4 * tiles * slots * cmax),
        ("k", 3, 4 * B * cmax), ("rsum", 2, 8 * B * cmax),
        ("dwp", None, 4 * max(n * dims[i + 1] * dims[i] for i, (_, n) in enumerate(splits))),
        ("gfp", None, 4 * tiles * gf_row)])
    Wp = _pack(run, x, Ws, Wf, dims, ws)
    gp, bp = [t.data_ptr() for t in gammas], [t.data_ptr() for t in betas]

    # The forward again, stashing each layer's input y and its xhat.
    prev = ws.xp
    for i in range(L):
        h, st = ws.h[i % 2], ws.st[4 * i:4 * i + 4]
        if i == 0:
            run("mlp_gemm_fwd", prev, None, None, None, None, None, None, Wp[0], h, *ws.part,
                rows, dims[1], cp, N, slots, slope)
        else:
            mean, inv, scale, shift = ws.st[4 * i - 4:4 * i]
            run("mlp_gemm_fwd", prev, scale, shift, mean, inv, ws.xin[i - 1], ws.xhat[i - 1],
                Wp[i], h, *ws.part, rows, dims[i + 1], dims[i], N, slots, slope)
        run("mlp_fold", 0, *ws.part, gp[i], bp[i], None, *st, None,
            B, N, dims[i + 1], slots, None, None, 0, 0, None, None, 0, 0)
        prev = h

    # Outputs: dbeta and dgamma of a layer side by side, as a fold job sums
    # the item sums [items][2 C]; dWf and dbf side by side likewise.
    dx = torch.empty((B, N, c_in), dtype=_F32, device=dev)
    dWs = [torch.empty((dims[i + 1], dims[i]), dtype=_F32, device=dev) for i in range(L)]
    dbg = [torch.empty((2, dims[i + 1]), dtype=_F32, device=dev) for i in range(L)]
    dgf = torch.empty(gf_row, dtype=_F32, device=dev)
    inv_of = lambda i: ws.st[4 * i + 1]  # noqa: E731
    dgfp = dgf.data_ptr()
    run("mlp_final_bwd", prev, *ws.st[4 * L - 4:], gp[L - 1], bp[L - 1], g.data_ptr(), Wp[L],
        ws.xhat[L - 1], ws.dz[0], *ws.part, ws.gfp, rows, c_last, out_size, N, slots, slope)
    run("mlp_fold", 1, *ws.part, gp[L - 1], None, inv_of(L - 1), *ws.k, None, ws.rsum[0],
        B, N, c_last, slots, ws.gfp, dgfp, gf_row, tiles, None, None, 0, 0)
    for i in range(L - 1, -1, -1):
        cout, cin, j = dims[i + 1], dims[i], L - 1 - i
        dz, dz_next = ws.dz[j % 2], ws.dz[(j + 1) % 2]
        rsum, rsum_next = ws.rsum[j % 2], ws.rsum[(j + 1) % 2]
        x_in, ldx = (ws.xp, cp) if i == 0 else (ws.xin[i - 1], cin)
        per, n = splits[i]
        run("mlp_gemm_dw", dz, ws.xhat[i], *ws.k, ws.dh, x_in, ldx, ws.dwp, rows, cout, cin, N,
            per, n)
        if i > 0:
            run("mlp_gemm_dy", ws.dh, Wp[i], cin, ws.xhat[i - 1], gp[i - 1], bp[i - 1], dz_next,
                *ws.part, None, rows, cout, cin, N, slots, slope)
            run("mlp_fold", 1, *ws.part, gp[i - 1], None, inv_of(i - 1), *ws.k, None,
                rsum_next, B, N, cin, slots, ws.dwp, dWs[i].data_ptr(), cout * cin, n, rsum,
                dbg[i].data_ptr(), 2 * cout, B)
        else:
            run("mlp_gemm_dy", ws.dh, Wp[0], cp, None, None, None, None, None, None,
                dx.data_ptr(), rows, cout, c_in, N, slots, slope)
            run("mlp_fold", -1, None, None, None, None, None, None, None, None, None, None,
                B, N, cin, slots, ws.dwp, dWs[0].data_ptr(), cout * cin, n, rsum,
                dbg[0].data_ptr(), 2 * cout, B)
    mlp_backward.launches += 1
    dWf = dgf[:out_size * c_last].view(out_size, c_last)
    return dx, dWs, [d[1] for d in dbg], [d[0] for d in dbg], dWf, dgf[out_size * c_last:]


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
