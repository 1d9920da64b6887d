"""The 64 -> 64 fused 3x3 conv + affine + ReLU in bf16, in the four
formulations of the conv-formulation shootout (X1-X4).

Replaces the TPU kernels of `tools/bench_conv_formulations.py` (its
`make_fn`, `make_dma_fn`, `make_t4_fn` and `make_s2d_fn`). Every
formulation computes K5's function, y = relu(conv3x3_same(x, w) * s + t)
in NHWC, with x [B, H, W, 64] bf16, w [3, 3, 64, 64] cast to x's dtype,
s and t [64] float32, float32 sums, and one rounding to bf16 at the end.

All four run one kernel on `wgmma` fed by TMA (`conv_wgmma_kernel`):
work items of th x tw output pixels (X2: groups), a producer warp
bringing each item's halo by TMA into a ring of mbarrier stages, one
64-row M tile a consumer warpgroup (A by ldmatrix from the halo for
taps9, ky3 and s2d9, from a patch built per K slice for im2col and s2dc).
They differ in how blocks take items:

- `conv_strip` (X4; kinds taps9, ky3, im2col): a block per (image,
  th-row strip) that walks the strip's chunks of th x tw = 128 or 256
  pixels left to right;
- `conv_strip_async` (X1; ky3, im2col): persistent blocks walking th x tw =
  128-pixel items;
- `conv_tile2d` (X3; ky3, im2col): one block per th x tw = 128 output tile,
  each loading all nine weight boxes, two blocks an SM;
- `conv_s2d` (X2; s2dc, s2d9): X1's walk on the free view [B, H, W/2,
  128], th x tg = 128-group items, with the weights of `pack_w_s2d` or
  `pack_w_s2d9` streamed through their own ring. Half of those weights are
  structural zeros: s2d does 2x the useful FLOPs.

Each wrapper runs its formulation's plain version for a tensor on the CPU
(`PLAIN`: taps9, ky3 and im2col; the dma-* and t4-* kinds share the ky3
and im2col ones; s2dc and s2d9) and launches its kernel in
`csrc/conv_formulations.cu` for a CUDA tensor, or raises. A plain version
does its formulation's products in float32 from the bf16-rounded x and w,
adds the affine (a product, then a sum, each rounded), applies the ReLU
and rounds once to x's dtype, as the kernels do; it runs image by image,
since im2col's float32 patch of a [8, 376, 1240, 64] batch is 8.6 GB.
Each wrapper counts its launches in `.launches`. The kernels read only
the packed weights from the wrapper; each block stages its own halo from
the unpadded x.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from ..utils import build

SOURCE = "conv_formulations.cu"
C = 64
SMEM_LIMIT = 232_448  # a block's shared memory on Hopper (227 KB)
MAX_B = 65535
# csrc/conv_formulations.cu's `wgmma_layout`.
BOX = 8192  # a [64][64] bf16 tile
MAX_HALO_STAGES, MAX_W_STAGES = 4, 6
TAIL_BYTES = 768  # the barriers (256 bytes), then s and t
CHANNELS = {"strip": C, "strip_async": C, "tile2d": C, "s2d": 2 * C}  # of a halo element
# Pixels (X2: groups) of a work item, 64 a consumer warpgroup.
ITEM_ROWS = {"strip": (128, 256), "strip_async": (128,), "tile2d": (128,), "s2d": (128,)}
PATCH_KINDS = ("im2col", "s2dc")  # A from a patch; taps9, ky3 and s2d9 read the halo in place
# A warpgroup's 8 KB patch slots where not 2 (`patch_slots`): X3 fits two blocks an SM.
PATCH_SLOTS = {"tile2d": 1}
ERR_TENSOR_MAP = 9001  # the C interface's code for a refused TMA tensor map
# The C interface's codes (csrc/conv_formulations.cu).
KINDS = {"taps9": 0, "ky3": 1, "im2col": 2, "s2dc": 3, "s2d9": 4}
FAMILIES = {"strip": (0, ("taps9", "ky3", "im2col")),
            "strip_async": (1, ("ky3", "im2col")),
            "tile2d": (2, ("ky3", "im2col")),
            "s2d": (3, ("s2dc", "s2d9"))}

_lib = None


def pad_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


# ---------------------------------------------------------------- packers
# The counterparts of the tool's in-wrapper `w_in` builds; each casts to
# `dtype` (x's) as the tool does.
def pack_w_ky3(w, dtype):
    """[3(ky), 3(kx), C, C] -> [3(kx), 3C (ky-major rows), C]."""
    c = w.shape[-1]
    return w.to(dtype).permute(1, 0, 2, 3).reshape(3, 3 * c, c)


def pack_w_im2col(w, dtype):
    """[3, 3, C, C] -> [9C, C], rows (ky, kx, ci)."""
    c = w.shape[-1]
    return w.to(dtype).reshape(9 * c, c)


def _s2d_blocks(w):
    """[3(ky), 3(k), 2(dx), C(ci), 2(j), C(co)]: W[ky, 2k - 1 + dx - j] where
    that tap exists, else 0 (the input group k - 1 of an output group)."""
    c = w.shape[-1]
    wpad = F.pad(w, (0, 0, 0, 0, 2, 2))  # kx + 2 in [0, 7); 0, 1, 5, 6 are zeros
    ar = torch.arange(3, device=w.device)
    kx = 2 * ar.view(3, 1, 1) - 1 + ar[:2].view(1, 2, 1) - ar[:2].view(1, 1, 2)
    return wpad[:, kx + 2].permute(0, 1, 2, 4, 3, 5).reshape(3, 3, 2, c, 2, c)


def pack_w_s2d(w):
    """[3,3,C,C] -> [3(ky), 3*2C, 2C]: rows (k group slot, dx, ch), cols
    (j, co); entry = W[ky, 2k-1+dx-j, ch, co] or 0. Keeps w's dtype."""
    c = w.shape[-1]
    return _s2d_blocks(w).reshape(3, 6 * c, 2 * c)


def pack_w_s2d9(w):
    """[3,3,C,C] -> [3(ky), 3(k), 2C, 2C] per-slot weights (pack_w_s2d's
    entries in the same memory order)."""
    c = w.shape[-1]
    return _s2d_blocks(w).reshape(3, 3, 2 * c, 2 * c)


def pack_w(kind: str, w, dtype):
    """The packed weights formulation `kind` reads, in `dtype`."""
    if kind == "taps9":
        return w.to(dtype)
    if kind == "ky3":
        return pack_w_ky3(w, dtype)
    if kind == "im2col":
        return pack_w_im2col(w, dtype)
    if kind == "s2dc":
        return pack_w_s2d(w).to(dtype)
    if kind == "s2d9":
        return pack_w_s2d9(w).to(dtype)
    raise ValueError(f"unknown formulation {kind!r}")


# ---------------------------------------------------------- plain versions
@contextlib.contextmanager
def _f32_matmuls():
    """Float32 products in full float32 (no TF32) on the card."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _images(x, w, s, t, kind: str, products):
    """Run `products(image [H, W, C] float32 with a zero border, packed w in
    float32) -> [H * W, C] float32 sums` image by image, then the epilogue."""
    B, H, W, c = x.shape
    wp = pack_w(kind, w, x.dtype).float()
    s, t = s.float(), t.float()
    ys = []
    with _f32_matmuls():
        for b in range(B):
            acc = products(F.pad(x[b].float(), (0, 0, 1, 1, 1, 1)), wp, H, W, c)
            ys.append(torch.relu(acc * s + t).to(x.dtype).view(H, W, c))
    return torch.stack(ys)


def _taps9(xp, wp, H, W, c):
    acc = torch.zeros(H * W, c, dtype=torch.float32, device=xp.device)
    for ky in range(3):
        for kx in range(3):
            acc += xp[ky:ky + H, kx:kx + W].reshape(H * W, c) @ wp[ky, kx]
    return acc


def _ky3(xp, wp, H, W, c):
    patch = torch.cat([xp[ky:ky + H] for ky in range(3)], dim=-1)  # [H, W + 2, 3C]
    acc = torch.zeros(H * W, c, dtype=torch.float32, device=xp.device)
    for kx in range(3):
        acc += patch[:, kx:kx + W].reshape(H * W, 3 * c) @ wp[kx]
    return acc


def _im2col(xp, wp, H, W, c):
    patch = torch.cat([xp[ky:ky + H, kx:kx + W] for ky in range(3) for kx in range(3)], dim=-1)
    return patch.reshape(H * W, 9 * c) @ wp


def _s2d_groups(xp, H, W, c):
    """The padded image's s2d view: [H + 2, W/2 + 2, 2C], a zero group on
    each side."""
    return F.pad(xp[:, 1:W + 1].reshape(H + 2, W // 2, 2 * c), (0, 0, 1, 1))


def _s2dc(xp, wp, H, W, c):
    G, xg = W // 2, _s2d_groups(xp, H, W, c)
    patch = torch.cat([xg[:, k:k + G] for k in range(3)], dim=-1)  # [H + 2, G, 6C]
    acc = torch.zeros(H * G, 2 * c, dtype=torch.float32, device=xp.device)
    for ky in range(3):
        acc += patch[ky:ky + H].reshape(H * G, 6 * c) @ wp[ky]
    return acc.view(H * W, c)


def _s2d9(xp, wp, H, W, c):
    G, xg = W // 2, _s2d_groups(xp, H, W, c)
    acc = torch.zeros(H * G, 2 * c, dtype=torch.float32, device=xp.device)
    for ky in range(3):
        for k in range(3):
            acc += xg[ky:ky + H, k:k + G].reshape(H * G, 2 * c) @ wp[ky, k]
    return acc.view(H * W, c)


def taps9_ref(x, w, s, t):
    """Plain taps9: 9 products of K = C, one a tap, summed in tap order."""
    return _images(x, w, s, t, "taps9", _taps9)


def ky3_ref(x, w, s, t):
    """Plain ky3: 3 products of K = 3C over the ky-stacked patch."""
    return _images(x, w, s, t, "ky3", _ky3)


def im2col_ref(x, w, s, t):
    """Plain im2col: one product of K = 9C over the 9-tap patch."""
    return _images(x, w, s, t, "im2col", _im2col)


def s2dc_ref(x, w, s, t):
    """Plain s2dc (W even): 3 products of K = 6C with pack_w_s2d."""
    _even(x)
    return _images(x, w, s, t, "s2dc", _s2dc)


def s2d9_ref(x, w, s, t):
    """Plain s2d9 (W even): 9 products of K = 2C with pack_w_s2d9."""
    _even(x)
    return _images(x, w, s, t, "s2d9", _s2d9)


PLAIN = {"taps9": taps9_ref, "ky3": ky3_ref, "im2col": im2col_ref, "s2dc": s2dc_ref,
         "s2d9": s2d9_ref}


def _even(x):
    if x.shape[2] % 2:
        raise ValueError(f"s2d takes an even width, got W = {x.shape[2]}")


# ------------------------------------------------------------- the kernels
def _round1024(v: int) -> int:
    return (v + 1023) // 1024 * 1024


def wgmma_layout(family: str, kind: str, th: int, tw: int) -> dict | None:
    """The shared memory of a block (the C source's `wgmma_layout`): the
    halo ring (`halo_stages` of `halo_stage` bytes, one 1024-aligned [th+2,
    tw+2, 64] box a 64-channel half), the weights (nine [64][64] boxes
    resident for 64 channels, X2's `w_stages` K slices of two boxes), the
    patch slots (for im2col and s2dc, two a warpgroup or PATCH_SLOTS'), the
    barriers with s and t, after up to 1024 bytes of alignment. `nwg`
    warpgroups take an item of 64 nwg pixels. Up to 4 halo stages and at
    least 2, but X3's one item a block takes 1. None for a tile no kernel
    takes."""
    cin = CHANNELS[family]
    if th < 1 or tw < 1 or th * tw not in ITEM_ROWS[family]:
        return None
    nwg = th * tw // 64
    halo_stage = cin // 64 * _round1024(128 * (th + 2) * (tw + 2))
    patch = PATCH_SLOTS.get(family, 2) * nwg * BOX if kind in PATCH_KINDS else 0
    room = SMEM_LIMIT - 1024 - TAIL_BYTES - patch
    cap, least = (1, 1) if family == "tile2d" else (MAX_HALO_STAGES, 2)
    if cin == C:
        weights, w_stages = 9 * BOX, 0
        halo_stages = min(cap, (room - weights) // halo_stage)
    else:
        halo_stages = 2
        w_stages = min(MAX_W_STAGES, (room - 2 * halo_stage) // (2 * BOX))
        weights = 2 * BOX * w_stages
        if w_stages < 2:
            return None
    if halo_stages < least:
        return None
    total = 1024 + halo_stages * halo_stage + weights + patch + TAIL_BYTES
    return {"halo_stage": halo_stage, "halo_stages": halo_stages, "w_stages": w_stages,
            "nwg": nwg, "weights": weights, "patch": patch, "total": total}


def smem_bytes(family: str, kind: str, th: int, tw: int) -> int:
    """Shared memory a block of `family` takes for `kind` at tile th x tw
    (tw in groups of two pixels for s2d), or -1 for a tile no kernel takes
    (`conv_formulations_smem_bytes`): `wgmma_layout`'s total."""
    if kind not in FAMILIES[family][1]:
        return -1
    layout = wgmma_layout(family, kind, th, tw)
    return -1 if layout is None else layout["total"]


def check_tile(family: str, kind: str, th: int, tw: int) -> int:
    """Raise ValueError unless `family` takes `kind` at this tile; returns
    the block's shared memory."""
    if family not in FAMILIES or kind not in FAMILIES[family][1]:
        raise ValueError(f"{family} takes kinds {FAMILIES.get(family, (0, ()))[1]}, got {kind!r}")
    rows = ITEM_ROWS[family]
    if th < 1 or tw < 1 or th * tw not in rows:
        raise ValueError(f"{family} takes tiles of th x tw = {' or '.join(map(str, rows))} "
                         f"(64-row wgmma tiles, one a warpgroup), got {th} x {tw}")
    smem = smem_bytes(family, kind, th, tw)
    if smem < 0:
        raise ValueError(f"{family} {kind} at {th} x {tw} does not fit its staging in a "
                         f"block's {SMEM_LIMIT} bytes of shared memory")
    return smem


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from SOURCE."""
    P, I = ctypes.c_void_p, ctypes.c_int
    for name in ("conv_strip_bf16", "conv_strip_async_bf16", "conv_tile2d_bf16",
                 "conv_s2d_bf16"):
        getattr(lib, name).argtypes = [P, P, P, P, P, I, I, I, I, I, I, P]
        getattr(lib, name).restype = ctypes.c_int
    lib.conv_formulations_smem_bytes.argtypes = [I, I, I, I]
    lib.conv_formulations_smem_bytes.restype = ctypes.c_longlong
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(build.load(SOURCE))
    return _lib


def _check(x, w, s, t):
    ts = (x, w, s, t)
    if not all(v.is_cuda and v.device == x.device for v in ts):
        raise ValueError(f"the conv formulation kernels take CUDA tensors on one device, got "
                         f"{[str(v.device) for v in ts]}")
    if x.dtype != torch.bfloat16 or x.dim() != 4 or x.shape[-1] != C or 0 in x.shape:
        raise ValueError(f"the conv formulation kernels take x [B, H, W, {C}] bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.shape[0] > MAX_B:
        raise ValueError(f"the conv formulation kernels take at most {MAX_B} images")
    if tuple(w.shape) != (3, 3, C, C) or not w.is_floating_point():
        raise ValueError(f"w must be [3, 3, {C}, {C}] floating, got {tuple(w.shape)} {w.dtype}")
    if any(tuple(v.shape) != (C,) or v.dtype != torch.float32 for v in (s, t)):
        raise ValueError(f"s and t must be [{C}] float32, got {tuple(s.shape)} {s.dtype}, "
                         f"{tuple(t.shape)} {t.dtype}")
    if not all(v.is_contiguous() for v in (x, s, t)) or x.data_ptr() % 16:
        raise ValueError("x, s and t must be contiguous, x 16-byte aligned")


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch(wrapper, family: str, x, w, s, t, kind: str, th: int, tw: int):
    """The plain version on a CPU tensor; on a CUDA tensor the kernel of
    `family` (counted on `wrapper.launches`), or a raise."""
    check_tile(family, kind, th, tw)
    if x.device.type == "cpu":
        return PLAIN[kind](x, w, s, t)
    _check(x, w, s, t)
    if family == "s2d":
        _even(x)
    lib = _load()
    entry = f"conv_{family}_bf16"
    B, H, W, _ = x.shape
    with torch.cuda.device(x.device):
        wp = pack_w(kind, w, x.dtype).contiguous()
        y = torch.empty_like(x)
        rc = getattr(lib, entry)(x.data_ptr(), wp.data_ptr(), s.data_ptr(), t.data_ptr(),
                                 y.data_ptr(), B, H, W, KINDS[kind], th, tw, _stream(x))
    if rc == ERR_TENSOR_MAP:
        raise RuntimeError(f"{entry} ({kind}, {th} x {tw}): the TMA tensor maps were refused")
    if rc != 0:
        raise RuntimeError(f"{entry} ({kind}, {th} x {tw}) launch failed: cudaError {rc}")
    wrapper.launches += 1
    return y


def conv_strip(x, w, s, t, kind: str = "taps9", th: int = 4, tw: int = 64):
    """X4: a block per (image, th-row strip), chunks of th x tw = 128 or 256
    pixels at a time."""
    return _launch(conv_strip, "strip", x, w, s, t, kind, th, tw)


def conv_strip_async(x, w, s, t, kind: str = "ky3", th: int = 4, tw: int = 32):
    """X1: ky3 / im2col on `wgmma`, th x tw = 128-pixel items, the halo by TMA."""
    return _launch(conv_strip_async, "strip_async", x, w, s, t, kind, th, tw)


def conv_tile2d(x, w, s, t, kind: str = "ky3", th: int = 8, tw: int = 16):
    """X3: one block per th x tw = 128 output tile with its halo."""
    return _launch(conv_tile2d, "tile2d", x, w, s, t, kind, th, tw)


def conv_s2d(x, w, s, t, kind: str = "s2dc", th: int = 8, tg: int = 16):
    """X2: th x tg = 128-group items of the [B, H, W/2, 128] view (W even)."""
    return _launch(conv_s2d, "s2d", x, w, s, t, kind, th, tg)


for _fn in (conv_strip, conv_strip_async, conv_tile2d, conv_s2d):
    _fn.launches = 0
del _fn
