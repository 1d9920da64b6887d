"""Masked mutual-nearest-neighbour search over descriptors: kernel K4.

Replaces `deepfepe_tpu/ops/pallas/matcher_pallas.py` (`mutual_nn_pallas`).
For unit descriptors desc1, desc2 [B, K, D] and validity masks valid1,
valid2 [B, K] it returns (nn12, nn21, dist12, mutual): each row's best
column and each column's best row by similarity, with an additive -1e9 on
invalid columns (for nn12) and rows (for nn21), ties to the lowest index;
dist12 = sqrt(max(2 - 2 best12, 0)); and the mutual check.

`mutual_nn_kernel` runs the plain version, `mutual_nn_plain`, for tensors on
the CPU; for CUDA tensors it launches `csrc/matcher.cu` or raises: a tile
kernel writes per-tile (best, index) partials to scratch the wrapper
allocates, and a fold kernel reduces them. Its outputs carry no gradient
(the TPU kernel has no VJP either); the matcher recomputes the chosen
pairs' distances from the indices (frontend/matching.py).
`mutual_nn_kernel.launches` counts calls (two CUDA launches each).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import build

SOURCE = "matcher.cu"
NEG = -1e9
MAX_B = 65535

_lib = None


def _mutual(nn12, nn21, valid1, valid2):
    K = nn12.shape[-1]
    ar = torch.arange(K, device=nn12.device)
    back = torch.gather(nn21, -1, nn12.long())
    return (back == ar) & valid1 & torch.gather(valid2, -1, nn12.long())


def mutual_nn_plain(desc1, desc2, valid1, valid2):
    """Plain version: the [B, K, K] similarity in float32, additive masks,
    `torch.argmax` (first index on ties)."""
    m1 = torch.where(valid1, 0.0, NEG).to(torch.float32)
    m2 = torch.where(valid2, 0.0, NEG).to(torch.float32)
    dot = desc1.float() @ desc2.float().transpose(-1, -2)
    dot12 = dot + m2[:, None, :]
    dot21 = dot + m1[:, :, None]
    nn12 = torch.argmax(dot12, dim=-1).to(torch.int32)
    nn21 = torch.argmax(dot21, dim=-2).to(torch.int32)
    best12 = dot12.amax(dim=-1)
    dist12 = torch.sqrt(torch.clamp(2.0 - 2.0 * best12, min=0.0))
    return nn12, nn21, dist12, _mutual(nn12, nn21, valid1, valid2)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from SOURCE."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mutual_nn_f32.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, P]
    lib.mutual_nn_f32.restype = ctypes.c_int
    lib.mutual_nn_f32_scratch_bytes.argtypes = [I, I]
    lib.mutual_nn_f32_scratch_bytes.restype = ctypes.c_longlong
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(build.load(SOURCE))
    return _lib


def launch(desc1, desc2, valid1, valid2):
    """Run K4 on CUDA tensors; returns (nn12, nn21, dist12)."""
    ts = (desc1, desc2, valid1, valid2)
    if desc1.dim() != 3 or desc2.shape != desc1.shape or valid1.shape != desc1.shape[:2] \
            or valid2.shape != desc1.shape[:2]:
        raise ValueError(f"K4 takes desc1, desc2 [B, K, D] and valid1, valid2 [B, K], got "
                         f"{[tuple(t.shape) for t in ts]}")
    if desc1.dtype != torch.float32 or desc2.dtype != torch.float32 \
            or valid1.dtype != torch.bool or valid2.dtype != torch.bool:
        raise ValueError("K4 takes float32 descriptors and bool masks")
    B, K, D = desc1.shape
    if B > MAX_B:
        raise ValueError(f"K4 takes at most {MAX_B} pairs, got {B}")
    if not all(t.is_cuda and t.device == desc1.device for t in ts):
        raise ValueError(f"the K4 kernel takes CUDA tensors on one device, got "
                         f"{[str(t.device) for t in ts]}")
    d1, d2 = desc1.detach().contiguous(), desc2.detach().contiguous()
    v1, v2 = valid1.contiguous(), valid2.contiguous()
    # 16-byte copies need rows that start on 16-byte boundaries.
    vec = int(D % 4 == 0 and d1.data_ptr() % 16 == 0 and d2.data_ptr() % 16 == 0)
    lib = _load()
    nn12 = torch.empty((B, K), dtype=torch.int32, device=desc1.device)
    nn21 = torch.empty_like(nn12)
    dist12 = torch.empty((B, K), dtype=torch.float32, device=desc1.device)
    scratch = torch.empty(lib.mutual_nn_f32_scratch_bytes(B, K), dtype=torch.uint8,
                          device=desc1.device)
    with torch.cuda.device(desc1.device):
        stream = torch.cuda.current_stream(desc1.device).cuda_stream
        rc = lib.mutual_nn_f32(d1.data_ptr(), d2.data_ptr(), v1.data_ptr(), v2.data_ptr(),
                               nn12.data_ptr(), nn21.data_ptr(), dist12.data_ptr(),
                               scratch.data_ptr(), B, K, D, vec, stream)
    if rc != 0:
        raise RuntimeError(f"K4 kernel launch failed: cudaError {rc}")
    mutual_nn_kernel.launches += 1
    return nn12, nn21, dist12


def mutual_nn_kernel(desc1, desc2, valid1, valid2):
    """(nn12 int32, nn21 int32, dist12 float32, mutual bool), each [B, K].
    CPU tensors take the plain version; CUDA tensors launch K4."""
    if desc1.device.type == "cpu":
        return mutual_nn_plain(desc1, desc2, valid1, valid2)
    nn12, nn21, dist12 = launch(desc1, desc2, valid1, valid2)
    return nn12, nn21, dist12, _mutual(nn12, nn21, valid1, valid2)


mutual_nn_kernel.launches = 0
