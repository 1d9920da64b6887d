"""The eigh9 kernel's wrapper: batched 9x9 symmetric eigendecomposition.

Replaces `deepfepe_tpu/ops/pallas/eigh9_pallas.py` (`eigh9_pallas`). The
kernel is `csrc/eigh9.cu`, built by nvcc at first use and bound by ctypes
(`utils/build.py`). Its plain version is `ops.jacobi.jacobi_eigh`, which
the wrapper runs only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises. `eigh9.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import build
from .jacobi import jacobi_eigh, sort_and_fix_signs

SOURCE = "eigh9.cu"
SWEEPS = 7

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        lib.eigh9_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.eigh9_f32.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(A: torch.Tensor, sweeps: int = SWEEPS):
    """Run the kernel on symmetric, contiguous CUDA f32 [B, 9, 9]; returns
    the unsorted (w [B, 9], V [B, 9, 9])."""
    if not (A.is_cuda and A.dtype == torch.float32 and A.dim() == 3
            and A.shape[1:] == (9, 9) and A.is_contiguous()):
        raise ValueError(
            f"eigh9 kernel takes a contiguous CUDA float32 [B, 9, 9] tensor, got "
            f"{tuple(A.shape)} {A.dtype} on {A.device}"
            f"{'' if A.is_contiguous() else ' (not contiguous)'}")
    B = A.shape[0]
    if B >= 2**31:
        raise ValueError(f"eigh9 batch {B} exceeds the kernel's int range")
    lib = _load()
    w = torch.empty((B, 9), dtype=A.dtype, device=A.device)
    V = torch.empty((B, 9, 9), dtype=A.dtype, device=A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = lib.eigh9_f32(A.data_ptr(), w.data_ptr(), V.data_ptr(), B, sweeps, stream)
    if rc != 0:
        raise RuntimeError(f"eigh9 kernel launch failed: cudaError {rc}")
    eigh9.launches += 1
    return w, V


def eigh9(A: torch.Tensor, sweeps: int = SWEEPS):
    """Eigendecomposition of symmetric [..., 9, 9] -> (w [..., 9] ascending,
    V [..., 9, 9]) with the largest-|.| component of each eigenvector
    positive. CPU tensors take the plain version."""
    if A.device.type == "cpu":
        return jacobi_eigh(A, sweeps)
    if not A.is_cuda or A.dtype != torch.float32 or A.shape[-2:] != (9, 9) \
            or not A.is_contiguous():
        raise ValueError(
            f"eigh9 takes a contiguous CUDA float32 [..., 9, 9] tensor, got "
            f"{tuple(A.shape)} {A.dtype} on {A.device}")
    lead = A.shape[:-2]
    A_sym = ((A + A.transpose(-1, -2)) * 0.5).reshape(-1, 9, 9)
    w, V = launch(A_sym, sweeps)
    w, V = sort_and_fix_signs(w, V)
    return w.reshape(lead + (9,)), V.reshape(lead + (9, 9))


eigh9.launches = 0
