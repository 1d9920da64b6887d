"""The eigh9 kernel's wrapper: batched 9x9 symmetric eigendecomposition.

Replaces `deepfepe_tpu/ops/pallas/eigh9_pallas.py` (`eigh9_pallas`). The
kernels are in `csrc/eigh9.cu`, built by nvcc at first use and bound by
ctypes (`utils/build.py`): a warp per matrix below `CROSSOVER_B` matrices,
a thread per matrix at or above it (`route`). Either one symmetrizes,
solves, sorts and fixes the signs in one launch. Its plain version is
`ops.jacobi.jacobi_eigh`, which the wrapper runs only for a tensor on the
CPU; for a CUDA tensor it launches a kernel or raises. `eigh9.launches`
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import build
from .jacobi import jacobi_eigh

SOURCE = "eigh9.cu"
SWEEPS = 7
# Batches below this many matrices take the warp kernel, the rest the
# thread kernel: on the H100 the warp kernel was the faster at B = 2048
# and the thread kernel at 3072, the first measured batch where it won
# (chip_smoke.py's eigh9 timings; PERF.md).
CROSSOVER_B = 3072
KERNELS = {"warp": "eigh9_warp_f32", "thread": "eigh9_thread_f32"}

_lib = None


def route(B: int) -> str:
    """The kernel that a batch of B matrices takes."""
    return "warp" if B < CROSSOVER_B else "thread"


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from SOURCE."""
    P, I = ctypes.c_void_p, ctypes.c_int
    for name in KERNELS.values():
        getattr(lib, name).argtypes = [P, P, P, I, I, P]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(build.load(SOURCE))
    return _lib


def launch(A: torch.Tensor, sweeps: int = SWEEPS, kernel: str | None = None):
    """Run a kernel on contiguous CUDA f32 [B, 9, 9] (symmetrized inside);
    returns (w [B, 9] ascending, V [B, 9, 9]) with eigenvector signs fixed.
    `kernel` ('warp' or 'thread') overrides `route(B)`."""
    if kernel is not None and kernel not in KERNELS:
        raise ValueError(f"eigh9 kernel {kernel!r} is not one of {sorted(KERNELS)}")
    if not (A.is_cuda and A.dtype == torch.float32 and A.dim() == 3
            and A.shape[1:] == (9, 9) and A.is_contiguous()):
        raise ValueError(
            f"eigh9 kernel takes a contiguous CUDA float32 [B, 9, 9] tensor, got "
            f"{tuple(A.shape)} {A.dtype} on {A.device}"
            f"{'' if A.is_contiguous() else ' (not contiguous)'}")
    B = A.shape[0]
    if B >= 2**31:
        raise ValueError(f"eigh9 batch {B} exceeds the kernel's int range")
    fn = getattr(_load(), KERNELS[route(B) if kernel is None else kernel])
    w = torch.empty((B, 9), dtype=A.dtype, device=A.device)
    V = torch.empty((B, 9, 9), dtype=A.dtype, device=A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = fn(A.data_ptr(), w.data_ptr(), V.data_ptr(), B, sweeps, stream)
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
    w, V = launch(A.reshape(-1, 9, 9), sweeps)
    return w.reshape(lead + (9,)), V.reshape(lead + (9, 9))


eigh9.launches = 0
