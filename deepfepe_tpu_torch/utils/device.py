"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means the card. Asking for CUDA where there is none raises:
    the port never drops to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


def batch_to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


@contextlib.contextmanager
def no_tf32():
    """float32 products in full float32 inside the block (also as a function
    decorator): cuBLAS and cuDNN may otherwise take TF32 paths on the card,
    whose 10-bit mantissa stalls a Gauss-Newton solve. The CPU has no such
    path."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
