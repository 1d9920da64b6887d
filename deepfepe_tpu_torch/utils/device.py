"""Device selection for the port's entry points."""

from __future__ import annotations

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
