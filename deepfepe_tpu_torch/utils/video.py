"""Result frames stitched into a video, and the warp sanity picture.

Counterpart of `deepfepe_tpu/utils/video.py` (the reference's
`tools/save_video.py` and `tools/visualize_warping.py`). The port uses no
OpenCV, so `save_video` writes what the JAX package writes where cv2 is
missing: a PNG sequence through matplotlib, imported inside the call, so
on a machine without matplotlib it raises ImportError, as the JAX
package's does. `visualize_warp_pair` warps with this package's
`utils/warp.transform_image`.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch


def save_video(frames: Sequence[np.ndarray], out_path: str, fps: int = 10) -> str:
    """Write frames ([H, W] or [H, W, 3], uint8 or [0, 1] float) as the
    PNG sequence `out_path` without its suffix, `%06d.png`; returns that
    directory. `fps` is the JAX signature's (no video container here)."""
    import matplotlib.pyplot as plt

    frames = [(np.clip(f, 0, 1) * 255).astype(np.uint8)
              if np.issubdtype(np.asarray(f).dtype, np.floating) else np.asarray(f, np.uint8)
              for f in frames]
    out_dir = Path(out_path).with_suffix("")
    os.makedirs(out_dir, exist_ok=True)
    for i, f in enumerate(frames):
        plt.imsave(out_dir / f"{i:06d}.png", f, cmap="gray")
    return str(out_dir)


def visualize_warp_pair(img1: np.ndarray, img2: np.ndarray, H_mat: np.ndarray,
                        save_path: Optional[str] = None) -> np.ndarray:
    """img1 warped by H_mat beside img2 as an RGB blend: a check that the
    homography aligns them (ref tools/visualize_warping.py); saved to
    `save_path` through matplotlib when it is given."""
    from .warp import transform_image

    img = torch.as_tensor(np.asarray(img1[..., None] if img1.ndim == 2 else img1, np.float32))
    M = torch.as_tensor(np.linalg.inv(H_mat), dtype=torch.float32)
    warped = transform_image(img, M).numpy()[..., 0]
    blend = np.stack([warped, img2 if img2.ndim == 2 else img2[..., 0], np.zeros_like(warped)], -1)
    if save_path:
        import matplotlib.pyplot as plt

        plt.imsave(save_path, np.clip(blend, 0, 1))
    return blend
