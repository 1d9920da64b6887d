"""Visualization: epipolar lines, correspondences, weight heatmaps, grids.

Counterpart of `deepfepe_tpu/utils/vis.py`, copied (numpy and
matplotlib, nothing of torch): the reference's `dsac_tools/utils_vis.py`
(`draw_corr` :53, `show_epipolar_rui_gtEst` :208, `reproj_and_scatter`
:150) and `utils/plot_tools.py` (`plot_results` :17). matplotlib is
imported inside each plot, so the module imports without it; a plot call
on a machine without it raises ImportError, as the JAX package's does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _epiline_endpoints(line: np.ndarray, W: int, H: int):
    """Clip line ax+by+c=0 to the image border; returns (p0, p1) or None."""
    a, b, c = line
    pts = []
    if abs(b) > 1e-12:
        for x in (0.0, float(W)):
            y = -(a * x + c) / b
            if -1 <= y <= H + 1:
                pts.append((x, y))
    if abs(a) > 1e-12:
        for y in (0.0, float(H)):
            x = -(b * y + c) / a
            if -1 <= x <= W + 1:
                pts.append((x, y))
    if len(pts) < 2:
        return None
    return pts[0], pts[1]


def draw_corr(
    img1: np.ndarray,
    img2: np.ndarray,
    x1: np.ndarray,
    x2: np.ndarray,
    mask: Optional[np.ndarray] = None,
    linewidth: float = 0.5,
    ax=None,
    title: str = "",
):
    """Side-by-side correspondence plot (ref: utils_vis.draw_corr :53)."""
    import matplotlib.pyplot as plt

    H = max(img1.shape[0], img2.shape[0])
    W1 = img1.shape[1]
    canvas = np.zeros((H, W1 + img2.shape[1]) + img1.shape[2:], img1.dtype)
    canvas[: img1.shape[0], :W1] = img1
    canvas[: img2.shape[0], W1:] = img2
    if ax is None:
        _, ax = plt.subplots(figsize=(12, 4))
    ax.imshow(canvas, cmap="gray" if canvas.ndim == 2 else None)
    if mask is None:
        mask = np.ones(len(x1), bool)
    for (p, q, m) in zip(x1, x2, mask):
        color = "lime" if m else "red"
        ax.plot([p[0], q[0] + W1], [p[1], q[1]], color=color,
                linewidth=linewidth)
    ax.scatter(x1[:, 0], x1[:, 1], s=2, c="yellow")
    ax.scatter(x2[:, 0] + W1, x2[:, 1], s=2, c="yellow")
    ax.set_title(title)
    ax.axis("off")
    return ax


def show_epipolar(
    img1: np.ndarray,
    img2: np.ndarray,
    x1: np.ndarray,
    x2: np.ndarray,
    F: np.ndarray,
    F_gt: Optional[np.ndarray] = None,
    max_lines: int = 20,
    axes=None,
):
    """Epipolar lines of x1 drawn in image 2 (est vs optional gt F)
    (ref: utils_vis.show_epipolar_rui_gtEst :208)."""
    import matplotlib.pyplot as plt

    if axes is None:
        _, axes = plt.subplots(1, 2, figsize=(14, 4))
    H2, W2 = img2.shape[:2]
    axes[0].imshow(img1, cmap="gray")
    axes[0].scatter(x1[:max_lines, 0], x1[:max_lines, 1], s=8, c="yellow")
    axes[0].set_title("image 1 points")
    axes[1].imshow(img2, cmap="gray")
    x1h = np.concatenate([x1[:max_lines], np.ones((min(max_lines, len(x1)), 1))], 1)
    for Fm, color in ((F, "cyan"), (F_gt, "orange")):
        if Fm is None:
            continue
        lines = x1h @ np.asarray(Fm).T  # l2 = F x1
        for l in lines:
            seg = _epiline_endpoints(l, W2, H2)
            if seg:
                (xa, ya), (xb, yb) = seg
                axes[1].plot([xa, xb], [ya, yb], color=color, linewidth=0.6)
    axes[1].scatter(x2[:max_lines, 0], x2[:max_lines, 1], s=8, c="yellow")
    axes[1].set_title("epipolar lines (cyan=est, orange=gt)")
    for ax in axes:
        ax.axis("off")
    return axes


def weight_heatmap(
    img: np.ndarray, xy: np.ndarray, weights: np.ndarray, ax=None, s_scale=2e4
):
    """Scatter of per-point solver weights over the image
    (ref: Train_model_pipeline weight-heatmap summaries :998-1035)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(10, 4))
    ax.imshow(img, cmap="gray")
    w = np.asarray(weights, np.float64)
    ax.scatter(xy[:, 0], xy[:, 1], s=np.clip(w * s_scale, 1, 80), c=w,
               cmap="viridis")
    ax.axis("off")
    return ax


def plot_image_grid(
    images: Sequence[np.ndarray],
    titles: Optional[Sequence[str]] = None,
    ncols: int = 2,
    figsize=(12, 8),
    save_path: Optional[str] = None,
):
    """Paper-figure grid assembly (ref: plot_tools.plot_results :17)."""
    import matplotlib.pyplot as plt

    n = len(images)
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=figsize, squeeze=False)
    for i, img in enumerate(images):
        ax = axes[i // ncols][i % ncols]
        ax.imshow(img, cmap="gray" if np.ndim(img) == 2 else None)
        if titles:
            ax.set_title(titles[i])
        ax.axis("off")
    for j in range(n, nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=150)
    return fig


def plot_trajectories_2d(
    trajectories: dict, gt: Optional[np.ndarray] = None, ax=None,
    save_path: Optional[str] = None,
):
    """Top-down (x, z) trajectory comparison (ref: kitti plot_path)."""
    import matplotlib.pyplot as plt

    if ax is None:
        fig, ax = plt.subplots(figsize=(7, 7))
    if gt is not None:
        ax.plot(gt[:, 0, 3], gt[:, 2, 3], "k--", label="gt")
    for name, poses in trajectories.items():
        ax.plot(poses[:, 0, 3], poses[:, 2, 3], label=name)
    ax.set_xlabel("x (m)")
    ax.set_ylabel("z (m)")
    ax.legend()
    ax.set_aspect("equal")
    if save_path:
        ax.figure.savefig(save_path, bbox_inches="tight", dpi=150)
    return ax
