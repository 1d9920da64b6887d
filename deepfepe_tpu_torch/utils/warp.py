"""Parametric image warps: fit, (de)parameterization, bilinear warping, and
the two OpenCV calls the homography evaluation makes, in numpy.

Counterpart of `deepfepe_tpu/utils/warp.py` (the reference's
`utils/warp.py`: `fit`, `vec2mtrx`/`mtrx2vec`, `transformImage`), batched
over leading dimensions where the JAX functions are vmapped:

- `transform_image(image [..., H, W, C], M [..., 3, 3])` computes
  output(x) = image(M x) on the pixel grid, the grid built in the image's
  dtype and divided by (w + 1e-8); `bilinear_sample` reads the four
  neighbours of each point, a neighbour outside the image contributing 0
  (no clamp to the edge).
- Warp types 'translation', 'similarity', 'affine', 'homography'.

`get_perspective_transform` and `warp_perspective` stand in for
`cv2.getPerspectiveTransform` and `cv2.warpPerspective` (INTER_LINEAR,
BORDER_CONSTANT 0), which the JAX package calls and which the card's
machine lacks (module docstrings say how each follows OpenCV).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

def fit_affine(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Least-squares affine warp mapping src -> dst, both [N, 2] -> [3, 3]."""
    X, Y = src[:, 0], src[:, 1]
    U, V = dst[:, 0], dst[:, 1]
    O, I = torch.zeros_like(X), torch.ones_like(X)
    A = torch.cat([torch.stack([X, Y, I, O, O, O], dim=1),
                   torch.stack([O, O, O, X, Y, I], dim=1)], dim=0)
    b = torch.cat([U, V], dim=0)
    p = torch.linalg.lstsq(A, b[:, None]).solution[:, 0]
    zero, one = torch.zeros_like(p[0]), torch.ones_like(p[0])
    return torch.stack([torch.stack([p[0], p[1], p[2]]), torch.stack([p[3], p[4], p[5]]),
                        torch.stack([zero, zero, one])]).to(src.dtype)


def vec2mtrx(p: torch.Tensor, warp_type: str = "homography") -> torch.Tensor:
    """Warp parameters [..., k] -> matrices [..., 3, 3] (identity at p = 0)."""
    O = torch.zeros_like(p[..., 0])
    I = torch.ones_like(O)
    if warp_type == "translation":
        tx, ty = p[..., 0], p[..., 1]
        rows = [[I, O, tx], [O, I, ty], [O, O, I]]
    elif warp_type == "similarity":
        pc, ps, tx, ty = (p[..., i] for i in range(4))
        rows = [[I + pc, -ps, tx], [ps, I + pc, ty], [O, O, I]]
    elif warp_type == "affine":
        p1, p2, p3, p4, p5, p6 = (p[..., i] for i in range(6))
        rows = [[I + p1, p2, p3], [p4, I + p5, p6], [O, O, I]]
    elif warp_type == "homography":
        p1, p2, p3, p4, p5, p6, p7, p8 = (p[..., i] for i in range(8))
        rows = [[I + p1, p2, p3], [p4, I + p5, p6], [p7, p8, I]]
    else:
        raise ValueError(warp_type)
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def mtrx2vec(M: torch.Tensor, warp_type: str = "homography") -> torch.Tensor:
    e = lambda i, j: M[..., i, j]  # noqa: E731
    if warp_type == "translation":
        return torch.stack([e(0, 2), e(1, 2)], dim=-1)
    if warp_type == "similarity":
        return torch.stack([e(0, 0) - 1, e(1, 0), e(0, 2), e(1, 2)], dim=-1)
    if warp_type == "affine":
        return torch.stack([e(0, 0) - 1, e(0, 1), e(0, 2), e(1, 0), e(1, 1) - 1, e(1, 2)],
                           dim=-1)
    if warp_type == "homography":
        return torch.stack([e(0, 0) - 1, e(0, 1), e(0, 2), e(1, 0), e(1, 1) - 1, e(1, 2),
                            e(2, 0), e(2, 1)], dim=-1)
    raise ValueError(warp_type)


def compose(p: torch.Tensor, dp: torch.Tensor, warp_type: str = "homography") -> torch.Tensor:
    """Compose warp parameters: the result applies dp after p."""
    M = vec2mtrx(dp, warp_type) @ vec2mtrx(p, warp_type)
    M = M / M[..., 2:3, 2:3]
    return mtrx2vec(M, warp_type)


def inverse(p: torch.Tensor, warp_type: str = "homography") -> torch.Tensor:
    return mtrx2vec(torch.linalg.inv(vec2mtrx(p, warp_type)), warp_type)


def bilinear_sample(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample image [..., H, W, C] at grid [..., h, w, 2] (x, y) pixel
    coordinates, the same leading dims: [..., h, w, C]. A neighbour outside
    the image contributes 0 (grid_sample's zero padding)."""
    *lead, H, W, C = image.shape
    x, y = grid[..., 0], grid[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    flat = image.reshape(-1, H * W, C)
    n = flat.shape[0]

    def at(yy, xx):
        inb = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        xs = torch.clamp(xx, 0, W - 1).long()
        ys = torch.clamp(yy, 0, H - 1).long()
        idx = (ys * W + xs).reshape(n, -1, 1).expand(-1, -1, C)
        v = torch.gather(flat, 1, idx).reshape(*xx.shape, C)
        return torch.where(inb[..., None], v, torch.zeros((), dtype=v.dtype, device=v.device))

    return (at(y0, x0) * ((1 - fx) * (1 - fy))[..., None]
            + at(y0, x0 + 1) * (fx * (1 - fy))[..., None]
            + at(y0 + 1, x0) * ((1 - fx) * fy)[..., None]
            + at(y0 + 1, x0 + 1) * (fx * fy)[..., None])


def transform_image(image: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Warp image [..., H, W, C] by the 3x3 warps M [..., 3, 3] in pixel
    coordinates: output(x) = image(M x). Ref: warp.transformImage :75."""
    *lead, H, W, _ = image.shape
    ys, xs = torch.meshgrid(torch.arange(H, dtype=image.dtype, device=image.device),
                            torch.arange(W, dtype=image.dtype, device=image.device),
                            indexing="ij")
    pts = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)  # [H, W, 3]
    M = M.to(image.dtype).expand(*lead, 3, 3)
    warped = torch.einsum("hwj,...ij->...hwi", pts, M)
    grid = warped[..., :2] / (warped[..., 2:3] + 1e-8)
    return bilinear_sample(image, grid)


def get_perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """`cv2.getPerspectiveTransform(src, dst)`: the [3, 3] float64 H with
    dst ~ H src from four point pairs, H[2, 2] = 1. OpenCV takes the points
    as float32 (Point2f) and forms the products -x_src x_dst of its 8x8
    system in float32 before solving in float64 by LU; so does this."""
    s = np.asarray(src, np.float32).reshape(4, 2)
    d = np.asarray(dst, np.float32).reshape(4, 2)
    A = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        A[i, 0] = A[i + 4, 3] = s[i, 0]
        A[i, 1] = A[i + 4, 4] = s[i, 1]
        A[i, 2] = A[i + 4, 5] = 1.0
        A[i, 6] = -s[i, 0] * d[i, 0]
        A[i, 7] = -s[i, 1] * d[i, 0]
        A[i + 4, 6] = -s[i, 0] * d[i, 1]
        A[i + 4, 7] = -s[i, 1] * d[i, 1]
        b[i], b[i + 4] = d[i, 0], d[i, 1]
    return np.append(np.linalg.solve(A, b), 1.0).reshape(3, 3)


def _fma32(a, b, c) -> np.ndarray:
    """float32 fused multiply-add a * b + c, rounded once (the float32
    product is exact in float64; the float64 sum's own rounding is below
    float32's)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def warp_perspective(img: np.ndarray, M: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """`cv2.warpPerspective(img, M, dsize)` of a float32 image with
    INTER_LINEAR and BORDER_CONSTANT 0: out(x, y) = img(M^-1 (x, y)) on a
    [dsize[1], dsize[0]] grid (a trailing channel axis is kept).

    OpenCV 5's rule, copied step by step: M^-1 is taken in float64 and
    rounded to float32; cv2 walks each output row in a 16-wide vector loop
    and a scalar tail (the last width mod 16 columns), which round the
    source coordinate differently. In the loop each row's m = y m1 + m2 is
    a float32 product and sum, then X = fma(x, m0, m); in the tail X =
    fma(x, m0, y m1) + m2; likewise Y and the denominator w. The source
    point is (X / w, Y / w) in float32; with (ix, iy) its floor and (ax, ay)
    the rest, the value is lerp(lerp(p00, p01, ax), lerp(p10, p11, ax), ay),
    each lerp fma(a, q - p, p) in float32, where a neighbour outside the
    image reads 0. So the whole frame is cv2 5.0's bit for bit at any
    width. (OpenCV 4 rounded the source point to 1/32 px and took table
    weights instead; a float64 bilinear warp misses 5.0's result by up to
    2e-5 on noise images.)"""
    src = np.asarray(img, np.float32)
    Wd, Hd = int(dsize[0]), int(dsize[1])
    Hs, Ws = src.shape[:2]
    m = np.linalg.inv(np.asarray(M, np.float64)).astype(np.float32)
    ys, xs = np.mgrid[0:Hd, 0:Wd].astype(np.float32)

    tail = xs >= Wd - Wd % 16  # cv2's scalar tail of each row

    def row(r):
        return np.where(tail, _fma32(xs, m[r, 0], ys * m[r, 1]) + m[r, 2],
                        _fma32(xs, m[r, 0], ys * m[r, 1] + m[r, 2]))

    w = row(2)
    sx, sy = row(0) / w, row(1) / w
    fx, fy = np.floor(sx), np.floor(sy)
    ax, ay = (sx - fx)[..., None], (sy - fy)[..., None]
    ix = np.clip(fx, -2.0, Ws + 1.0).astype(np.int64)
    iy = np.clip(fy, -2.0, Hs + 1.0).astype(np.int64)
    chan = src.reshape(Hs, Ws, -1)

    def at(dy, dx):
        yy, xx = iy + dy, ix + dx
        ok = (xx >= 0) & (xx < Ws) & (yy >= 0) & (yy < Hs)
        v = chan[np.clip(yy, 0, Hs - 1), np.clip(xx, 0, Ws - 1)]
        return np.where(ok[..., None], v, np.float32(0.0))

    p00, p01, p10, p11 = at(0, 0), at(0, 1), at(1, 0), at(1, 1)
    top = _fma32(ax, p01 - p00, p00)
    bottom = _fma32(ax, p11 - p10, p10)
    out = _fma32(ay, bottom - top, top)
    return out.reshape((Hd, Wd) + src.shape[2:])
