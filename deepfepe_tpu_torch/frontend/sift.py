"""SIFT keypoints and descriptors in float32 torch, as OpenCV computes them.

The JAX package's SIFT frontend (`deepfepe_tpu/data/dump_kitti.py`
`sift_detect`) calls `cv2.SIFT_create(nfeatures, contrastThreshold=1e-5)`
with OpenCV's other defaults: 3 layers an octave, edge threshold 10,
sigma 1.6, the first octave at twice the image size by bilinear
interpolation (no precise upscale). This module computes the same
function without OpenCV, on an explicit device:

- `build_pyramid`: the initial image (the uint8 frame as float, doubled,
  blurred by the sigma difference), the Gaussian octaves (separable taps
  equal to `cv2.getGaussianKernel`, BORDER_REFLECT_101; each next
  octave's base every other pixel of layer 3) and the DoG, every octave
  packed into one flat buffer (`Pyramid`);
- `extrema_plain`: the 26-neighbour extrema of DoG layers 1-3 (5 px
  border, every nonzero value a candidate at threshold 1e-5), up to 5
  Newton steps on 3x3x3 differences (solved as `Matx33f::solve` does:
  Cramer's rule in float32), the contrast and the edge tests;
- `orientation_plain`: the 36-bin gradient histogram, smoothed, one
  keypoint for each peak at or above 0.8 of the maximum, by parabolic
  interpolation;
- the order step (`native/keypoint_filter.cpp`): OpenCV's
  `removeDuplicatedSorted` and `retainBest`, then the half scale of the
  first octave;
- `descriptor_plain`: 4x4x8 bins with trilinear weights, clipped at 0.2,
  renormalised, x512 and saturated to uint8 values.

These stage functions are the plain twins of the kernels in
`csrc/sift.cu` (S1 `sift_extrema`, S2a `sift_orientation`, S2b
`sift_descriptor`): `ops/sift.py` runs them for tensors on the CPU and
launches the kernels for CUDA tensors. The pyramid and the DoG are torch
elementwise operations on either device, rounded alike, so both routes
read the same pyramid bit for bit. OpenCV's own blur sums in another order
(IPP), so the match with cv2 is statistical: keypoints pair within 0.01 px
and 0.1 deg, descriptor entries within 2.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

N_OCTAVE_LAYERS = 3
SIGMA = 1.6
CONTRAST_THRESHOLD = 1e-5
EDGE_THRESHOLD = 10.0
INIT_SIGMA = 0.5
IMG_BORDER = 5
MAX_INTERP_STEPS = 5
ORI_HIST_BINS = 36
ORI_SIG_FCTR = 1.5
ORI_RADIUS = 3 * ORI_SIG_FCTR
ORI_PEAK_RATIO = 0.8
DESCR_WIDTH = 4
DESCR_HIST_BINS = 8
DESCR_SCL_FCTR = 3.0
DESCR_MAG_THR = 0.2
INT_DESCR_FCTR = 512.0
FIRST_OCTAVE = -1
FLT_EPSILON = float(np.finfo(np.float32).eps)
# The bins of the descriptor's histogram with its border: (d + 2)^2 (n + 2).
DESCR_HIST_LEN = (DESCR_WIDTH + 2) ** 2 * (DESCR_HIST_BINS + 2)
DESCR_LEN = DESCR_WIDTH * DESCR_WIDTH * DESCR_HIST_BINS
# The largest keypoint count the orientation step emits for one candidate:
# a peak is above both neighbours, so at most every other bin.
MAX_PEAKS = ORI_HIST_BINS // 2


def f32(x) -> float:
    """x rounded to float32, as a Python float (exact in float64)."""
    return float(np.float32(x))


def _f32_mul(*xs) -> float:
    """Left-to-right float32 product."""
    acc = np.float32(xs[0])
    for x in xs[1:]:
        acc = np.float32(acc * np.float32(x))
    return float(acc)


# fastAtan2's polynomial (OpenCV core, degrees).
_DEG = np.float32(180 / math.pi)
ATAN_P1 = _f32_mul(0.9997878412794807, _DEG)
ATAN_P3 = _f32_mul(-0.3258083974640975, _DEG)
ATAN_P5 = _f32_mul(0.1555786518463281, _DEG)
ATAN_P7 = _f32_mul(-0.04432655554792128, _DEG)
ATAN_EPS = f32(np.finfo(np.float64).eps)
IMG_SCALE = f32(np.float32(1.0) / np.float32(255.0))
DERIV_SCALE = _f32_mul(IMG_SCALE, 0.5)
CROSS_DERIV_SCALE = _f32_mul(IMG_SCALE, 0.25)
DEG2RAD = f32(math.pi / 180)
INT_MAX_3 = f32((2 ** 31 - 1) // 3)
# OpenCV's cvRound rounds to nearest, ties to even: torch.round's rule.


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 fused multiply-add a b + c (one rounding), through float64."""
    a64 = a.double()
    b64 = b.double() if torch.is_tensor(b) else b
    c64 = c.double() if torch.is_tensor(c) else c
    return (a64 * b64 + c64).float()


# ---------------------------------------------------------------------------
# The pyramid.
# ---------------------------------------------------------------------------


def gaussian_taps(ksize: int, sigma: float) -> np.ndarray:
    """The taps of `cv2.getGaussianKernel(ksize, sigma, CV_32F)` for sigma > 0:
    exp(-x^2 / (2 sigma^2)) normalised to sum 1, in float64, then float32."""
    scale2 = -0.125 / (sigma * sigma)
    n2 = (ksize - 1) // 2
    vals = [math.exp(float(x * x) * scale2) for x in range(1 - ksize, 1 - ksize + 2 * n2, 2)]
    total = 0.0
    for v in vals:
        total += v
    total = total * 2.0 + 1.0
    if ksize % 2 == 0:
        total += 1.0
    mul = 1.0 / total
    out = np.empty(ksize, np.float64)
    for i, v in enumerate(vals):
        out[i] = out[ksize - 1 - i] = v * mul
    out[n2] = mul
    if ksize % 2 == 0:
        out[n2 + 1] = mul
    return out.astype(np.float32)


def blur_ksize(sigma: float) -> int:
    """GaussianBlur's kernel size for a float image: round(8 sigma + 1) | 1."""
    return int(np.rint(sigma * 4 * 2 + 1)) | 1


def layer_sigmas() -> List[float]:
    """The blur that takes each layer of an octave to the next (layer 0: sigma)."""
    sig = [SIGMA]
    k = 2.0 ** (1.0 / N_OCTAVE_LAYERS)
    for i in range(1, N_OCTAVE_LAYERS + 3):
        prev = k ** (i - 1) * SIGMA
        total = prev * k
        sig.append(math.sqrt(total * total - prev * prev))
    return sig


def reflect101(n: int, pad: int) -> np.ndarray:
    """Source indices of positions -pad .. n - 1 + pad under BORDER_REFLECT_101
    (OpenCV's borderInterpolate, also for pad >= n)."""
    idx = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(idx)
    while ((idx < 0) | (idx >= n)).any():
        idx = np.where(idx < 0, -idx, idx)
        idx = np.where(idx >= n, 2 * (n - 1) - idx, idx)
    return idx


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """cv2.GaussianBlur(img, (0, 0), sigma) of a float32 [H, W] image, as
    OpenCV's AVX2 separable filter sums it: the row pass from the leftmost
    tap, the column pass from the centre tap out with each pair of mirrored
    rows added first; in fused multiply-adds on the columns its fused loops
    take (the row pass's all but the last W % 4, the column pass's all but
    the last W % 8), in separate products and sums on the rest. The same on
    the CPU and the card, bit for bit, and equal to OpenCV's own result at
    every size tried (tests/test_torch_sift.py). A plain float32 blur would
    meet PARITY_BARS but move OpenCV's rows (`tools/sift_blur_study.py`),
    and the loaders pick rows by number."""
    ksize = blur_ksize(sigma)
    taps = [float(t) for t in gaussian_taps(ksize, sigma)]
    r = ksize // 2
    H, W = img.shape
    cols = torch.as_tensor(reflect101(W, r), device=img.device)
    xp = img.index_select(1, cols)
    vec = W - W % 4  # the row pass's fused columns

    def row_pass(a, b, fused):
        s = xp[:, a:b] * taps[0]
        for k in range(1, ksize):
            x = xp[:, a + k:b + k]
            s = fma32(x, taps[k], s) if fused else s + x * taps[k]
        return s

    # A single row or column is not blurred across it (GaussianBlur's kernel
    # size 1 there).
    s = img if W == 1 else torch.cat([row_pass(0, vec, True), row_pass(vec, W, False)], 1)
    if H == 1:
        return s
    rows = torch.as_tensor(reflect101(H, r), device=img.device)
    yp = s.index_select(0, rows)
    vec = W - W % 8  # the column pass's fused columns

    def col_pass(a, b, fused):
        out = yp[r:r + H, a:b] * taps[r]
        for k in range(1, r + 1):
            x = yp[r + k:r + k + H, a:b] + yp[r - k:r - k + H, a:b]
            out = fma32(x, taps[r + k], out) if fused else out + x * taps[r + k]
        return out

    return torch.cat([col_pass(0, vec, True), col_pass(vec, W, False)], 1)


def initial_image(img_u8: torch.Tensor, blur=gaussian_blur) -> torch.Tensor:
    """The first octave's base: the frame as float32, doubled by bilinear
    interpolation (weights 3/4 and 1/4, edges replicated: exact in float32
    for uint8 values), blurred by sqrt(sigma^2 - 4 x 0.5^2)."""
    x = img_u8.to(torch.float32)
    H, W = x.shape

    def double(a, n, dim):
        # out[2k] = 3/4 a[k] + 1/4 a[k - 1], out[2k + 1] = 3/4 a[k] + 1/4 a[k + 1]
        lo = torch.as_tensor(np.maximum(np.arange(n) - 1, 0), device=a.device)
        hi = torch.as_tensor(np.minimum(np.arange(n) + 1, n - 1), device=a.device)
        even = a * 0.75 + a.index_select(dim, lo) * 0.25
        odd = a * 0.75 + a.index_select(dim, hi) * 0.25
        return torch.stack([even, odd], dim + 1).flatten(dim, dim + 1)

    dbl = double(double(x, W, 1), H, 0)
    s = np.float32(SIGMA)
    sig_diff = np.sqrt(max(s * s - np.float32(INIT_SIGMA * INIT_SIGMA * 4), np.float32(0.01)))
    return blur(dbl, float(sig_diff))


@dataclasses.dataclass
class Pyramid:
    """The Gaussian octaves (N_OCTAVE_LAYERS + 3 layers each) and their DoG
    (N_OCTAVE_LAYERS + 2 layers), every octave packed into one flat float32
    buffer: octave o's layers [L, rows[o], cols[o]] start at g_off[o] (d_off[o]
    in the DoG)."""

    gauss: torch.Tensor
    dog: torch.Tensor
    rows: List[int]
    cols: List[int]
    g_off: List[int]
    d_off: List[int]

    @property
    def n_octaves(self) -> int:
        return len(self.rows)

    def gauss_octave(self, o: int) -> torch.Tensor:
        n = (N_OCTAVE_LAYERS + 3) * self.rows[o] * self.cols[o]
        return self.gauss[self.g_off[o]:self.g_off[o] + n].view(-1, self.rows[o], self.cols[o])

    def dog_octave(self, o: int) -> torch.Tensor:
        n = (N_OCTAVE_LAYERS + 2) * self.rows[o] * self.cols[o]
        return self.dog[self.d_off[o]:self.d_off[o] + n].view(-1, self.rows[o], self.cols[o])

    def table(self) -> np.ndarray:
        """[n_octaves, 4] int64: rows, cols, g_off, d_off (the kernels' view)."""
        return np.array([self.rows, self.cols, self.g_off, self.d_off], np.int64).T.copy()

    def to(self, device) -> "Pyramid":
        return dataclasses.replace(self, gauss=self.gauss.to(device), dog=self.dog.to(device))


def n_octaves_for(rows: int, cols: int) -> int:
    """OpenCV's octave count for a base image of rows x cols (first octave -1)."""
    return int(np.rint(math.log(min(rows, cols)) / math.log(2.0) - 2)) - FIRST_OCTAVE


def build_pyramid(img_u8: torch.Tensor, blur=gaussian_blur) -> Pyramid:
    """The Gaussian and DoG pyramids of a [H, W] uint8 frame on its device.
    `blur(img, sigma)` is OpenCV's (`gaussian_blur`) but in a study of
    another (`tools/sift_blur_study.py`)."""
    base = initial_image(img_u8, blur)
    sig = layer_sigmas()
    n_oct = n_octaves_for(*base.shape)
    octaves = []
    for o in range(n_oct):
        if o == 0:
            layers = [base]
        else:
            src = octaves[-1][N_OCTAVE_LAYERS]
            h, w = src.shape[0] // 2, src.shape[1] // 2
            layers = [src[0:2 * h:2, 0:2 * w:2].contiguous()]
        for i in range(1, N_OCTAVE_LAYERS + 3):
            layers.append(blur(layers[-1], sig[i]))
        octaves.append(layers)
    rows = [layers[0].shape[0] for layers in octaves]
    cols = [layers[0].shape[1] for layers in octaves]
    gauss = torch.cat([torch.stack(layers).reshape(-1) for layers in octaves])
    dog = torch.cat([(torch.stack(layers[1:]) - torch.stack(layers[:-1])).reshape(-1)
                     for layers in octaves])
    g_off = np.cumsum([0] + [(N_OCTAVE_LAYERS + 3) * h * w for h, w in zip(rows, cols)])
    d_off = np.cumsum([0] + [(N_OCTAVE_LAYERS + 2) * h * w for h, w in zip(rows, cols)])
    return Pyramid(gauss, dog, rows, cols, [int(v) for v in g_off[:-1]],
                   [int(v) for v in d_off[:-1]])


# ---------------------------------------------------------------------------
# Float32 helpers shared by the stages.
# ---------------------------------------------------------------------------


def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """OpenCV's fastAtan2 in degrees, [0, 360): its odd polynomial on
    min/max, in fused multiply-adds as its SIMD route takes them."""
    ax, ay = x.abs(), y.abs()
    c = torch.minimum(ax, ay) / (torch.maximum(ax, ay) + ATAN_EPS)
    cc = c * c
    a = fma32(fma32(fma32(cc, ATAN_P7, ATAN_P5), cc, ATAN_P3), cc, ATAN_P1) * c
    a = torch.where(ax >= ay, a, 90.0 - a)
    a = torch.where(x < 0, 180.0 - a, a)
    return torch.where(y < 0, 360.0 - a, a)


def exp32(x: torch.Tensor) -> torch.Tensor:
    """exp of float32 values, correctly rounded (float64, then float32)."""
    return torch.exp(x.double()).float()


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """IEEE float32 square roots (sqrtf): through float64, since torch's
    float32 sqrt on the CPU is not correctly rounded."""
    return torch.sqrt(x.double()).float()


def magnitude32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sqrt(x^2 + y^2) as OpenCV's SIMD magnitude: sqrt(fma(x, x, y y))."""
    return sqrt32(fma32(x, x, y * y))


# ---------------------------------------------------------------------------
# S1's plain twin: extrema, refinement, contrast and edge tests.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Candidates:
    """The extrema that pass the refinement, contrast and edge tests, one row
    each: `kp` float32 [N, 4] (x, y, size, response in the doubled image's
    coordinates) and `idx` int32 [N, 5] (packed octave, layer, row, column
    after refinement, and the DoG pixel it started from as an index into
    `Pyramid.dog`)."""

    kp: torch.Tensor
    idx: torch.Tensor

    def __len__(self) -> int:
        return self.kp.shape[0]

    def to(self, device) -> "Candidates":
        return Candidates(self.kp.to(device), self.idx.to(device))

    def sorted(self) -> "Candidates":
        """Rows in the order of the DoG pixel they started from."""
        order = torch.argsort(self.idx[:, 4].long())
        return Candidates(self.kp[order], self.idx[order])


def solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A batch [N, 3, 3] x = b as OpenCV's `Matx33f::solve(b, DECOMP_LU)`
    solves it: its 3x3 specialisation, Cramer's rule over the float32
    determinant, x = 0 where the determinant is exactly 0. (A pivoting LU,
    whose singular test is |pivot| < 10 FLT_EPSILON, keeps flat-region
    extrema at offset 0 that OpenCV moves or drops: 529 keypoints against
    OpenCV's 524 on tests/fixtures/image_io/kitti_grey_q95.jpg, where this
    gives 524, all paired.)"""
    a = [[A[:, i, j] for j in range(3)] for i in range(3)]
    b0, b1, b2 = b[:, 0], b[:, 1], b[:, 2]
    det = (a[0][0] * (a[1][1] * a[2][2] - a[2][1] * a[1][2])
           - a[0][1] * (a[1][0] * a[2][2] - a[2][0] * a[1][2])
           + a[0][2] * (a[1][0] * a[2][1] - a[2][0] * a[1][1]))
    ok = det != 0
    d = 1.0 / torch.where(ok, det, torch.ones_like(det))
    x0 = d * ((b0 * (a[1][1] * a[2][2] - a[1][2] * a[2][1])
               - a[0][1] * (b1 * a[2][2] - a[1][2] * b2))
              + a[0][2] * (b1 * a[2][1] - a[1][1] * b2))
    x1 = d * ((a[0][0] * (b1 * a[2][2] - a[1][2] * b2)
               - b0 * (a[1][0] * a[2][2] - a[1][2] * a[2][0]))
              + a[0][2] * (a[1][0] * b2 - b1 * a[2][0]))
    x2 = d * ((a[0][0] * (a[1][1] * b2 - b1 * a[2][1])
               - a[0][1] * (a[1][0] * b2 - b1 * a[2][0]))
              + b0 * (a[1][0] * a[2][1] - a[1][1] * a[2][0]))
    x = torch.stack([x0, x1, x2], -1)
    return torch.where(ok[:, None], x, torch.zeros_like(x))


def _derivatives(Df: torch.Tensor, H: int, W: int, l, r, c):
    """dD (x, y, s), the Hessian's six entries and D at (l, r, c), OpenCV's
    scales and operation order."""
    def at(dl, dr, dc):
        return Df[((l + dl) * H + r + dr) * W + c + dc]

    v = at(0, 0, 0)
    dx = (at(0, 0, 1) - at(0, 0, -1)) * DERIV_SCALE
    dy = (at(0, 1, 0) - at(0, -1, 0)) * DERIV_SCALE
    ds = (at(1, 0, 0) - at(-1, 0, 0)) * DERIV_SCALE
    v2 = v * 2.0
    dxx = ((at(0, 0, 1) + at(0, 0, -1)) - v2) * IMG_SCALE
    dyy = ((at(0, 1, 0) + at(0, -1, 0)) - v2) * IMG_SCALE
    dss = ((at(1, 0, 0) + at(-1, 0, 0)) - v2) * IMG_SCALE
    dxy = (((at(0, 1, 1) - at(0, 1, -1)) - at(0, -1, 1)) + at(0, -1, -1)) * CROSS_DERIV_SCALE
    dxs = (((at(1, 0, 1) - at(1, 0, -1)) - at(-1, 0, 1)) + at(-1, 0, -1)) * CROSS_DERIV_SCALE
    dys = (((at(1, 1, 0) - at(1, -1, 0)) - at(-1, 1, 0)) + at(-1, -1, 0)) * CROSS_DERIV_SCALE
    return v, (dx, dy, ds), (dxx, dyy, dss, dxy, dxs, dys)


def extrema_plain(pyr: Pyramid) -> Candidates:
    """S1's plain twin: every octave's candidates in DoG pixel order."""
    kps, idxs = [], []
    B = IMG_BORDER
    for o in range(pyr.n_octaves):
        H, W = pyr.rows[o], pyr.cols[o]
        if H <= 2 * B or W <= 2 * B:
            continue
        D = pyr.dog_octave(o)
        mx = torch.nn.functional.max_pool2d(D[:, None], 3, 1, 1)[:, 0]
        mn = -torch.nn.functional.max_pool2d(-D[:, None], 3, 1, 1)[:, 0]
        nmax = torch.maximum(torch.maximum(mx[0:3], mx[1:4]), mx[2:5])
        nmin = torch.minimum(torch.minimum(mn[0:3], mn[1:4]), mn[2:5])
        val = D[1:4]
        cand = ((val > 0) & (val >= nmax)) | ((val < 0) & (val <= nmin))
        inner = torch.zeros_like(cand)
        inner[:, B:H - B, B:W - B] = True
        li, r, c = torch.nonzero(cand & inner, as_tuple=True)
        layer = li + 1
        pixel = pyr.d_off[o] + (layer * H + r) * W + c
        kp, idx, keep = refine(D.reshape(-1), H, W, o, layer, r, c)
        kps.append(kp)
        idxs.append(torch.cat([idx, pixel[keep][:, None]], 1).int())
    dev = pyr.dog.device
    if not kps:
        return Candidates(torch.zeros((0, 4), device=dev),
                          torch.zeros((0, 5), dtype=torch.int32, device=dev))
    return Candidates(torch.cat(kps), torch.cat(idxs))


def refine(Df: torch.Tensor, H: int, W: int, o: int, layer, r, c):
    """adjustLocalExtrema for a batch of one octave's extrema: Newton steps
    on the quadratic fit, then the contrast and edge tests. Returns the
    survivors' kp [M, 4], idx [M, 4] (packed octave, layer, r, c) and
    their rows in the input."""
    B = IMG_BORDER
    N = layer.shape[0]
    dev = Df.device
    layer, r, c = layer.clone(), r.clone(), c.clone()
    xs = torch.zeros((N, 3), device=dev)
    active = torch.ones(N, dtype=torch.bool, device=dev)
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    for _ in range(MAX_INTERP_STEPS):
        a = torch.nonzero(active & ~done, as_tuple=True)[0]
        if a.numel() == 0:
            break
        _, dD, (dxx, dyy, dss, dxy, dxs, dys) = _derivatives(Df, H, W, layer[a], r[a], c[a])
        Hm = torch.stack([torch.stack([dxx, dxy, dxs], -1), torch.stack([dxy, dyy, dys], -1),
                          torch.stack([dxs, dys, dss], -1)], 1)
        X = solve3(Hm, torch.stack(dD, -1))
        x = -X  # (xc, xr, xi)
        conv = (x.abs() < 0.5).all(-1)
        xs[a[conv]] = x[conv]
        done[a[conv]] = True
        rest = a[~conv]
        xr_ = x[~conv]
        huge = (xr_.abs() > INT_MAX_3).any(-1)
        active[rest[huge]] = False
        rest, xr_ = rest[~huge], xr_[~huge]
        c[rest] += torch.round(xr_[:, 0]).long()
        r[rest] += torch.round(xr_[:, 1]).long()
        layer[rest] += torch.round(xr_[:, 2]).long()
        out = ((layer[rest] < 1) | (layer[rest] > N_OCTAVE_LAYERS) | (c[rest] < B)
               | (c[rest] >= W - B) | (r[rest] < B) | (r[rest] >= H - B))
        active[rest[out]] = False
    keep = torch.nonzero(active & done, as_tuple=True)[0]
    layer, r, c, x = layer[keep], r[keep], c[keep], xs[keep]
    v, dD, (dxx, dyy, _, dxy, _, _) = _derivatives(Df, H, W, layer, r, c)
    t = ((dD[0] * x[:, 0]) + (dD[1] * x[:, 1])) + (dD[2] * x[:, 2])
    contr = v * IMG_SCALE + t * 0.5
    ok = (contr.abs() * float(N_OCTAVE_LAYERS)) >= f32(CONTRAST_THRESHOLD)
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    e = f32(EDGE_THRESHOLD)
    ok &= (det > 0) & ((tr * tr) * e < f32((e + 1) * (e + 1)) * det)
    keep, layer, r, c, x, contr = (keep[ok], layer[ok], r[ok], c[ok], x[ok], contr[ok])
    scale = float(1 << o)
    px = (c.float() + x[:, 0]) * scale
    py = (r.float() + x[:, 1]) * scale
    xi = x[:, 2]
    octave = o + (layer << 8) + (torch.round((xi.double() + 0.5) * 255).long() << 16)
    size = pow2_32((layer.float() + xi) / float(N_OCTAVE_LAYERS))
    size = ((size * f32(SIGMA)) * scale) * 2.0
    kp = torch.stack([px, py, size, contr.abs()], 1)
    return kp, torch.stack([octave, layer, r, c], 1), keep


def pow2_32(e: torch.Tensor) -> torch.Tensor:
    """powf(2, e) for float32 e, correctly rounded (float64, then float32)."""
    return torch.exp2(e.double()).float()


# ---------------------------------------------------------------------------
# S2a's plain twin: orientation.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Oriented:
    """Keypoints with their orientation: `kp` float32 [M, 6] (x, y, size,
    angle, response, packed octave; the doubled image's coordinates) and
    `src` int32 [M], each keypoint's row in the Candidates."""

    kp: torch.Tensor
    src: torch.Tensor

    def __len__(self) -> int:
        return self.kp.shape[0]

    def to(self, device) -> "Oriented":
        return Oriented(self.kp.to(device), self.src.to(device))


def smooth_hist(t: torch.Tensor) -> torch.Tensor:
    """OpenCV's [1 4 6 4 1] / 16 circular smoothing of [N, 36] histograms:
    bins 0-31 as its 8-lane SIMD loop sums them, 32-35 as its scalar tail."""
    n = t.shape[1]
    ext = torch.cat([t[:, n - 2:], t, t[:, :2]], 1)
    tn2, tn1, t0, tp1, tp2 = (ext[:, k:k + n] for k in range(5))
    simd = (tn2 + tp2) * (1 / 16) + ((tn1 + tp1) * 0.25 + t0 * 0.375)
    scalar = ((tn2 + tp2) * (1 / 16) + (tn1 + tp1) * 0.25) + t0 * 0.375
    n_simd = (n // 8) * 8
    return torch.cat([simd[:, :n_simd], scalar[:, n_simd:]], 1)


def orientation_hist_plain(gauss_flat: torch.Tensor, H: int, W: int, layer, r, c, scl,
                           chunk: int = 2048) -> torch.Tensor:
    """calcOrientationHist for a batch of one octave's candidates: the
    smoothed [N, 36] histograms."""
    dev = gauss_flat.device
    n = ORI_HIST_BINS
    out = []
    for s in range(0, layer.shape[0], chunk):
        lk, rk, ck, sk = layer[s:s + chunk], r[s:s + chunk], c[s:s + chunk], scl[s:s + chunk]
        N = lk.shape[0]
        radius = torch.round(sk * f32(ORI_RADIUS)).long()
        sigma = sk * f32(ORI_SIG_FCTR)
        expf_scale = -1.0 / ((sigma * 2.0) * sigma)
        R = int(radius.max()) if N else 0
        off = torch.arange(-R, R + 1, device=dev)
        oi, oj = torch.meshgrid(off, off, indexing="ij")
        oi, oj = oi.reshape(-1), oj.reshape(-1)
        y = rk[:, None] + oi
        x = ck[:, None] + oj
        valid = ((oi.abs()[None] <= radius[:, None]) & (oj.abs()[None] <= radius[:, None])
                 & (y > 0) & (y < H - 1) & (x > 0) & (x < W - 1))
        yc, xc = y.clamp(1, H - 2), x.clamp(1, W - 2)
        base = lk[:, None] * (H * W)
        g = gauss_flat
        dx = g[base + yc * W + xc + 1] - g[base + yc * W + xc - 1]
        dy = g[base + (yc - 1) * W + xc] - g[base + (yc + 1) * W + xc]
        w = exp32((oi * oi + oj * oj).float()[None] * expf_scale[:, None])
        ori = fast_atan2(dy, dx)
        mag = magnitude32(dx, dy)
        b = torch.round(ori * f32(n / 360.0)).long()
        b = torch.where(b >= n, b - n, b)
        b = torch.where(b < 0, b + n, b)
        contrib = torch.where(valid, w * mag, torch.zeros_like(mag))
        hist = torch.zeros((N, n), device=dev)
        hist.scatter_add_(1, b, contrib)
        out.append(hist)
    hist = torch.cat(out) if out else torch.zeros((0, n), device=dev)
    return smooth_hist(hist)


def peaks(hist: torch.Tensor):
    """The histogram peaks: (candidate row, bin) pairs with their angle."""
    n = hist.shape[1]
    omax = hist.max(1).values
    mag_thr = omax * f32(ORI_PEAK_RATIO)
    hl = torch.roll(hist, 1, 1)
    hr = torch.roll(hist, -1, 1)
    is_peak = (hist > hl) & (hist > hr) & (hist >= mag_thr[:, None])
    k, j = torch.nonzero(is_peak, as_tuple=True)
    l_, j_, r_ = hl[k, j], hist[k, j], hr[k, j]
    bin_ = j.float() + ((l_ - r_) * 0.5) / ((l_ - j_ * 2.0) + r_)
    bin_ = torch.where(bin_ < 0, bin_ + float(n), torch.where(bin_ >= n, bin_ - float(n), bin_))
    angle = 360.0 - bin_ * f32(360.0 / n)
    angle = torch.where((angle - 360.0).abs() < FLT_EPSILON, torch.zeros_like(angle), angle)
    return k, angle


def orientation_plain(pyr: Pyramid, cands: Candidates) -> Oriented:
    """S2a's plain twin: every candidate's peaks, in candidate order and,
    within a candidate, by bin."""
    kps, srcs = [], []
    dev = pyr.gauss.device
    octv = (cands.idx[:, 0] & 255).long()
    for o in range(pyr.n_octaves):
        rows = torch.nonzero(octv == o, as_tuple=True)[0]
        if rows.numel() == 0:
            continue
        H, W = pyr.rows[o], pyr.cols[o]
        idx = cands.idx[rows].long()
        kp = cands.kp[rows]
        scl = (kp[:, 2] * 0.5) / float(1 << o)
        hist = orientation_hist_plain(pyr.gauss_octave(o).reshape(-1), H, W, idx[:, 1],
                                      idx[:, 2], idx[:, 3], scl)
        k, angle = peaks(hist)
        kps.append(torch.stack([kp[k, 0], kp[k, 1], kp[k, 2], angle, kp[k, 3],
                                cands.idx[rows[k], 0].float()], 1))
        srcs.append(rows[k].int())
    if not kps:
        return Oriented(torch.zeros((0, 6), device=dev),
                        torch.zeros((0,), dtype=torch.int32, device=dev))
    kp, src = torch.cat(kps), torch.cat(srcs)
    order = torch.argsort(src.long(), stable=True)
    return Oriented(kp[order], src[order])


# ---------------------------------------------------------------------------
# The order step and the half scale.
# ---------------------------------------------------------------------------


def half_scale(kp: torch.Tensor) -> torch.Tensor:
    """The first octave's keypoints back at the frame's scale: x, y and size
    halved, the packed octave's low byte o - 1."""
    out = kp.clone()
    out[:, 0:3] = kp[:, 0:3] * 0.5
    octave = kp[:, 5].long()
    out[:, 5] = ((octave & ~255) | ((octave + FIRST_OCTAVE) & 255)).float()
    return out


def unpack_octave(octave: torch.Tensor):
    """(octave, layer, scale) of packed octaves, as OpenCV's unpackOctave."""
    o = octave & 255
    layer = (octave >> 8) & 255
    o = torch.where(o < 128, o, o - 256)
    scale = torch.pow(2.0, -o.double()).float()
    return o, layer, scale


# ---------------------------------------------------------------------------
# S2b's plain twin: the descriptor.
# ---------------------------------------------------------------------------


def descriptor_geometry(pyr: Pyramid, kp: torch.Tensor):
    """What calcDescriptors reads of each final keypoint: octave index in the
    pyramid, layer, centre pixel, cos/sin over the bin width, the bin
    width's radius (clipped to the image diagonal) and the angle."""
    o, layer, scale = unpack_octave(kp[:, 5].long())
    size = kp[:, 2] * scale
    ptx, pty = kp[:, 0] * scale, kp[:, 1] * scale
    angle = 360.0 - kp[:, 3]
    angle = torch.where((angle - 360.0).abs() < FLT_EPSILON, torch.zeros_like(angle), angle)
    scl = size * 0.5
    oi = o - FIRST_OCTAVE
    rows = torch.as_tensor(pyr.rows, device=kp.device)[oi]
    cols = torch.as_tensor(pyr.cols, device=kp.device)[oi]
    cx, cy = torch.round(ptx).long(), torch.round(pty).long()
    theta = angle * DEG2RAD
    cos_t = torch.cos(theta.double()).float()
    sin_t = torch.sin(theta.double()).float()
    hist_width = scl * f32(DESCR_SCL_FCTR)
    radius = torch.round(((hist_width * f32(math.sqrt(2))) * float(DESCR_WIDTH + 1))
                             * 0.5).long()
    diag = torch.sqrt((cols.double() ** 2 + rows.double() ** 2)).long()
    radius = torch.minimum(radius, diag)
    return dict(oct=oi, layer=layer, cx=cx, cy=cy, cos_t=cos_t / hist_width,
                sin_t=sin_t / hist_width, radius=radius, angle=angle, rows=rows, cols=cols)


def normalize_descriptor(raw: torch.Tensor) -> torch.Tensor:
    """Clip at 0.2 of the norm, renormalise, x512, round and saturate: the
    norm's first sum in 8 lanes of fused multiply-adds then OpenCV's lane
    reduction, its second sum in order."""
    N = raw.shape[0]
    lanes = torch.zeros((N, 8), device=raw.device)
    r8 = raw.view(N, -1, 8)
    for k in range(r8.shape[1]):
        lanes = fma32(r8[:, k], r8[:, k], lanes)
    s4 = lanes[:, :4] + lanes[:, 4:]
    nrm2 = (s4[:, 0] + s4[:, 1]) + (s4[:, 2] + s4[:, 3])
    thr = sqrt32(nrm2) * f32(DESCR_MAG_THR)
    val = torch.minimum(raw, thr[:, None])
    nrm2 = torch.zeros(N, device=raw.device)
    for k in range(val.shape[1]):
        nrm2 = nrm2 + val[:, k] * val[:, k]
    scale = INT_DESCR_FCTR / torch.clamp(sqrt32(nrm2), min=FLT_EPSILON)
    return torch.round(val * scale[:, None]).clamp(0, 255)


def descriptor_plain(pyr: Pyramid, kp: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """S2b's plain twin: [K, 128] float32 descriptors of final keypoints [K, 6]."""
    d, n = DESCR_WIDTH, DESCR_HIST_BINS
    dev = kp.device
    if kp.shape[0] == 0:
        return torch.zeros((0, DESCR_LEN), device=dev)
    geo = descriptor_geometry(pyr, kp)
    offs = torch.as_tensor(pyr.g_off, device=dev)
    out = []
    for s in range(0, kp.shape[0], chunk):
        g = {k: v[s:s + chunk] for k, v in geo.items()}
        N = g["oct"].shape[0]
        R = int(g["radius"].max())
        off = torch.arange(-R, R + 1, device=dev)
        oi, oj = torch.meshgrid(off, off, indexing="ij")
        oi, oj = oi.reshape(-1)[None], oj.reshape(-1)[None]
        fi, fj = oi.float(), oj.float()
        cos_t, sin_t = g["cos_t"][:, None], g["sin_t"][:, None]
        c_rot = fj * cos_t - fi * sin_t
        r_rot = fj * sin_t + fi * cos_t
        rbin = (r_rot + float(d // 2)) - 0.5
        cbin = (c_rot + float(d // 2)) - 0.5
        rr = g["cy"][:, None] + oi
        cc = g["cx"][:, None] + oj
        H, W = g["rows"][:, None], g["cols"][:, None]
        rad = g["radius"][:, None]
        valid = ((oi.abs() <= rad) & (oj.abs() <= rad) & (rbin > -1) & (rbin < d)
                 & (cbin > -1) & (cbin < d) & (rr > 0) & (rr < H - 1) & (cc > 0)
                 & (cc < W - 1))
        rc, ccl = torch.minimum(torch.maximum(rr, torch.ones_like(rr)), H - 2), \
            torch.minimum(torch.maximum(cc, torch.ones_like(cc)), W - 2)
        base = offs[g["oct"]][:, None] + g["layer"][:, None] * H * W
        G = pyr.gauss
        dx = G[base + rc * W + ccl + 1] - G[base + rc * W + ccl - 1]
        dy = G[base + (rc - 1) * W + ccl] - G[base + (rc + 1) * W + ccl]
        w = exp32((c_rot * c_rot + r_rot * r_rot) * f32(-1.0 / (d * d * 0.5)))
        ori = fast_atan2(dy, dx)
        mag = magnitude32(dx, dy) * w
        obin = (ori - g["angle"][:, None]) * f32(n / 360.0)
        r0, c0, o0 = torch.floor(rbin), torch.floor(cbin), torch.floor(obin)
        rbin, cbin, obin = rbin - r0, cbin - c0, obin - o0
        o0 = o0.long()
        o0 = torch.where(o0 < 0, o0 + n, o0)
        o0 = torch.where(o0 >= n, o0 - n, o0)
        v_r1 = mag * rbin
        v_r0 = mag - v_r1
        v_rc11 = v_r1 * cbin
        v_rc10 = v_r1 - v_rc11
        v_rc01 = v_r0 * cbin
        v_rc00 = v_r0 - v_rc01
        v_rco111 = v_rc11 * obin
        v_rco110 = v_rc11 - v_rco111
        v_rco101 = v_rc10 * obin
        v_rco100 = v_rc10 - v_rco101
        v_rco011 = v_rc01 * obin
        v_rco010 = v_rc01 - v_rco011
        v_rco001 = v_rc00 * obin
        v_rco000 = v_rc00 - v_rco001
        idx = ((r0.long() + 1) * (d + 2) + c0.long() + 1) * (n + 2) + o0
        idx = torch.where(valid, idx, torch.zeros_like(idx))
        steps = (0, 1, n + 2, n + 3, (d + 2) * (n + 2), (d + 2) * (n + 2) + 1,
                 (d + 3) * (n + 2), (d + 3) * (n + 2) + 1)
        vals = (v_rco000, v_rco001, v_rco010, v_rco011, v_rco100, v_rco101, v_rco110,
                v_rco111)
        hist = torch.zeros((N, DESCR_HIST_LEN), device=dev)
        zero = torch.zeros_like(mag)
        # Each sample's eight bins in turn, samples in raster order.
        tgt = torch.stack([idx + st for st in steps], -1).reshape(N, -1)
        src = torch.stack([torch.where(valid, v, zero) for v in vals], -1).reshape(N, -1)
        hist.scatter_add_(1, tgt, src)
        hist = hist.view(N, d + 2, d + 2, n + 2)[:, 1:d + 1, 1:d + 1]
        raw = hist[..., :n].clone()
        raw[..., 0] = raw[..., 0] + hist[..., n]
        raw[..., 1] = raw[..., 1] + hist[..., n + 1]
        out.append(normalize_descriptor(raw.reshape(N, -1)))
    return torch.cat(out)


# ---------------------------------------------------------------------------
# The whole frontend.
# ---------------------------------------------------------------------------


def detect_and_compute(img_u8, n_features: int = 2000, device=None, blur=gaussian_blur):
    """cv2.SIFT_create(nfeatures=n_features, contrastThreshold=1e-5)
    .detectAndCompute of a [H, W] uint8 frame (numpy or a tensor): final
    keypoints float32 [N, 6] (x, y, size, angle, response, packed octave)
    and descriptors float32 [N, 128], on the frame's device (or `device`).
    CUDA tensors take the kernels S1, S2a and S2b, CPU tensors their plain
    twins; the order step runs on the host. `blur` as in `build_pyramid`."""
    from ..ops import sift as sift_ops
    from ..utils.device import no_tf32

    img = torch.as_tensor(np.asarray(img_u8) if not torch.is_tensor(img_u8) else img_u8,
                          device=device)
    if img.dtype != torch.uint8 or img.dim() != 2:
        raise ValueError(f"SIFT takes a [H, W] uint8 frame, got {img.dtype} {tuple(img.shape)}")
    with torch.no_grad(), no_tf32():
        pyr = build_pyramid(img, blur)
        cands = sift_ops.sift_extrema(pyr)
        oriented = sift_ops.sift_orientation(pyr, cands)
        kept = sift_ops.order_keypoints(oriented.kp, n_features)
        kp = half_scale(oriented.kp[kept])
        des = sift_ops.sift_descriptor(pyr, kp)
    return kp, des


def as_uint8_frame(img_grey) -> np.ndarray:
    """A grey frame as the JAX package's `sift_detect` hands it to OpenCV: a
    frame whose maximum is at most 1.0 is taken as [0, 1] and scaled by 255;
    values clipped to [0, 255] and cast to uint8."""
    g = np.asarray(img_grey)
    return np.clip(g * 255.0 if g.max() <= 1.0 else g, 0, 255).astype(np.uint8)


def sift_detect(img_grey, n_features: int = 2000, device=None):
    """The JAX package's `sift_detect`: (pts [N, 2], des [N, 128]) float32
    numpy of `as_uint8_frame(img_grey)`. `device` None means the card."""
    from ..utils.device import resolve_device

    kp, des = detect_and_compute(as_uint8_frame(img_grey), n_features, resolve_device(device))
    return kp[:, :2].cpu().numpy(), des.cpu().numpy()


# Statistical parity with OpenCV's SIFT (tests and chip_smoke.py): OpenCV's
# own unoptimised route against its default one pairs 99.05-100% of
# keypoints and keeps every paired descriptor entry within 1; these bars
# are a little looser.
PARITY_BARS = {"count_rel": 0.015, "paired": 0.985, "desc_rows": 0.99, "desc_tol": 2.0}


def compare_keypoints(kp_a, des_a, kp_b, des_b, tol_px: float = 0.01,
                      tol_deg: float = 0.1) -> dict:
    """Two SIFT results ([N, 6] keypoints, [N, 128] descriptors): the share
    of each list with a keypoint of the other within `tol_px` (Euclidean)
    and `tol_deg` (circular), the share of a's paired rows whose descriptor
    entries are all within PARITY_BARS['desc_tol'] of the pair's, and the
    relative count gap. `ok` holds the three against PARITY_BARS."""
    a, b = np.asarray(kp_a, np.float64).reshape(-1, 6), np.asarray(kp_b, np.float64).reshape(-1, 6)

    def nearest(p, q):
        if len(p) == 0 or len(q) == 0:
            return np.full(len(p), -1)
        d = np.hypot(p[:, None, 0] - q[None, :, 0], p[:, None, 1] - q[None, :, 1])
        da = np.abs(p[:, None, 3] - q[None, :, 3])
        da = np.minimum(da, 360.0 - da)
        cost = np.where((d <= tol_px) & (da <= tol_deg), d + da, np.inf)
        j = cost.argmin(1)
        return np.where(np.isfinite(cost.min(1)), j, -1)

    ja, jb = nearest(a, b), nearest(b, a)
    m = ja >= 0
    da = np.abs(np.asarray(des_a, np.float64)[m] - np.asarray(des_b, np.float64)[ja[m]])
    out = {"n_a": len(a), "n_b": len(b),
           "count_rel": abs(len(a) - len(b)) / max(len(b), 1),
           "paired_a": float(m.mean()) if len(a) else 1.0,
           "paired_b": float((jb >= 0).mean()) if len(b) else 1.0,
           "desc_rows": float((da.max(1) <= PARITY_BARS["desc_tol"]).mean()) if m.any() else 1.0,
           "desc_max": float(da.max()) if m.any() else 0.0,
           "xy_exact": float((a[m, :2] == b[ja[m], :2]).all(1).mean()) if m.any() else 1.0}
    out["ok"] = bool(out["count_rel"] <= PARITY_BARS["count_rel"]
                     and min(out["paired_a"], out["paired_b"]) >= PARITY_BARS["paired"]
                     and out["desc_rows"] >= PARITY_BARS["desc_rows"])
    return out
