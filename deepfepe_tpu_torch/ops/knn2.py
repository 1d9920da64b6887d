"""Brute-force two nearest neighbours with Lowe's ratio test: kernel S3.

No TPU kernel computes this: the JAX package matches SIFT descriptors on
the host with OpenCV (`deepfepe_tpu/data/dump_kitti.py:56`,
`cv2.BFMatcher().knnMatch(k=2)`, and Lowe's ratio test at :56-67 of
`knn_match`). `knn2` returns, for each query row of des1 [N1, 128], its two
nearest train rows of des2 [N2, 128] by L2 distance and those distances
(float32, sqrt of the exact integer sum for SIFT's integer-valued
descriptors), ties to the lower train index as OpenCV keeps them;
`ratio_matches` applies the ratio test and forms the quality columns in
float64, as the JAX package's Python does, so the result equals
`knn_match`'s bit for bit.

`knn2` runs the plain version, `knn2_plain`, for tensors on the CPU; for
CUDA tensors it launches `csrc/knn2.cu` or raises (a tile kernel writing
per-chunk best-two partials to scratch the wrapper allocates, and a fold
kernel). `knn2.launches` counts calls (two CUDA launches each).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import build

SOURCE = "knn2.cu"
DIM = 128

_lib = None


def knn2_plain(des1: torch.Tensor, des2: torch.Tensor):
    """Plain version: exact squared distances in float64 (integer-valued
    descriptors), their square roots rounded to float32, the first two of
    each row by distance and then index."""
    a, b = des1.double(), des2.double()
    sq = ((a * a).sum(1)[:, None] + (b * b).sum(1)[None] - 2.0 * (a @ b.T)).clamp(min=0)
    d = torch.sqrt(sq).float()  # torch's float32 sqrt on the CPU is not IEEE's
    i0 = torch.argmin(d, 1)  # the first of equal minima
    d0 = d.gather(1, i0[:, None])[:, 0]
    if d.shape[1] < 2:
        i1 = torch.full_like(i0, -1)
        d1 = torch.full_like(d0, torch.finfo(torch.float32).max)
    else:
        rest = d.scatter(1, i0[:, None], float("inf"))
        i1 = torch.argmin(rest, 1)
        d1 = rest.gather(1, i1[:, None])[:, 0]
    return torch.stack([i0, i1], 1).int(), torch.stack([d0, d1], 1)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from SOURCE."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.knn2_f32.argtypes = [P, P, I, I, P, P, P, P]
    lib.knn2_f32.restype = I
    lib.knn2_scratch_bytes.argtypes = [I, I]
    lib.knn2_scratch_bytes.restype = ctypes.c_longlong
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(build.load(SOURCE))
    return _lib


def launch(des1: torch.Tensor, des2: torch.Tensor):
    """Run S3 on CUDA tensors; returns (nn int32 [N1, 2], dist float32 [N1, 2])."""
    if des1.dim() != 2 or des2.dim() != 2 or des1.shape[1] != DIM or des2.shape[1] != DIM:
        raise ValueError(f"S3 takes des1 [N1, {DIM}] and des2 [N2, {DIM}], got "
                         f"{tuple(des1.shape)} and {tuple(des2.shape)}")
    if des1.dtype != torch.float32 or des2.dtype != torch.float32:
        raise ValueError("S3 takes float32 descriptors")
    if not (des1.is_cuda and des2.is_cuda and des1.device == des2.device):
        raise ValueError(f"the S3 kernel takes CUDA tensors on one device, got "
                         f"{des1.device} and {des2.device}")
    n1, n2 = des1.shape[0], des2.shape[0]
    q, t = des1.contiguous(), des2.contiguous()
    if q.data_ptr() % 16 or t.data_ptr() % 16:
        q, t = q.clone(), t.clone()
    lib = _load()
    nn = torch.empty((n1, 2), dtype=torch.int32, device=des1.device)
    dist = torch.empty((n1, 2), dtype=torch.float32, device=des1.device)
    scratch = torch.empty(lib.knn2_scratch_bytes(n1, n2), dtype=torch.uint8, device=des1.device)
    with torch.cuda.device(des1.device):
        stream = torch.cuda.current_stream(des1.device).cuda_stream
        rc = lib.knn2_f32(q.data_ptr(), t.data_ptr(), n1, n2, nn.data_ptr(), dist.data_ptr(),
                          scratch.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"S3 kernel launch failed: cudaError {rc}")
    knn2.launches += 1
    return nn, dist


def knn2(des1: torch.Tensor, des2: torch.Tensor):
    """(nn int32 [N1, 2], dist float32 [N1, 2]): each query row's two
    nearest train rows and their distances; index -1 where des2 has fewer
    than two rows. CPU tensors take the plain version; CUDA tensors launch
    S3."""
    if des1.shape[0] == 0 or des2.shape[0] == 0:
        return (torch.full((des1.shape[0], 2), -1, dtype=torch.int32, device=des1.device),
                torch.full((des1.shape[0], 2), torch.finfo(torch.float32).max,
                           device=des1.device))
    if des1.device.type == "cpu":
        return knn2_plain(des1, des2)
    return launch(des1, des2)


knn2.launches = 0


def ratio_matches(nn: torch.Tensor, dist: torch.Tensor, ratio: float):
    """Lowe's ratio test on knn2's output, in float64: the query rows whose
    nearest distance is below `ratio` x the second's, as (idx int32 [M, 2]:
    query row, train row; quality float32 [M, 2]: the second distance and
    d1 / (d2 + 1e-9)). Rows without a second neighbour are skipped."""
    d = dist.double()
    keep = (nn[:, 1] >= 0) & (d[:, 0] < ratio * d[:, 1])
    rows = torch.nonzero(keep, as_tuple=True)[0]
    idx = torch.stack([rows.int(), nn[rows, 0]], 1)
    quality = torch.stack([d[rows, 1], d[rows, 0] / (d[rows, 1] + 1e-9)], 1).float()
    return idx, quality
