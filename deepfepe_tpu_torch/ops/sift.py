"""The SIFT frontend's kernels: S1, S2a and S2b, and the host order step.

No TPU kernel computes these: the JAX package calls OpenCV's SIFT on the
host (`deepfepe_tpu/data/dump_kitti.py:37`, `cv2.SIFT_create`). The port
runs it on the card (`frontend/sift.py` for the whole frontend):

- `sift_extrema` (S1): the refined extrema of a `Pyramid`'s DoG, one
  thread a pixel of layers 1-3 of every octave (26-neighbour test, Newton
  refinement solved by Cramer's rule in float32, contrast and edge tests),
  appended through an atomic counter into a buffer sized from the frame
  (`extrema_capacity`) and launched once more at the counted size if the
  frame holds more;
- `sift_orientation` (S2a): one block a candidate, its 36-bin histogram
  in shared memory, one keypoint a peak;
- `order_keypoints`: OpenCV's removeDuplicatedSorted and retainBest on the
  host, by libstdc++'s own sort, nth_element and partition
  (`native/keypoint_filter.cpp`, built with g++ at first use);
- `sift_descriptor` (S2b): one block a kept keypoint, its 4x4x8 bins (with
  their border, 360) in shared memory.

Each wrapper runs its plain twin (`frontend/sift.py`) for tensors on the
CPU; for CUDA tensors it launches `csrc/sift.cu` or raises. Each counts
its launches in `.launches`. The candidates and keypoints come back in the
plain twins' order: S1's rows sorted by the DoG pixel they started from,
S2a's by candidate (a block writes its peaks together, in bin order).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils import build, native_build

SOURCE = "sift.cu"
FILTER_SOURCE = "keypoint_filter.cpp"
MAX_OCTAVES = 16

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from SOURCE."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sift_extrema.argtypes = [P, P, I, P, P, P, I, P]
    lib.sift_extrema.restype = I
    lib.sift_orientation.argtypes = [P, P, I, P, P, I, P, P, P, I, P]
    lib.sift_orientation.restype = I
    lib.sift_descriptor.argtypes = [P, P, I, P, I, P, P]
    lib.sift_descriptor.restype = I
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(build.load(SOURCE))
    return _lib


@functools.lru_cache(maxsize=None)
def _filter_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(native_build.build(FILTER_SOURCE)))
    lib.kp_filter.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.kp_filter.restype = ctypes.c_int
    return lib


def _table(pyr) -> np.ndarray:
    if pyr.n_octaves > MAX_OCTAVES:
        raise ValueError(f"the SIFT kernels take at most {MAX_OCTAVES} octaves, got "
                         f"{pyr.n_octaves}")
    if pyr.gauss.numel() >= 2 ** 31:
        raise ValueError("the SIFT kernels index the pyramid with 32-bit pixel numbers")
    return np.ascontiguousarray(pyr.table())


def _check_cuda(*ts):
    if not all(t.is_cuda and t.device == ts[0].device for t in ts):
        raise ValueError(f"the SIFT kernels take CUDA tensors on one device, got "
                         f"{[str(t.device) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the SIFT kernels take contiguous tensors")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


def tested_pixels(pyr) -> int:
    """The DoG pixels S1 tests: layers 1-3 inside the 5 px border."""
    from ..frontend.sift import IMG_BORDER, N_OCTAVE_LAYERS

    B = IMG_BORDER
    return sum(N_OCTAVE_LAYERS * (h - 2 * B) * (w - 2 * B)
               for h, w in zip(pyr.rows, pyr.cols) if h > 2 * B and w > 2 * B)


def extrema_capacity(pyr) -> int:
    """S1's first buffer: a row in 256 tested pixels, at least 4,096 rows
    (28,394 rows, 1 MB, at 376x1240, where the fixtures' frames give 459-1,272
    candidates)."""
    return max(tested_pixels(pyr) // 256, 4096)


def _extrema_launch(pyr, table, cap: int):
    dev = pyr.dog.device
    kp = torch.empty((max(cap, 1), 4), dtype=torch.float32, device=dev)
    idx = torch.empty((max(cap, 1), 5), dtype=torch.int32, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _load().sift_extrema(pyr.dog.data_ptr(), table.ctypes.data, pyr.n_octaves,
                                  kp.data_ptr(), idx.data_ptr(), count.data_ptr(), cap,
                                  _stream(pyr.dog))
    _raise(rc, "S1 sift_extrema")
    sift_extrema.launches += 1
    return int(count.item()), kp, idx


def sift_extrema(pyr, capacity: int | None = None):
    """S1: the candidates of every octave (`frontend.sift.Candidates`), in
    the order of the DoG pixel each started from. The CUDA buffer holds
    `extrema_capacity` rows; the kernel counts every candidate, so a frame
    with more is launched once more at its count. With `capacity` given,
    the buffer holds that many rows and an overflow raises."""
    from ..frontend import sift as plain

    if pyr.dog.device.type == "cpu":
        return plain.extrema_plain(pyr)
    _check_cuda(pyr.dog, pyr.gauss)
    table = _table(pyr)
    cap = extrema_capacity(pyr) if capacity is None else int(capacity)
    n, kp, idx = _extrema_launch(pyr, table, cap)
    if n > cap and capacity is None:
        cap = n
        n, kp, idx = _extrema_launch(pyr, table, cap)
    if n > cap:
        raise RuntimeError(f"S1: {n} candidates overflow its buffer of {cap}")
    return plain.Candidates(kp[:n].clone(), idx[:n].clone()).sorted()


def sift_orientation(pyr, cands):
    """S2a: the keypoints of the candidates' orientation peaks
    (`frontend.sift.Oriented`), by candidate and then by bin."""
    from ..frontend import sift as plain

    if cands.kp.device.type == "cpu":
        return plain.orientation_plain(pyr, cands)
    _check_cuda(pyr.gauss, cands.kp, cands.idx)
    table = _table(pyr)
    n = len(cands)
    dev = cands.kp.device
    cap = max(n * plain.MAX_PEAKS, 1)
    kp = torch.empty((cap, 6), dtype=torch.float32, device=dev)
    src = torch.empty((cap,), dtype=torch.int32, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    if n:
        with torch.cuda.device(dev):
            rc = _load().sift_orientation(pyr.gauss.data_ptr(), table.ctypes.data,
                                          pyr.n_octaves, cands.kp.data_ptr(),
                                          cands.idx.data_ptr(), n, kp.data_ptr(),
                                          src.data_ptr(), count.data_ptr(), cap,
                                          _stream(cands.kp))
        _raise(rc, "S2a sift_orientation")
        sift_orientation.launches += 1
    m = int(count.item())
    if m > cap:
        raise RuntimeError(f"S2a: {m} keypoints overflow its buffer of {cap}")
    order = torch.argsort(src[:m].long(), stable=True)
    return plain.Oriented(kp[:m][order], src[:m][order])


def order_keypoints(kp: torch.Tensor, n_features: int) -> torch.Tensor:
    """The rows of keypoints [M, 6] (x, y, size, angle, response, packed
    octave, at the doubled scale) that OpenCV keeps for `n_features`, in
    its order, as an index tensor on kp's device. Runs on the host."""
    host = np.ascontiguousarray(kp.detach().cpu().numpy(), dtype=np.float32)
    out = np.empty(max(len(host), 1), np.int32)
    k = _filter_lib().kp_filter(host.ctypes.data, len(host), int(n_features), out.ctypes.data)
    return torch.as_tensor(out[:k].astype(np.int64), device=kp.device)


def sift_descriptor(pyr, kp: torch.Tensor) -> torch.Tensor:
    """S2b: float32 [K, 128] descriptors of final keypoints [K, 6]."""
    from ..frontend import sift as plain

    if kp.device.type == "cpu":
        return plain.descriptor_plain(pyr, kp)
    kp = kp.contiguous()
    _check_cuda(pyr.gauss, kp)
    table = _table(pyr)
    des = torch.empty((kp.shape[0], plain.DESCR_LEN), dtype=torch.float32, device=kp.device)
    if kp.shape[0]:
        with torch.cuda.device(kp.device):
            rc = _load().sift_descriptor(pyr.gauss.data_ptr(), table.ctypes.data,
                                         pyr.n_octaves, kp.data_ptr(), kp.shape[0],
                                         des.data_ptr(), _stream(kp))
        _raise(rc, "S2b sift_descriptor")
        sift_descriptor.launches += 1
    return des


sift_extrema.launches = 0
sift_orientation.launches = 0
sift_descriptor.launches = 0
