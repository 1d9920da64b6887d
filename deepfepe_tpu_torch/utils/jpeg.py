"""ctypes bindings of the native JPEG codec (`native/jpeg.cpp`).

- `read_jpeg_grey(path_or_bytes)` -> [H, W] uint8: what
  `cv2.imread(path, cv2.IMREAD_GRAYSCALE)` returns (OpenCV with its
  libjpeg-turbo), bit for bit, for Huffman-coded 8-bit baseline, extended
  and progressive frames of 1 or 3 components (sampling factors up to 4x4),
  restart intervals, 8- and 16-bit quantization tables and the EXIF
  orientation tag. A truncated or corrupt stream raises `ValueError`
  (libjpeg warns and pads it); arithmetic coding, 12-bit, lossless and
  hierarchical frames, 2- and 4-component frames and a progressive file
  whose low AC coefficients are incomplete raise `NotImplementedError`
  naming `UNSUPPORTED_ITEM`.
- `write_jpeg(path, img, quality=95)`: the bytes `cv2.imwrite(path, img)`
  writes for a [H, W] uint8 image (`encode_jpeg_grey` returns them).
- `png_unfilter`: PNG's row filters undone, for `utils/image_io.read_png`
  (Average and Paeth run serially along a row).

The source is built with g++ at first use into `build/torch_native/` at the
repository root (`utils/native_build.py`). A failed build raises with
g++'s message; nothing falls back to another reader. The codec
keeps no global state, so threads may decode at the same time.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from . import native_build

SOURCE = "jpeg.cpp"
UNSUPPORTED_ITEM = "ROADMAP Queue 1 item 9, the image forms the native readers refuse"
_ERRLEN = 256


def library_path() -> Path:
    return native_build.library_path(SOURCE)


def build() -> Path:
    """Compile the codec unless its library exists; raise with g++'s
    message when the build fails."""
    return native_build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.jpg_decode_grey.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(u8p),
                                    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                                    ctypes.c_char_p, ctypes.c_int]
    lib.jpg_decode_grey.restype = ctypes.c_int
    lib.jpg_encode_grey.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_int64),
                                    ctypes.c_char_p, ctypes.c_int]
    lib.jpg_encode_grey.restype = ctypes.c_int
    lib.jpg_free.argtypes = [u8p]
    lib.jpg_free.restype = None
    lib.png_unfilter.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                 ctypes.c_void_p]
    lib.png_unfilter.restype = ctypes.c_int
    return lib


def _raise(status: int, err: ctypes.Array, what: str):
    msg = f"{what}: {err.value.decode(errors='replace')}"
    if status == 2:
        raise NotImplementedError(f"{msg} ({UNSUPPORTED_ITEM})")
    raise ValueError(msg)


def read_jpeg_grey(src) -> np.ndarray:
    """A JPEG file (a path) or stream (bytes) -> [H, W] uint8 grey, as
    cv2.imread(path, cv2.IMREAD_GRAYSCALE) reads it."""
    data = bytes(src) if isinstance(src, (bytes, bytearray, memoryview)) else Path(src).read_bytes()
    what = "JPEG stream" if isinstance(src, (bytes, bytearray, memoryview)) else str(src)
    lib = _lib()
    out = ctypes.POINTER(ctypes.c_uint8)()
    h, w = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    st = lib.jpg_decode_grey(data, len(data), ctypes.byref(out), ctypes.byref(h), ctypes.byref(w),
                             err, _ERRLEN)
    if st != 0:
        _raise(st, err, what)
    try:
        return np.ctypeslib.as_array(out, shape=(h.value * w.value,)).reshape(
            h.value, w.value).copy()
    finally:
        lib.jpg_free(out)


def encode_jpeg_grey(img: np.ndarray, quality: int = 95) -> bytes:
    """The bytes cv2.imencode('.jpg', img) gives for a [H, W] uint8 image
    at IMWRITE_JPEG_QUALITY `quality`."""
    img = np.ascontiguousarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"encode_jpeg_grey takes a [H, W] uint8 image, not {img.dtype} "
                         f"{img.shape}")
    lib = _lib()
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_int64()
    err = ctypes.create_string_buffer(_ERRLEN)
    st = lib.jpg_encode_grey(img.ctypes.data_as(ctypes.c_void_p), img.shape[0], img.shape[1],
                             int(quality), ctypes.byref(out), ctypes.byref(n), err, _ERRLEN)
    if st != 0:
        _raise(st, err, "JPEG encoder")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.jpg_free(out)


def png_unfilter(raw: bytes, rows: int, rowbytes: int, bpp: int) -> np.ndarray:
    """PNG rows with their filter bytes -> [rows, rowbytes] uint8 with the
    filters undone; `bpp` is the bytes of a whole pixel (at least 1)."""
    if len(raw) < rows * (rowbytes + 1):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, {rows * (rowbytes + 1)} needed")
    out = np.empty((rows, rowbytes), np.uint8)
    if rows and rowbytes and _lib().png_unfilter(bytes(raw), rows, rowbytes, bpp,
                                                 out.ctypes.data_as(ctypes.c_void_p)):
        raise ValueError("unknown PNG filter type")
    return out


def write_jpeg(path, img: np.ndarray, quality: int = 95) -> None:
    """Write a [H, W] uint8 image as cv2.imwrite(path, img) writes it
    (quality 95, cv2's default)."""
    Path(path).write_bytes(encode_jpeg_grey(img, quality))
