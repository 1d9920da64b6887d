"""Grey-image file I/O and the area resize, without cv2 or PIL.

The card's machine has neither OpenCV nor Pillow, so the port reads and
writes its frames itself:

- `read_png` / `write_png`: 8-bit greyscale PNG through the standard
  library's zlib (every row filter, 0-4, on read; filter 0 on write; no
  interlacing). Other PNG forms raise.
- `resize_area`: `cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)`
  for uint8 images: the weights of OpenCV's area tables when both axes
  shrink (or keep) their size, and its area-mode linear coefficients
  otherwise, summed in float32 and rounded to uint8 as cv2 does.
- `read_grey`: a frame by extension. A `.jpg` raises `NotImplementedError`:
  decoding JPEG is a separate item (ROADMAP Queue 1, the numpy JPEG
  decoder), and nothing falls back to another reader.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_ITEM = "ROADMAP Queue 1 item 1, a numpy JPEG decoder for reference dump frames"


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)


def write_png(path, img: np.ndarray) -> None:
    """Write a [H, W] uint8 image as an 8-bit greyscale PNG."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"write_png takes a [H, W] uint8 image, not {img.dtype} {img.shape}")
    H, W = img.shape
    raw = np.concatenate([np.zeros((H, 1), np.uint8), img], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0)
    data = (PNG_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))
    Path(path).write_bytes(data)


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_row(kind: int, row: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Undo one row's PNG filter (one byte a pixel)."""
    if kind == 0:
        return row
    if kind == 1:  # Sub: a running sum modulo 256
        return (np.cumsum(row, dtype=np.int64) % 256).astype(np.uint8)
    if kind == 2:  # Up
        return (row.astype(np.int32) + up).astype(np.uint8)
    out = np.empty_like(row)
    r, u = row.tolist(), up.tolist()
    left = 0
    if kind == 3:  # Average
        for i in range(len(r)):
            left = (r[i] + ((left + u[i]) >> 1)) & 0xFF
            out[i] = left
        return out
    if kind == 4:  # Paeth
        ul = 0
        for i in range(len(r)):
            left = (r[i] + _paeth(left, u[i], ul)) & 0xFF
            ul = u[i]
            out[i] = left
        return out
    raise ValueError(f"unknown PNG filter type {kind}")


def read_png(path) -> np.ndarray:
    """Read an 8-bit greyscale, non-interlaced PNG -> [H, W] uint8."""
    data = Path(path).read_bytes()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = len(PNG_SIGNATURE), None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, color, _, _, interlace = header
    if depth != 8 or color != 0 or interlace != 0:
        raise NotImplementedError(
            f"{path}: only 8-bit greyscale non-interlaced PNG is read (bit depth {depth}, "
            f"colour type {color}, interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(H, W + 1)
    out = np.empty((H, W), np.uint8)
    up = np.zeros(W, np.int32)
    for y in range(H):
        out[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], up)
        up = out[y].astype(np.int32)
    return out


def read_grey(path) -> np.ndarray:
    """A frame as [H, W] uint8 by its extension (PNG only)."""
    path = Path(path)
    if path.suffix.lower() in (".jpg", ".jpeg"):
        raise NotImplementedError(f"{path}: JPEG frames are not read ({JPEG_ITEM})")
    return read_png(path)


def _area_table(ssize: int, dsize: int, scale: float) -> np.ndarray:
    """[dsize, ssize] weights of OpenCV's computeResizeAreaTab (scale >= 1)."""
    M = np.zeros((dsize, ssize), np.float32)
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            M[dx, sx1 - 1] += np.float32((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            M[dx, sx] += np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            M[dx, sx2] += np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return M


def _linear_area_table(ssize: int, dsize: int, scale: float) -> np.ndarray:
    """[dsize, ssize] weights of OpenCV's linear path in area mode (a size
    that grows on some axis)."""
    M = np.zeros((dsize, ssize), np.float32)
    inv = dsize / ssize
    for dx in range(dsize):
        sx = int(np.floor(dx * scale))
        fx = float(np.float32((dx + 1) - (sx + 1) * inv))
        fx = 0.0 if fx <= 0 else fx - np.floor(fx)
        if sx < 0:
            fx, sx = 0.0, 0
        if sx + 1 >= ssize and sx >= ssize - 1:
            fx, sx = 0.0, ssize - 1
        M[dx, sx] += np.float32(1.0 - fx)
        if fx:
            M[dx, sx + 1] += np.float32(fx)
    return M


def resize_area(img: np.ndarray, size) -> np.ndarray:
    """[H, W] uint8 -> [h, w] uint8 for `size` (h, w), as cv2.INTER_AREA."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"resize_area takes a [H, W] uint8 image, not {img.dtype} {img.shape}")
    H, W = img.shape
    h, w = int(size[0]), int(size[1])
    if (h, w) == (H, W):
        return img.copy()
    # OpenCV forms the scales as 1 / (dst / src), which rounds otherwise
    # than src / dst at some sizes and moves a floor by one pixel.
    sy, sx = 1.0 / (h / H), 1.0 / (w / W)
    table = _area_table if sx >= 1 and sy >= 1 else _linear_area_table
    My, Mx = table(H, h, sy), table(W, w, sx)
    out = My @ (img.astype(np.float32) @ Mx.T)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
