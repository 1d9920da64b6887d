"""Grey-image file I/O and the area resize, without cv2 or PIL.

The card's machine has neither OpenCV nor Pillow, so the port reads and
writes its frames itself, as `cv2.imread(path, cv2.IMREAD_GRAYSCALE)` reads
them and `cv2.imwrite` writes them:

- `read_png`: every PNG form (colour types 0, 2, 3, 4 and 6; bit depths 1,
  2, 4, 8 and 16; Adam7 interlacing), converted to grey as OpenCV has
  libpng convert it: grey below 8 bits scaled up (x255, x85, x17), 16 bits
  cut to the high byte (`png_set_strip_16`), alpha dropped, a palette
  expanded to RGB, and RGB turned grey by libpng's `rgb_to_gray` with
  OpenCV's weights (0.299, 0.587 in libpng's 15-bit fixed point; 8-bit
  samples truncated, 16-bit ones rounded before the cut). A colour file
  with a gAMA or sRGB chunk takes libpng's gamma path for 8-bit samples
  (linearise, weigh, re-encode through libpng's 8-bit gamma tables); a
  16-bit colour file with one raises `NotImplementedError`. An eXIf
  orientation is applied as cv2 applies it. The row filters are undone by
  the native library (`utils/jpeg.png_unfilter`).
- `write_png`: 8-bit greyscale, filter 0.
- `read_grey`: a frame by its signature, as cv2 tells formats apart: JPEG
  through the native decoder (`utils/jpeg.read_jpeg_grey`), PNG through
  `read_png`.
- `resize_area`: `cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)`
  for uint8 images: the weights of OpenCV's area tables when both axes
  shrink (or keep) their size, and its area-mode linear coefficients
  otherwise, summed in float32 and rounded to uint8 as cv2 does.
"""

from __future__ import annotations

import math
import struct
import zlib
from pathlib import Path

import numpy as np

from . import jpeg

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))  # (x0, y0, dx, dy) of each pass
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# png_set_rgb_to_gray(png_ptr, 1, 0.299, 0.587) in libpng's fixed point
RGB_TO_GRAY_RC = 29900 * 32768 // 100000
RGB_TO_GRAY_GC = 58700 * 32768 // 100000
RGB_TO_GRAY_BC = 32768 - RGB_TO_GRAY_RC - RGB_TO_GRAY_GC
PNG_FP_1 = 100000
GAMMA_THRESHOLD = 5000  # libpng's PNG_GAMMA_THRESHOLD_FIXED
SRGB_GAMMA = 45455


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


def _samples(rows: np.ndarray, width: int, depth: int, channels: int) -> np.ndarray:
    """Unfiltered rows [h, rowbytes] -> [h, width, channels] integer samples."""
    h = rows.shape[0]
    if depth == 16:
        v = rows.reshape(h, -1).view(">u2")[:, :width * channels]
        return v.astype(np.uint16).reshape(h, width, channels)
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    bits = np.unpackbits(rows, axis=1)[:, :width * depth].reshape(h, width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[..., None]


def _gamma_table(gamma: int) -> np.ndarray:
    """libpng's png_build_8bit_table for a fixed-point gamma."""
    v = np.arange(256)
    if abs(gamma - PNG_FP_1) <= GAMMA_THRESHOLD:
        return v.astype(np.uint8)
    t = np.floor(255 * np.power(v / 255.0, gamma * 1e-5) + 0.5)
    t[0], t[255] = 0, 255
    return t.astype(np.uint8)


def _reciprocal(a: int) -> int:
    return int(math.floor(1e10 / a + 0.5))


def _rgb_to_grey(rgb: np.ndarray, depth: int, gamma: int | None, path) -> np.ndarray:
    """libpng's png_do_rgb_to_gray with OpenCV's weights, then the 16-to-8
    strip: [H, W, 3] samples -> [H, W] uint8."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    same = (r == g) & (r == b)
    if gamma is not None and abs(gamma - PNG_FP_1) > GAMMA_THRESHOLD:
        if depth == 16:
            raise NotImplementedError(
                f"{path}: a 16-bit colour PNG with a gamma chunk ({jpeg.UNSUPPORTED_ITEM})")
        screen = _reciprocal(gamma)
        to_1, from_1 = _gamma_table(screen), _gamma_table(_reciprocal(screen))
        r, g, b = (to_1[c].astype(np.int64) for c in (r, g, b))
        grey = from_1[(RGB_TO_GRAY_RC * r + RGB_TO_GRAY_GC * g + RGB_TO_GRAY_BC * b + 16384) >> 15]
        return np.where(same, rgb[..., 0], grey).astype(np.uint8)
    if depth == 16:
        grey16 = (RGB_TO_GRAY_RC * r + RGB_TO_GRAY_GC * g + RGB_TO_GRAY_BC * b + 16384) >> 15
        return (grey16 >> 8).astype(np.uint8)
    grey = (RGB_TO_GRAY_RC * r + RGB_TO_GRAY_GC * g + RGB_TO_GRAY_BC * b) >> 15
    return np.where(same, r, grey).astype(np.uint8)


def _exif_orientation(exif: bytes) -> int:
    """The orientation tag of a TIFF-headed EXIF block's IFD0 (1 if none)."""
    if len(exif) < 8 or exif[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if exif[:2] == b"II" else ">"
    (ifd,) = struct.unpack(e + "I", exif[4:8])
    if ifd + 2 > len(exif):
        return 1
    (count,) = struct.unpack(e + "H", exif[ifd:ifd + 2])
    for i in range(count):
        at = ifd + 2 + 12 * i
        if at + 12 > len(exif):
            break
        tag, kind = struct.unpack(e + "HH", exif[at:at + 4])
        if tag == 0x0112 and kind == 3:
            (o,) = struct.unpack(e + "H", exif[at + 8:at + 10])
            return o if 1 <= o <= 8 else 1
    return 1


def _apply_orientation(img: np.ndarray, o: int) -> np.ndarray:
    """cv2's ExifTransform: 2 flip x, 3 flip both, 4 flip y, 5 transpose,
    6 transpose + flip x, 7 transpose + flip both, 8 transpose + flip y."""
    if o >= 5:
        img = img.T
    if o in (2, 3, 6, 7):
        img = img[:, ::-1]
    if o in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def read_png(path) -> np.ndarray:
    """Read any PNG -> [H, W] uint8 grey, as cv2.imread(path,
    cv2.IMREAD_GRAYSCALE)."""
    data = Path(path).read_bytes()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat, palette, gamma, exif = len(PNG_SIGNATURE), None, [], None, None, None
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"gAMA" and gamma is None:
            (gamma,) = struct.unpack(">I", body)
        elif kind == b"sRGB":
            gamma = SRGB_GAMMA
        elif kind == b"eXIf":
            exif = body
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, color, _, _, interlace = header
    if color not in CHANNELS or depth not in DEPTHS[color] or interlace > 1:
        raise ValueError(f"{path}: bad PNG header (bit depth {depth}, colour type {color}, "
                         f"interlace {interlace})")
    if color == 3 and palette is None:
        raise ValueError(f"{path}: a palette image without PLTE")
    ch = CHANNELS[color]
    bpp = max(1, depth * ch // 8)
    raw = zlib.decompress(b"".join(idat))
    if interlace == 0:
        rowbytes = (W * ch * depth + 7) // 8
        px = _samples(jpeg.png_unfilter(raw, H, rowbytes, bpp), W, depth, ch)
    else:
        px = np.zeros((H, W, ch), np.uint16 if depth == 16 else np.uint8)
        at = 0
        for x0, y0, dx, dy in ADAM7:
            w, h = -(-(W - x0) // dx) if W > x0 else 0, -(-(H - y0) // dy) if H > y0 else 0
            if not w or not h:
                continue
            rowbytes = (w * ch * depth + 7) // 8
            rows = jpeg.png_unfilter(raw[at:], h, rowbytes, bpp)
            at += h * (rowbytes + 1)
            px[y0::dy, x0::dx] = _samples(rows, w, depth, ch)
    if color == 3:
        idx = px[..., 0]
        if idx.max(initial=0) >= len(palette):
            raise ValueError(f"{path}: a palette index past the PLTE entries")
        out = _rgb_to_grey(palette[idx], 8, gamma, path)
    elif color in (2, 6):
        out = _rgb_to_grey(px[..., :3], depth, gamma, path)
    elif depth == 16:
        out = (px[..., 0] >> 8).astype(np.uint8)
    else:
        out = (px[..., 0] * (255 // ((1 << depth) - 1))).astype(np.uint8)
    return _apply_orientation(out, _exif_orientation(exif)) if exif else out


def read_grey(path) -> np.ndarray:
    """A frame as [H, W] uint8 grey, by its signature as cv2 tells formats
    apart: JPEG (FF D8 FF) through the native decoder, PNG through
    `read_png`; any other file named `.jpg`/`.jpeg` goes to the JPEG
    decoder, which says what is wrong with it."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(len(PNG_SIGNATURE))
    if head.startswith(PNG_SIGNATURE):
        return read_png(path)
    if head.startswith(JPEG_SIGNATURE) or path.suffix.lower() in (".jpg", ".jpeg"):
        return jpeg.read_jpeg_grey(path)
    raise ValueError(f"{path} is neither a JPEG nor a PNG file")


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
