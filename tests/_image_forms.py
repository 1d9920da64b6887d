"""Builders of JPEG and PNG files in the forms the port's readers cover,
for tests/test_torch_{jpeg,image_io}.py and the committed fixtures
(tests/fixtures/image_io/make_fixtures.py). Files come from cv2 and PIL,
or are assembled here from their bytes: an EXIF orientation, 16-bit
quantization tables, a three-component frame whose first component is
smaller than the largest (non-interleaved scans taken from grey cv2
files), truncated and refused streams, and PNGs of any colour type, bit
depth, filter and interlace (zlib)."""

import io
import struct
import zlib

import cv2
import numpy as np
from PIL import Image

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111, "411": 0x411111,
            "440": 0x121111}


def frame(h, w, colour=False, seed=0, noise=12.0):
    """A deterministic textured frame: [h, w] uint8, or [h, w, 3] BGR."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = 128 + 60 * np.sin(x / 17.0 + y / 29.0) + 45 * np.cos(y / 11.0) + rng.randn(h, w) * noise
    if colour:
        base = np.stack([base, 0.6 * base[::-1] + 50, 255 - base], -1)
    return np.clip(base, 0, 255).astype(np.uint8)


def cv2_jpeg(img, quality=95, sampling=None, restart=0, progressive=False, optimize=False):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if progressive:
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    if optimize:
        params += [cv2.IMWRITE_JPEG_OPTIMIZE, 1]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def pil_jpeg(img, quality=90, progressive=False, subsampling=2):
    im = Image.fromarray(img if img.ndim == 2 else img[..., ::-1])
    bio = io.BytesIO()
    im.save(bio, "JPEG", quality=quality, progressive=progressive, subsampling=subsampling)
    return bio.getvalue()


def segments(data):
    """[(marker, body offset, body end)] of a JPEG up to its first SOS, and
    the offset where the SOS's entropy-coded data starts."""
    out, p = [], 2
    while True:
        m = data[p + 1]
        n = struct.unpack(">H", data[p + 2:p + 4])[0]
        out.append((m, p + 4, p + 2 + n))
        p += 2 + n
        if m == 0xDA:
            return out, p


def with_exif_orientation(data, orientation, big_endian=False):
    """`data` with an APP1 Exif segment (IFD0 holding the orientation tag)
    after its SOI."""
    e = ">" if big_endian else "<"
    tiff = (b"MM" if big_endian else b"II") + struct.pack(e + "HI", 42, 8)
    tiff += struct.pack(e + "H", 1) + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
    tiff += struct.pack(e + "I", 0)
    body = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + data[2:]


def with_16bit_tables(data):
    """`data` with every 8-bit quantization table rewritten as a 16-bit
    one (the same values)."""
    segs, _ = segments(data)
    out, last = bytearray(), 0
    for m, a, b in segs:
        if m != 0xDB:
            continue
        body, new, p = data[a:b], bytearray(), 0
        while p < len(body):
            pq, tq = body[p] >> 4, body[p] & 15
            vals = body[p + 1:p + 1 + (128 if pq else 64)]
            if pq == 0:
                vals = b"".join(struct.pack(">H", v) for v in vals)
            new += bytes([0x10 | tq]) + vals
            p += 1 + (128 if pq else 64)
        out += data[last:a - 4] + b"\xff\xdb" + struct.pack(">H", len(new) + 2) + new
        last = b
    return bytes(out + data[last:])


def _grey_scan(img, quality):
    """The tables and entropy-coded data of cv2's grey JPEG of img."""
    data = cv2_jpeg(img, quality)
    segs, start = segments(data)
    tables = b"".join(data[a - 4:b] for m, a, b in segs if m in (0xDB, 0xC4))
    assert data[-2:] == b"\xff\xd9"
    return tables, data[start:-2]


def small_first_component(h, w, factors, quality=90, seed=0):
    """A JFIF three-component baseline JPEG in non-interleaved scans whose
    first component, the one a grey decode returns, has sampling factors
    (1, 1) against the second's `factors` (h, v): libjpeg upsamples it.
    Each scan's data is a grey cv2 JPEG of that component's size (the
    same standard tables and quantization for all)."""
    hmax, vmax = factors
    comps = [(1, (1, 1)), (2, (hmax, vmax)), (3, (1, 1))]
    scans, tables = [], b""
    for k, (cid, (ch, cv)) in enumerate(comps):
        dh, dw = -(-h * cv // vmax), -(-w * ch // hmax)
        tables, data = _grey_scan(frame(dh, dw, seed=seed + k), quality)
        scans.append(b"\xff\xda" + struct.pack(">HB", 8, 1) + bytes([cid, 0x00, 0, 63, 0]) + data)
    jfif = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    sof = struct.pack(">BHHB", 8, h, w, 3) + b"".join(
        bytes([cid, (ch << 4) | cv, 0]) for cid, (ch, cv) in comps)
    sof = b"\xff\xc0" + struct.pack(">H", len(sof) + 2) + sof
    return b"\xff\xd8" + jfif + tables + sof + b"".join(scans) + b"\xff\xd9"


def drop_last_scans(data, n):
    """A progressive JPEG without its last n scans (EOI kept)."""
    sos = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    return data[:sos[-n]] + b"\xff\xd9"


SOF9_HEADER = b"\xff\xd8\xff\xc9\x00\x0b\x08\x00\x10\x00\x10\x01\x01\x11\x00\xff\xd9"


def refused_streams():
    """{name: (stream, exception type)} the decoder refuses."""
    base = cv2_jpeg(frame(40, 48), 90)
    prog = cv2_jpeg(frame(40, 48), 90, progressive=True)
    sof = base.index(b"\xff\xc0")
    bim = io.BytesIO()
    Image.new("CMYK", (16, 16), (10, 20, 30, 40)).save(bim, "JPEG")
    return {
        "arithmetic_sof9": (SOF9_HEADER, NotImplementedError),
        "lossless_sof3": (base[:sof] + b"\xff\xc3" + base[sof + 2:], NotImplementedError),
        "twelve_bit": (base[:sof + 4] + b"\x0c" + base[sof + 5:], NotImplementedError),
        "cmyk": (bim.getvalue(), NotImplementedError),
        "progressive_missing_refinements": (drop_last_scans(prog, 3), NotImplementedError),
        "truncated_half": (base[:len(base) // 2], ValueError),
        "truncated_no_eoi": (base[:-2], ValueError),
        "soi_only": (b"\xff\xd8", ValueError),
    }


# ------------------------------------------------------------------ PNG

def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filter_rows(rows, bpp, rng):
    """Filter each row with a random PNG filter type (0-4)."""
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for r in rows.astype(np.int32):
        left = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])[:len(r)]
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])[:len(r)]
        f = int(rng.randint(0, 5))
        if f == 0:
            e = r
        elif f == 1:
            e = r - left
        elif f == 2:
            e = r - prev
        elif f == 3:
            e = r - ((left + prev) >> 1)
        else:
            p = left + prev - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
            e = r - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
        out.append(bytes([f]) + (e & 255).astype(np.uint8).tobytes())
        prev = r
    return b"".join(out)


def _pack_rows(px, depth):
    h, w, c = px.shape
    if depth == 16:
        return px.astype(">u2").reshape(h, -1).view(np.uint8)
    if depth == 8:
        return px.astype(np.uint8).reshape(h, -1)
    bits = ((px[..., 0][..., None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(h, -1), axis=1)


CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def png(color, depth, interlace, h, w, seed=0, extra=b"", grey_rgb=False):
    """A PNG of colour type `color` at bit depth `depth` (Adam7 when
    `interlace`), random samples (RGB ones equal on some pixels when
    `grey_rgb`), random row filters, `extra` chunks before PLTE/IDAT."""
    rng = np.random.RandomState(seed)
    c = CHANNELS[color]
    hi = (1 << depth) - 1
    px = rng.randint(0, hi + 1, (h, w, c))
    if grey_rgb and color in (2, 6):
        px[::2, :, 1] = px[::2, :, 0]
        px[::2, :, 2] = px[::2, :, 0]
    bpp = max(1, depth * c // 8)
    if interlace:
        raw = b"".join(_filter_rows(_pack_rows(px[y0::dy, x0::dx], depth), bpp, rng)
                       for x0, y0, dx, dy in ADAM7 if w > x0 and h > y0)
    else:
        raw = _filter_rows(_pack_rows(px, depth), bpp, rng)
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                                              0, interlace))
    data += extra
    if color == 3:
        data += _chunk(b"PLTE", rng.randint(0, 256, (hi + 1, 3)).astype(np.uint8).tobytes())
    return data + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def gamma_chunk(gamma=45455):
    return _chunk(b"gAMA", struct.pack(">I", gamma))


def srgb_chunk():
    return _chunk(b"sRGB", b"\x00")


def exif_chunk(orientation):
    tiff = b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
    tiff += struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack("<I", 0)
    return _chunk(b"eXIf", tiff)


def pil_png(img, mode):
    """img (grey [h, w] or BGR [h, w, 3] uint8) saved by PIL in `mode`."""
    rgb = img if img.ndim == 2 else img[..., ::-1]
    if mode == "I;16":
        im = Image.fromarray((rgb.astype(np.uint16) * 257) if rgb.ndim == 2
                             else (rgb[..., 0].astype(np.uint16) * 257))
    else:
        im = Image.fromarray(rgb).convert(mode)
    bio = io.BytesIO()
    im.save(bio, "PNG")
    return bio.getvalue()
