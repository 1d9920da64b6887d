"""First-party TensorBoard event-file writer (no TF/tensorboardX dependency).

The reference's primary observability sink is TensorBoard via tensorboardX
(`Train_model_pipeline.py:742-1035`, `train_good_utils.py:758-856`,
`README.md:244-247` — SURVEY.md §5.5): per-iter scalars, per-layer loss
scalars, weight/residual histograms, and weight-heatmap images. Our trainer
logs JSONL for machine consumption; this module restores the `tensorboard
--logdir` workflow by writing the tfevents wire format directly:

- TFRecord framing: u64 length | masked-crc32c(length) | payload |
  masked-crc32c(payload), crc32c = Castagnoli, mask = rot15 + 0xa282ead8.
- Hand-encoded `tensorflow.Event` / `Summary` protobufs (scalar
  `simple_value`, `HistogramProto`, PNG-encoded `Summary.Image`).

Verified round-trip against the installed tensorboard event loader in
tests/test_tb_writer.py.

A copy of `deepfepe_tpu/utils/tb_writer.py` (it imports nothing of JAX).
"""

from __future__ import annotations

import os
import socket
import struct
import time
import zlib
from typing import Optional, Sequence

import numpy as np

# ---------------------------------------------------------------- crc32c ---

_CRC_TABLE = []
_POLY = 0x82F63B78  # reflected Castagnoli polynomial


def _build_table():
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_build_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------- protobuf encoding ---


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_varint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _f_str(field: int, v: str) -> bytes:
    return _f_bytes(field, v.encode("utf-8"))


# --------------------------------------------------------------- messages ---


def _scalar_value(tag: str, value: float) -> bytes:
    # Summary.Value{tag=1, simple_value=2}
    return _f_str(1, tag) + _f_float(2, float(value))


def _histogram_value(tag: str, values: np.ndarray, bins: int = 30) -> bytes:
    """Summary.Value{tag=1, histo=5} with HistogramProto
    {min=1,max=2,num=3,sum=4,sum_squares=5,bucket_limit=6,bucket=7}."""
    v = np.asarray(values, np.float64).ravel()
    v = v[np.isfinite(v)]
    if v.size == 0:
        v = np.zeros((1,), np.float64)
    counts, edges = np.histogram(v, bins=bins)
    h = _f_double(1, float(v.min())) + _f_double(2, float(v.max()))
    h += _f_double(3, float(v.size)) + _f_double(4, float(v.sum()))
    h += _f_double(5, float(np.square(v).sum()))
    # bucket_limit = right edges (packed doubles); bucket = counts.
    limits = edges[1:]
    h += _f_bytes(6, struct.pack(f"<{limits.size}d", *limits))
    h += _f_bytes(7, struct.pack(f"<{counts.size}d", *map(float, counts)))
    return _f_str(1, tag) + _f_bytes(5, h)


def encode_png(img: np.ndarray) -> bytes:
    """Minimal PNG encoder (8-bit grayscale/RGB/RGBA), zlib-compressed,
    filter 0 scanlines. Pure stdlib — keeps the writer dependency-free."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = np.clip(a, 0.0, 1.0) if a.dtype.kind == "f" else a
        a = (a * 255.0 + 0.5).astype(np.uint8) if a.dtype.kind == "f" else a.astype(np.uint8)
    if a.ndim == 2:
        a = a[:, :, None]
    h, w, c = a.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]

    def chunk(typ: bytes, data: bytes) -> bytes:
        raw = typ + data
        return struct.pack(">I", len(data)) + raw + struct.pack(
            ">I", zlib.crc32(raw) & 0xFFFFFFFF
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    scanlines = b"".join(b"\x00" + a[r].tobytes() for r in range(h))
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(scanlines, 6))
        + chunk(b"IEND", b"")
    )


def _image_value(tag: str, img: np.ndarray) -> bytes:
    a = np.asarray(img)
    h, w = a.shape[:2]
    c = 1 if a.ndim == 2 else a.shape[2]
    # Summary.Image{height=1,width=2,colorspace=3,encoded_image_string=4}
    im = (
        _f_varint(1, h)
        + _f_varint(2, w)
        + _f_varint(3, c)
        + _f_bytes(4, encode_png(a))
    )
    return _f_str(1, tag) + _f_bytes(4, im)


def _event(step: int, summary_value: Optional[bytes], wall_time: float,
           file_version: Optional[str] = None) -> bytes:
    # Event{wall_time=1, step=2, file_version=3, summary=5}
    e = _f_double(1, wall_time) + _f_varint(2, step)
    if file_version is not None:
        e += _f_str(3, file_version)
    if summary_value is not None:
        e += _f_bytes(5, _f_bytes(1, summary_value))  # Summary{value=1}
    return e


# ----------------------------------------------------------------- writer ---


class TBWriter:
    """Append-only tfevents writer: `add_scalar`, `add_histogram`,
    `add_image` (the tensorboardX subset the reference uses)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        host = socket.gethostname()
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(time.time())}.{host}"
        )
        self._f = open(self.path, "ab")
        self._write(_event(0, None, time.time(), file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        length = struct.pack("<Q", len(payload))
        self._f.write(length)
        self._f.write(struct.pack("<I", _masked_crc(length)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(step, _scalar_value(tag, value), time.time()))

    def add_histogram(
        self, tag: str, values, step: int, bins: int = 30
    ) -> None:
        self._write(
            _event(step, _histogram_value(tag, np.asarray(values), bins), time.time())
        )

    def add_image(self, tag: str, img, step: int) -> None:
        """img: [H,W], [H,W,3] or [H,W,4]; uint8 or float in [0,1]."""
        self._write(_event(step, _image_value(tag, np.asarray(img)), time.time()))

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
