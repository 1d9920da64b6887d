"""ctypes bindings of the native .npy loader and its prefetch pool.

Counterpart of `deepfepe_tpu/data/native_loader.py`. The C++ source,
`deepfepe_tpu_torch/native/npy_loader.cpp`, is built with g++ at first use
into `build/torch_native/` at the repository root (which `.gitignore`
lists), under a name that carries a hash of the source and the flags; the
library is written under a temporary name and moved into place with
`os.replace`, so concurrent builds need no lock. It exposes:

  - `load_npy(path)`             one file, synchronously;
  - `BatchPrefetcher.submit/get` batches of files on the native pool.

When the build fails (no g++), both read with `np.load`, as the JAX
package does; `native_available()` says which route is live, and callers
that need the native route (the card's smoke) check it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "native" / "npy_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
MAX_NDIM = 8


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"npy_loader_{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> Optional[ctypes.CDLL]:
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    meta = [ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_char)]
    lib.nl_init.argtypes = [ctypes.c_int]
    lib.nl_init.restype = None
    lib.nl_probe.argtypes = [ctypes.c_char_p]
    lib.nl_probe.restype = ctypes.c_int64
    lib.nl_load.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, *meta]
    lib.nl_load.restype = ctypes.c_int
    lib.nl_batch_submit.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int]
    lib.nl_batch_submit.restype = ctypes.c_int64
    lib.nl_batch_nbytes.argtypes = [ctypes.c_int64, ctypes.c_int]
    lib.nl_batch_nbytes.restype = ctypes.c_int64
    lib.nl_batch_get.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_int64, *meta]
    lib.nl_batch_get.restype = ctypes.c_int
    lib.nl_batch_free.argtypes = [ctypes.c_int64]
    lib.nl_batch_free.restype = None
    lib.nl_init(max((os.cpu_count() or 4) // 2, 2))
    return lib


def native_available() -> bool:
    """True when the C++ loader built and loaded (else reads use np.load)."""
    return _lib() is not None


def _read(nbytes: int, call, what: str) -> np.ndarray:
    """Run `call(buf, shape, ndim, itemsize, kind)` into a fresh buffer and
    view the bytes as the array the header describes."""
    if nbytes < 0:
        raise IOError(f"{what}: status {nbytes}")
    buf = np.empty(nbytes, np.uint8)
    shape = (ctypes.c_int64 * MAX_NDIM)()
    ndim, itemsize, kind = ctypes.c_int(), ctypes.c_int(), ctypes.c_char()
    st = call(buf.ctypes.data_as(ctypes.c_void_p), nbytes, shape, ctypes.byref(ndim),
              ctypes.byref(itemsize), ctypes.byref(kind))
    if st != 0:
        raise IOError(f"{what}: status {st}")
    dt = np.dtype(f"{kind.value.decode()}{itemsize.value}")
    return buf.view(dt).reshape(tuple(shape[i] for i in range(ndim.value)))


def load_npy(path: str) -> np.ndarray:
    """One .npy file through the native parser (np.load without it)."""
    lib = _lib()
    if lib is None:
        return np.load(path)
    p = str(path).encode()
    return _read(lib.nl_probe(p), lambda *a: lib.nl_load(p, *a), f"nl_load({path})")


class BatchPrefetcher:
    """Batched loads on the native thread pool: `submit(paths)` returns a
    token at once, `get(token)` waits and returns the arrays in order."""

    def __init__(self):
        self.lib = _lib()

    def submit(self, paths: List[str]) -> object:
        if self.lib is None:
            return [np.load(p) for p in paths]
        arr = (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])
        return self.lib.nl_batch_submit(arr, len(paths)), len(paths)

    def get(self, token) -> List[np.ndarray]:
        if self.lib is None:
            return token
        handle, n = token
        lib = self.lib
        try:
            return [_read(lib.nl_batch_nbytes(handle, i),
                          lambda *a, i=i: lib.nl_batch_get(handle, i, *a), f"batch item {i}")
                    for i in range(n)]
        finally:
            lib.nl_batch_free(handle)
