"""Build a C++ source under `native/` with g++ into a shared library.

The library goes to `build/torch_native/` at the repository root (which
`.gitignore` lists) under a name that carries a hash of the source and the
flags; it is written under a temporary name and moved into place with
`os.replace`, so concurrent builds need no lock file. A failed build raises
with g++'s message: nothing falls back to another implementation.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

NATIVE = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]


def library_path(source: str) -> Path:
    """Where the library of `native/<source>` goes, keyed on its content."""
    h = hashlib.sha256(Path(NATIVE, source).read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}_{h.hexdigest()[:16]}.so"


def build(source: str) -> Path:
    """Compile `native/<source>` unless its library exists."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    src = Path(NATIVE, source)
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(src), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ could not build {source}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {source}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out
