"""Build the CUDA sources under `csrc/` with nvcc and load them by ctypes.

Each source is compiled on its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). The library's
name carries a hash of the source and the flags; it is written under a
temporary name and moved into place with `os.replace`, so concurrent
builds need no lock file and a cut-off build leaves nothing that blocks
the next one. Libraries go to `build/torch_kernels/` at the repository
root, which `.gitignore` lists.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").is_file():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(source: str) -> Path:
    """Where the library for `csrc/<source>` goes, keyed on its content."""
    h = hashlib.sha256(Path(CSRC, source).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}_{h.hexdigest()[:16]}.so"


def build(source: str) -> tuple[Path, str]:
    """Compile `csrc/<source>` unless its library exists. Returns the
    library path and nvcc's output (ptxas register and spill report), which
    is empty when nothing was built."""
    out = library_path(source)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(Path(CSRC, source))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def load(source: str) -> ctypes.CDLL:
    path, _ = build(source)
    return ctypes.CDLL(str(path))
