"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each source under ``csrc/`` becomes one shared library with a plain C
interface, compiled for Hopper (``sm_90a``) at first use into ``_build/``
beside this file (listed in .gitignore).  The library's name carries a hash
of the source and the flags, so an edited source is rebuilt and a current
one is loaded as it is.  A build failure raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # each float op rounds on its own: no FMA contraction (bit-exact twins)
    "-fmad=false",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}   # wall time of each build this process ran


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "multiposenet_tpu_torch are built on a machine with "
                       "the CUDA toolkit")


def library_path(source: str) -> Path:
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless a current library exists; return its
    path.  Safe to run for several sources at once (one nvcc each)."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                           str(CSRC_DIR / source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    build_seconds[source] = time.perf_counter() - t0
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    lib = _LIBS.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)))
        _LIBS[source] = lib
    return lib
