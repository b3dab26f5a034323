"""Build and load the CUDA kernels under ``toist_tpu_torch/csrc``.

Each ``.cu`` file is compiled on first use with ``nvcc`` into a shared
library that exposes a plain C interface, and loaded with ``ctypes``. The
library goes to ``build/kernels/`` at the repository root, named after a hash
of its source and of the compiler flags, so an edited source is rebuilt and an
unchanged one is reused. Nothing here runs at import time: the CPU-only test
machines have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# Seconds each library took to build in this process (0.0 when it was reused
# from build/kernels); chip_smoke.py reports them.
BUILD_SECONDS: Dict[str, float] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of toist_tpu_torch are built at first use")


def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``; cached per process."""
    with _LOCK:
        if source in _LIBS:
            return _LIBS[source]
        src_path = os.path.join(CSRC, source)
        with open(src_path, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
        stem = os.path.splitext(source)[0]
        so_path = os.path.join(BUILD_DIR,
                               f"{stem}-{digest.hexdigest()[:16]}.so")
        t0 = time.perf_counter()
        if not os.path.exists(so_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src_path]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed for {source}:\n"
                                   f"{' '.join(cmd)}\n{proc.stderr}")
            os.replace(tmp, so_path)   # atomic: concurrent builds agree
        BUILD_SECONDS[source] = time.perf_counter() - t0
        lib = ctypes.CDLL(so_path)
        _LIBS[source] = lib
        return lib
