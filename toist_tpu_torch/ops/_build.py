"""Build and load the CUDA kernels under ``toist_tpu_torch/csrc``.

Each ``.cu`` file is compiled on first use with ``nvcc`` into a shared
library that exposes a plain C interface, and loaded with ``ctypes``. The
library goes to ``build/kernels/`` at the repository root, named after a hash
of its source, of the shared headers (``csrc/*.cuh``) and of the compiler
flags, so an edited source is rebuilt and an unchanged one is reused.
``load_libraries`` starts one ``nvcc`` per missing library, all at once,
and keeps what ptxas reports of each kernel's registers, shared memory and
spills (``-Xptxas -v``) in ``BUILD_LOG``.
Nothing here runs at import time: the CPU-only test machines have no
``nvcc``.
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
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# Seconds each library took to build in this process (0.0 when it was reused
# from build/kernels); chip_smoke.py reports them.
BUILD_SECONDS: Dict[str, float] = {}
# The compiler's report of each library built in this process (ptxas -v).
BUILD_LOG: Dict[str, str] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of toist_tpu_torch are built at first use")


def _so_path(source: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for name in [source] + headers:
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def load_libraries(sources: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and load ``csrc/<source>`` for each source; the
    missing ones compile in parallel. Cached per process."""
    with _LOCK:
        todo = [s for s in sources if s not in _LIBS]
        paths = {s: _so_path(s) for s in todo}
        t0 = time.perf_counter()
        jobs = []
        for source in todo:
            if os.path.exists(paths[source]):
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, source)]
            jobs.append((source, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for source, tmp, cmd, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"nvcc failed for {source}:\n{' '.join(cmd)}"
                              f"\n{err}")
            else:
                BUILD_LOG[source] = err
                os.replace(tmp, paths[source])   # atomic: concurrent builds
                                                 # agree
        if failed:
            raise RuntimeError("\n".join(failed))
        built = {source for source, *_ in jobs}
        for source in todo:
            BUILD_SECONDS[source] = (time.perf_counter() - t0
                                     if source in built else 0.0)
            _LIBS[source] = ctypes.CDLL(paths[source])
        return {s: _LIBS[s] for s in sources}


def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``; cached per process."""
    return load_libraries([source])[source]
