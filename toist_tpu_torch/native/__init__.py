"""ctypes loader for the toist_native C++ library, building it on demand.

The port's own copy of ``toist_tpu/native`` (the C++ source and its unicode
tables are the same files). The library exposes a C ABI consumed here via
ctypes. It is built with ``g++`` at first use into ``build/native/`` at the
repository root (beside the CUDA kernels' ``build/kernels/``), named after a
hash of its sources and flags, so an edited source is rebuilt and an
unchanged one is reused. The build writes a temporary file and renames it
into place under an exclusive ``fcntl.flock`` on ``build/native/lock``:
parallel processes (pytest workers, data-loader workers) build it once and
never load a half-written library.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "toist_native.cc")
_PKG = os.path.dirname(_HERE)
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIB = None


def _so_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    sources = [_SRC] + sorted(os.path.join(_HERE, f) for f in os.listdir(_HERE)
                              if f.endswith(".inc"))
    for path in sources:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libtoist_native-{digest.hexdigest()[:16]}.so")


def _build(so_path: str) -> None:
    """Compile into a temporary file beside ``so_path``, then rename it into
    place; the caller holds the directory's lock."""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, _SRC, "-o", tmp], check=True,
                       capture_output=True)
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> ctypes.CDLL:
    """Load (building if missing) the native library and declare signatures."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so_path = _so_path()
        if not os.path.exists(so_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            with open(os.path.join(BUILD_DIR, "lock"), "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not os.path.exists(so_path):   # another process built it
                    _build(so_path)
        lib = ctypes.CDLL(so_path)

        u32p = ctypes.POINTER(ctypes.c_uint32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f64p = ctypes.POINTER(ctypes.c_double)

        lib.lsa_solve.restype = ctypes.c_int
        lib.lsa_solve.argtypes = [f64p, ctypes.c_int, ctypes.c_int, i32p]

        lib.rle_encode.restype = ctypes.c_int
        lib.rle_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u32p]
        lib.rle_encode_packed_cm.restype = ctypes.c_int
        lib.rle_encode_packed_cm.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                             ctypes.c_int, u32p]
        lib.rle_decode.restype = None
        lib.rle_decode.argtypes = [u32p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, u8p]
        lib.rle_area.restype = ctypes.c_uint64
        lib.rle_area.argtypes = [u32p, ctypes.c_int]
        lib.rle_iou.restype = ctypes.c_double
        lib.rle_iou.argtypes = [u32p, ctypes.c_int, u32p, ctypes.c_int,
                                ctypes.c_int]
        lib.rle_merge.restype = ctypes.c_int
        lib.rle_merge.argtypes = [u32p, ctypes.c_int, u32p, ctypes.c_int,
                                  ctypes.c_int, u32p]
        lib.rle_to_string.restype = ctypes.c_int
        lib.rle_to_string.argtypes = [u32p, ctypes.c_int, ctypes.c_char_p]
        lib.rle_from_string.restype = ctypes.c_int
        lib.rle_from_string.argtypes = [ctypes.c_char_p, u32p, ctypes.c_int]

        lib.poly_to_mask.restype = None
        lib.poly_to_mask.argtypes = [f64p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, u8p]

        lib.coco_match.restype = None
        lib.coco_match.argtypes = [f64p, ctypes.c_int, ctypes.c_int, u8p, u8p,
                                   f64p, ctypes.c_int, i32p, u8p, i32p]

        lib.bpe_create.restype = ctypes.c_int
        lib.bpe_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.c_int]
        lib.bpe_free.restype = None
        lib.bpe_free.argtypes = [ctypes.c_int]
        lib.bpe_encode.restype = ctypes.c_int
        lib.bpe_encode.argtypes = [ctypes.c_int, ctypes.c_char_p, i32p, i32p,
                                   i32p, ctypes.c_int]

        _LIB = lib
        return _LIB
