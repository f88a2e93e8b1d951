"""Build at first use, and bind with ctypes, the native point_io parser.

`g++ -O3 -shared -fPIC` compiles point_io.cpp into
opensplat_tpu_torch/_build/native-<hash of the source>/, as
ops/kernels/_lib.py builds the CUDA kernels: never into the source tree,
and an edited source rebuilds. Without a working g++ `get_lib` returns
None and the callers parse with numpy (host file parsing, not a device
path).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).resolve().parent / "point_io.cpp"
_BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def lib_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    return _BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / "libpoint_io.so"


def _build(path: Path) -> bool:
    path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=path.parent) as tmp:
        out = Path(tmp) / path.name
        try:
            subprocess.run(["g++", *_FLAGS, "-o", str(out), str(_SRC)],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return False
        os.replace(out, path)  # atomic: concurrent builders agree
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first call; None without g++."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        path = lib_path()
        if not path.exists() and not _build(path):
            _failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _failed = True
            return None
        lib.colmap_points3d_count.restype = ctypes.c_int64
        lib.colmap_points3d_count.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.colmap_points3d_parse.restype = ctypes.c_int64
        lib.colmap_points3d_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ]
        _lib = lib
        return _lib
