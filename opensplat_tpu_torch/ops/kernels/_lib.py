"""Build and load the port's CUDA kernels (csrc/*.cu).

The sources compile with nvcc for sm_90a into one shared library with a
plain C interface, loaded with ctypes. The build runs at first use, one
nvcc per source in parallel and a final link, into
opensplat_tpu_torch/_build/<hash of the sources>/ — so a fresh checkout
builds what it holds and an edited source rebuilds. A missing nvcc or a
failed build raises; there is no fallback.

Launch protocol: every C entry takes raw device pointers and the current
PyTorch stream as void*, launches without synchronising and returns
cudaGetLastError(); `check` raises on a non-zero code.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("errors.cu", "expand.cu", "raster_fwd.cu", "raster_bwd.cu",
           "segsum.cu", "raster_fwd_variants.cu", "ssim.cu")
HEADERS = ("common.cuh",)
LIB_NAME = "libopensplat_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
    # each float op rounds on its own, as in the plain versions (see
    # csrc/common.cuh)
    "--fmad=false",
)

_lib = None
build_log = ""  # nvcc's -Xptxas -v report of the last build
build_seconds = 0.0


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "opensplat_tpu_torch: nvcc not found (PATH, $CUDA_HOME/bin, "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built"
    )


def build() -> Path:
    """Compile csrc/ into the hashed build directory (no-op when built)."""
    global build_log, build_seconds
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-c",
                   str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for name, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"--- {name}\n{out}")
            if p.returncode != 0:
                raise RuntimeError(
                    f"opensplat_tpu_torch: nvcc failed on {name}:\n{out}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(
                f"opensplat_tpu_torch: kernel link failed:\n{link.stdout}")
        out_dir.mkdir(parents=True, exist_ok=True)
        os.replace(tmp_lib, lib_path)
    build_log = "\n".join(logs)
    build_seconds = time.perf_counter() - t0
    return lib_path


_SIGNATURES = {
    "osk_error_string": ([ctypes.c_int], ctypes.c_char_p),
    "osk_expand": ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4,
                   ctypes.c_int),
    "osk_raster_fwd": ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4,
                       ctypes.c_int),
    "osk_raster_bwd": ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 13
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2,
                       ctypes.c_int),
    "osk_raster_bwd_info": ([ctypes.c_void_p], ctypes.c_int),
    "osk_raster_fwd_info": ([ctypes.c_void_p], ctypes.c_int),
    "osk_expand_info": ([ctypes.c_void_p], ctypes.c_int),
    "osk_kbench_fwd_info": ([ctypes.c_void_p], ctypes.c_int),
    "osk_segsum": ([ctypes.c_int] + [ctypes.c_void_p] * 5, ctypes.c_int),
    "osk_kbench_fwd": ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                       + [ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] + [ctypes.c_void_p] * 3,
                       ctypes.c_int),
    "osk_ssim_fwd": ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6,
                     ctypes.c_int),
    "osk_ssim_bwd": ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                     + [ctypes.c_float] + [ctypes.c_void_p] * 2,
                     ctypes.c_int),
    "osk_ssim_info": ([ctypes.c_void_p], ctypes.c_int),
}


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = res
        _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call C entry `name` with pointer/int args plus the current stream;
    raise on a launch error."""
    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, name)(*args, ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.osk_error_string(err).decode()
        raise RuntimeError(f"opensplat_tpu_torch: {name} failed: {msg} ({err})")


def kernel_info(entry: str, keys: tuple, *args) -> dict:
    """What C entry `entry` reports of its kernel's build (from the CUDA
    runtime) when called with `args`, one int per key."""
    out = (ctypes.c_int * len(keys))()
    err = getattr(library(), entry)(*args, ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"opensplat_tpu_torch: {entry} failed ({err})")
    return dict(zip(keys, out))


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """What a kernel takes: a contiguous CUDA tensor of `dtype` (and
    `shape`, where -1 matches any extent)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and (
        len(shape) != t.dim()
        or any(s not in (-1, d) for s, d in zip(shape, t.shape))
    ):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")


class _KernelTimes:
    """CUDA-event timing of kernel launches, off unless `enabled`."""

    def __init__(self):
        self.enabled = False
        self.events: dict = {}

    def reset(self):
        self.events = {}

    def millis(self) -> dict:
        """{name: [ms per launch]}; synchronises."""
        torch.cuda.synchronize()
        return {k: [s.elapsed_time(e) for s, e in v]
                for k, v in self.events.items()}


TIMES = _KernelTimes()


@contextlib.contextmanager
def timed(name: str):
    if not TIMES.enabled:
        yield
        return
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    yield
    e.record()
    TIMES.events.setdefault(name, []).append((s, e))
