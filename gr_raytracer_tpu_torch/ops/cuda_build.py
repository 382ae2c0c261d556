"""Build the package's CUDA sources into shared libraries at first use.

Each source under csrc/ is compiled by nvcc into a shared library with a
plain C interface (no PyTorch headers: seconds instead of minutes) and
loaded with ctypes. Libraries are cached in build/torch_kernels/ under a
hash of the source, every shared header (csrc/*.cuh) and the flags, so a
changed source or header rebuilds and an unchanged one loads at once.
`build_all` starts one nvcc per source, all at the same time.

Every path of the port loads the libraries built with NVCC_FLAGS.
`load(source, flags)` with another flag set builds that source alone into
a subdirectory of its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
# No --use_fast_math: it changes rsqrt, division and denormals in f32.
# -fmad=false: no contraction of a*b+c into one FMA, so a kernel rounds
# exactly like its plain torch version (separate elementwise ops) and the
# two can be held to each other bit for bit on the card.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = (
    "kerr_rk4_march.cu", "kerr_ks_adjoint.cu", "kerr_bl_march.cu", "kerr_bl_adjoint.cu",
    "vol_raymarch.cu", "vol_adjoint.cu",
)

_lock = threading.Lock()
_libs: dict = {}
# source (prefixed "<subdirectory>/" for another flag set) -> (seconds of nvcc,
# None where the library was cached; nvcc's stderr: the ptxas register report,
# kept beside the library as <library>.log)
BUILD_LOG: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _build_dir(flags) -> str:
    if flags == NVCC_FLAGS:
        return BUILD_DIR
    return os.path.join(BUILD_DIR, "flags-" + hashlib.sha256(repr(flags).encode()).hexdigest()[:8])


def _log_key(source: str, flags) -> str:
    return source if flags == NVCC_FLAGS else f"{os.path.basename(_build_dir(flags))}/{source}"


def _lib_path(source: str, flags) -> str:
    h = hashlib.sha256(repr(flags).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for name in (source, *headers):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    digest = h.hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(_build_dir(flags), f"lib{stem}-{digest}.so")


def _start(source: str, flags):
    """Start nvcc for `source` unless its library exists; returns
    (lib_path, process or None, start time)."""
    path = _lib_path(source, flags)
    if os.path.exists(path):
        return path, None, time.perf_counter()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *flags, "-o", tmp, os.path.join(CSRC_DIR, source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return path, (proc, tmp), time.perf_counter()


def _finish(source: str, flags, path: str, job, t0: float):
    if job is None:
        if os.path.exists(path + ".log"):
            with open(path + ".log") as f:
                BUILD_LOG[_log_key(source, flags)] = (None, f.read())
    else:
        proc, tmp = job
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{out}\n{err}")
        with open(tmp + ".log", "w") as f:
            f.write(err)
        os.replace(tmp + ".log", path + ".log")
        os.replace(tmp, path)
        BUILD_LOG[_log_key(source, flags)] = (time.perf_counter() - t0, err)
    return ctypes.CDLL(path)


def _build(sources, flags) -> dict:
    with _lock:
        todo = [s for s in sources if (s, flags) not in _libs]
        started = [(s, *_start(s, flags)) for s in todo]
        for source, path, job, t0 in started:
            _libs[(source, flags)] = _finish(source, flags, path, job, t0)
        return {s: _libs[(s, flags)] for s in sources}


def build_all() -> dict:
    """Build (or load) every source at once; returns {source: CDLL}."""
    return _build(SOURCES, NVCC_FLAGS)


def load(source: str, flags=NVCC_FLAGS) -> ctypes.CDLL:
    """The library built from csrc/`source` with `flags`, building it on
    first use (with the default flags, every source at once)."""
    lib = _libs.get((source, flags))
    if lib is None:
        lib = _build(SOURCES if flags == NVCC_FLAGS else (source,), flags)[source]
    return lib
