"""Build the package's CUDA sources into shared libraries at first use.

Each source under csrc/ is compiled by nvcc into a shared library with a
plain C interface (no PyTorch headers: seconds instead of minutes) and
loaded with ctypes. Libraries are cached in build/torch_kernels/ under a
hash of the source, every shared header (csrc/*.cuh) and the flags, so a
changed source or header rebuilds and an unchanged one loads at once. `build_all` starts one nvcc per source, all at
the same time.
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
BUILD_LOG: dict = {}  # source -> (seconds, nvcc's stderr: ptxas register report)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(source: str) -> str:
    h = hashlib.sha256(repr(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for name in (source, *headers):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    digest = h.hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


def _start(source: str):
    """Start nvcc for `source` unless its library exists; returns
    (lib_path, process or None, start time)."""
    path = _lib_path(source)
    if os.path.exists(path):
        return path, None, time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return path, (proc, tmp), time.perf_counter()


def _finish(source: str, path: str, job, t0: float):
    if job is not None:
        proc, tmp = job
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{out}\n{err}")
        os.replace(tmp, path)
        BUILD_LOG[source] = (time.perf_counter() - t0, err)
    return ctypes.CDLL(path)


def build_all() -> dict:
    """Build (or load) every source at once; returns {source: CDLL}."""
    with _lock:
        todo = [s for s in SOURCES if s not in _libs]
        started = [(s, *_start(s)) for s in todo]
        for source, path, job, t0 in started:
            _libs[source] = _finish(source, path, job, t0)
        return dict(_libs)


def load(source: str) -> ctypes.CDLL:
    """The library built from csrc/`source`, building it on first use."""
    lib = _libs.get(source)
    if lib is None:
        lib = build_all()[source]
    return lib
