"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

The sources have a plain C interface (no PyTorch headers), so ``nvcc``
compiles them in seconds; ``torch.utils.cpp_extension.load`` would spend
minutes on PyTorch's headers. One ``nvcc`` per source runs at the same
time, then one more links the objects. The shared library lands in
``_build/`` beside the package, named by a hash of the sources and flags,
so an edited source rebuilds and an unchanged one loads at once; processes
that start together build under a file lock, once. Nothing is built or
loaded at import time: the first kernel launch calls ``load_library``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_SIGNATURES = {
    # codes, keys, valid, n, k, canonical, stream
    "gt4_extract": [_P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int, _P],
    # keys, weights, out (run keys, counts, stats, status), n, limit,
    # has limit, device, stream
    "gt4_run_encode": [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, _P],
    # kernel B's keys per tile (one status word each)
    "gt4_run_encode_tile": [],
    # refs, reads, nvec, score, sx, sy, scratch, B, n, m, stream
    "gt4_sw_lanes": [_P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, _P],
    # ref, reads, score, sx, sy, scratch, B, n, m, stream
    "gt4_sw_shared": [_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, _P],
    # kernels C and D's scratch bytes per read for (n, m)
    "gt4_sw_scratch": [ctypes.c_int, ctypes.c_int],
    # keys, out, pos, splits, n, run length, stream
    "gt4_merge_runs": [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                       _P],
    # kernel E's output slots per tile (one splits word each)
    "gt4_merge_runs_tile": [],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    # last: the CUDA toolkit's default install prefix
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[str]:
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {CSRC_DIR}")
    return srcs


def library_path() -> str:
    """Path of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libgt4kernels_{h.hexdigest()[:16]}.so")


def build() -> tuple[str, str]:
    """Compile the sources unless the library for them exists.

    Returns (library path, nvcc's report: ptxas register and shared-memory
    use per kernel; empty when nothing was compiled). Raises RuntimeError
    when nvcc fails.
    """
    path = library_path()
    if os.path.exists(path):
        return path, ""
    import fcntl
    os.makedirs(BUILD_DIR, exist_ok=True)
    # processes that start together (a process group on one host) build
    # once: the others wait here, then load the published library
    with open(os.path.join(BUILD_DIR, "libgt4kernels.lock"), "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        if os.path.exists(path):
            return path, ""
        return path, _compile(path)


def _compile(path: str) -> str:
    """nvcc's objects, one per source at once, linked into ``path``;
    returns nvcc's report."""
    nvcc = _nvcc()
    stem = f"{path[:-3]}.{os.getpid()}"
    jobs = []
    for src in _sources():
        obj = f"{stem}.{os.path.basename(src)}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    report, failed = [], []
    for src, obj, proc in jobs:
        out = proc.communicate()[0]
        report.append(out)
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)} ({proc.returncode}):\n"
                          f"{out}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = f"{stem}.so"
        r = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stderr}")
        os.replace(tmp, path)  # atomic: no process loads a half-written file
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return "".join(report)


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare every signature."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build()[0])
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.gt4_error_string.argtypes = [ctypes.c_int]
            lib.gt4_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check_launch(lib: ctypes.CDLL, err: int, kernel: str) -> None:
    """Raise when a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize does not report it)."""
    if err:
        msg = lib.gt4_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({err})")
