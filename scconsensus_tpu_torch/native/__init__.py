"""Native (C++) host kernels, ctypes-loaded: the Ward.D2 NN-chain.

``ward.cpp`` is the reference's source, byte for byte
(``scconsensus_tpu/native/ward.cpp``). It is compiled with ``g++`` at first
use into this directory, under a name keyed by a hash of the source, the
flags, the compiler and the CPU (``-march=native`` binaries must not be
loaded by another microarchitecture). Several processes may build at once
(the test suite runs under xdist): each compiles into a private temporary
file and moves it into place with ``os.replace``, and the thread lock
below only guards the loader within one process.

``ward_native`` raises on any build or load failure; ``ops.linkage`` falls
back to its numpy chain and records which engine ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
import time
from typing import Optional, Tuple

import numpy as np

__all__ = ["ward_native", "build"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "ward.cpp")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LOAD_ERROR: Optional[Exception] = None

_CFLAGS = ("-O3", "-march=native", "-funroll-loops", "-fopenmp", "-shared",
           "-fPIC", "-std=c++17")
_CFLAGS_FALLBACK = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17")


def _host_tag() -> str:
    try:
        cxx = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, check=True).stdout.splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        cxx = "g++-unknown"
    tag = cxx + "\x00" + platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags", "Features")):
                    tag += "\x00" + line.strip()
                    if line.startswith(("flags", "Features")):
                        break
    except OSError:
        tag += "\x00" + platform.processor()
    return tag


def _so_path(flags, tag: str) -> str:
    with open(_SRC, "rb") as f:
        src = f.read()
    key = hashlib.sha256(
        src + ("\x00".join(flags) + "\x00" + tag).encode()
    ).hexdigest()[:16]
    return os.path.join(_DIR, f"libscc_ward-{key}.so")


def build() -> Tuple[str, float]:
    """Compile ward.cpp if no build for this host exists yet. Returns
    (path of the .so, seconds spent compiling; 0.0 when already built).
    Tries ``-march=native`` first and generic flags second."""
    tag = _host_tag()
    for flags in (_CFLAGS, _CFLAGS_FALLBACK):
        if os.path.exists(_so_path(flags, tag)):
            return _so_path(flags, tag), 0.0
    t0 = time.perf_counter()
    first_err = None
    for flags in (_CFLAGS, _CFLAGS_FALLBACK):
        so = _so_path(flags, tag)
        tmp = f"{so}.tmp.{os.getpid()}.so"
        try:
            subprocess.run(["g++", *flags, _SRC, "-o", tmp], check=True,
                           capture_output=True, text=True)
            os.replace(tmp, so)
            return so, time.perf_counter() - t0
        except subprocess.CalledProcessError as e:
            first_err = first_err or e
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    raise RuntimeError(
        f"g++ failed to build {_SRC}:\n{first_err.stderr}"
    ) from first_err


def _load() -> ctypes.CDLL:
    global _LIB, _LOAD_ERROR
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _LOAD_ERROR is not None:
            raise _LOAD_ERROR
        try:
            lib = ctypes.CDLL(build()[0])
            fn = lib.scc_ward_nnchain
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_double),
            ]
            _LIB = lib
            return lib
        except (OSError, RuntimeError, FileNotFoundError) as e:
            _LOAD_ERROR = e
            raise


def ward_native(points: np.ndarray, weights: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Run the C++ NN-chain. Returns (raw_pairs (n-1, 2) slot ids,
    raw_h (n-1,)) in merge order — the numpy chain's raw output."""
    lib = _load()
    pts = np.ascontiguousarray(points, np.float64)
    w = np.ascontiguousarray(weights, np.float64)
    n, d = pts.shape
    pairs = np.zeros((n - 1, 2), np.int64)
    heights = np.zeros(n - 1, np.float64)
    rc = lib.scc_ward_nnchain(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(n),
        ctypes.c_int64(d),
        pairs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        heights.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        raise RuntimeError(f"scc_ward_nnchain failed with code {rc}")
    return pairs, heights
