"""Hand-written CUDA kernels for Hopper, built with nvcc and bound with ctypes.

The counterpart of ``scconsensus_tpu/ops/pallas_kernels.py``. One kernel so
far: ``distance_cluster_sums`` (source ``csrc/distance_cluster_sums.cu``),
S[i, k] = Σ_j ‖x_i − x_j‖ · onehot[j, k], the silhouette stage's one pass
over the N² cell pairs. The one-hot has one 1 per cell and cut, so the
kernel takes those cluster ids, (N, C) int32, and not the (N, K) one-hot.

The source compiles at first use, never at import, into ``_build/`` beside
the package (listed in ``.gitignore``), under a name keyed by a hash of the
source and the flags: ``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC`` into a shared library with a plain C interface.
Several processes may build at once, so each writes a private temporary
file and moves it into place with ``os.replace``.

Beside the kernel sits its plain PyTorch version,
``distance_cluster_sums_reference``. The wrapper takes it for a tensor on
the CPU, and only there: for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional, Tuple

import torch

__all__ = [
    "distance_cluster_sums",
    "distance_cluster_sums_reference",
    "labels_onehot",
    "build",
]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG, "csrc", "distance_cluster_sums.cu")
_REF_BLOCK = 4096  # rows per slab of the plain version (the reference's)
_BUILD_DIR = os.path.join(_PKG, "_build")
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build from source at first use "
        "and need the CUDA toolkit (nvcc on PATH or under CUDA_HOME)"
    )


def _so_path() -> str:
    with open(_SOURCE, "rb") as f:
        key = hashlib.sha256(
            f.read() + "\x00".join(_NVCC_FLAGS).encode()
        ).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libscc_cuda-{key}.so")


def build() -> Tuple[str, float, str]:
    """Compile the kernel library if it is not built yet.

    Returns (path of the .so, seconds spent compiling (0.0 when it was
    already built), the compiler's output — ptxas's register and shared
    memory report for each kernel)."""
    so = _so_path()
    if os.path.exists(so):
        return so, 0.0, ""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}.so"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *_NVCC_FLAGS, _SOURCE, "-o", tmp],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {_SOURCE}:\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so, time.perf_counter() - t0, proc.stdout + proc.stderr


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build()[0])
            fn = lib.scc_distance_cluster_sums
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p,
            ]
            _LIB = lib
        return _LIB


def labels_onehot(labels: torch.Tensor, k: int) -> torch.Tensor:
    """The (N, K) float32 one-hot of (N, C) cluster ids: row j holds a 1 in
    column labels[j, c] for every cut c whose id lies in [0, K)."""
    n, c = labels.shape
    onehot = torch.zeros((n, k), dtype=torch.float32, device=labels.device)
    lab = labels.long()
    keep = (lab >= 0) & (lab < k)
    rows = torch.arange(n, device=labels.device)[:, None].expand(n, c)
    onehot.index_put_((rows[keep], lab[keep]),
                      torch.ones((), device=labels.device), accumulate=True)
    return onehot


def distance_cluster_sums_reference(x: torch.Tensor, labels: torch.Tensor,
                                    k: int) -> torch.Tensor:
    """Plain PyTorch version: the reference's blocked XLA form,
    ``sqrt(max(a² + b²ᵀ − 2·a@bᵀ, 0)) @ onehot`` over 4096-row slabs
    (``scconsensus_tpu/ops/pallas_kernels.py:168-195``,
    ``ops/distance.py:29-38``), with the one-hot built from the ids."""
    onehot = labels_onehot(labels, k)
    b2 = torch.sum(x * x, dim=1, keepdim=True)
    parts = []
    for s in range(0, x.shape[0], _REF_BLOCK):
        xb = x[s:s + _REF_BLOCK]
        a2 = torch.sum(xb * xb, dim=1, keepdim=True)
        d2 = torch.clamp(a2 + b2.T - 2.0 * (xb @ x.T), min=0.0)
        parts.append(torch.sqrt(d2) @ onehot)
    if not parts:
        return torch.zeros((0, k), dtype=x.dtype, device=x.device)
    return torch.cat(parts, dim=0)


def _check(x: torch.Tensor, labels: torch.Tensor, k: int) -> None:
    for name, t, dtype in (("x", x, torch.float32),
                           ("labels", labels, torch.int32)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.shape[0] != labels.shape[0]:
        raise ValueError(
            f"x has {x.shape[0]} rows but labels has {labels.shape[0]}"
        )
    if x.device != labels.device:
        raise ValueError(f"x on {x.device} but labels on {labels.device}")
    if not isinstance(k, int) or k < 0:
        raise ValueError(f"k must be a non-negative int, got {k!r}")


def distance_cluster_sums(x: torch.Tensor, labels: torch.Tensor, k: int
                          ) -> torch.Tensor:
    """(N, K) S[i, k] = Σ ‖x_i − x_j‖ over the (j, c) with
    labels[j, c] == k, for x (N, d) contiguous float32 and labels (N, C)
    contiguous int32 on one device: C labelings of the same cells (the
    deepSplit cuts), their ids in disjoint ranges of [0, K); an id outside
    [0, K) is no cluster. Equal to dist(x, x) @ onehot for the one-hot of
    the ids (``labels_onehot``).

    On a CUDA tensor: launches the hand-written kernel on the current
    stream (and counts it in ``distance_cluster_sums.launches``), or
    raises. On a CPU tensor: the plain version."""
    _check(x, labels, k)
    if x.device.type == "cpu":
        return distance_cluster_sums_reference(x, labels, k)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, d = x.shape
    c = labels.shape[1]
    out = torch.empty((n, k), dtype=torch.float32, device=x.device)
    if n == 0 or k == 0:
        return out
    if d == 0 or c == 0:
        return out.zero_()
    lib = _load()
    with torch.cuda.device(x.device):
        rc = lib.scc_distance_cluster_sums(
            x.data_ptr(), labels.data_ptr(), out.data_ptr(), n, d, c, k,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"distance_cluster_sums kernel launch failed: CUDA error {rc} "
            f"(N={n}, d={d}, C={c}, K={k})"
        )
    distance_cluster_sums.launches += 1
    return out


distance_cluster_sums.launches = 0
