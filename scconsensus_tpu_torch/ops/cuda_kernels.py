"""Hand-written CUDA kernels for Hopper, built with nvcc and bound with ctypes.

The counterpart of ``scconsensus_tpu/ops/pallas_kernels.py``. One kernel so
far: ``distance_cluster_sums`` (source ``csrc/distance_cluster_sums.cu``),
S[i, k] = Σ_j ‖x_i − x_j‖ · onehot[j, k], the silhouette stage's one pass
over the N² cell pairs. The one-hot has one 1 per cell and cut, so the
kernel takes those cluster ids, (N, C) int32, and not the (N, K) one-hot.

On the card the wrapper first puts the cells in cluster order
(``_cell_order``), so that the kernel keeps one register sum per run of
equal ids and writes it once (``run_flushes`` counts those writes). The
ordering is preparation, not the kernel's body: the sum over j does not
depend on it.

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

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional, Tuple

import torch

from scconsensus_tpu_torch.obs.device import native_build_event

__all__ = [
    "distance_cluster_sums",
    "distance_cluster_sums_reference",
    "labels_onehot",
    "launch_plan",
    "run_flushes",
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
# the kernel's tiling (csrc/distance_cluster_sums.cu): rows per block, cells
# per staged tile, cut widths it is built for, and the most partial sums
# (floats) the splits of j may take
_TM = 256
_TN = 32
_CUT_WIDTHS = (1, 2, 4)
_MAX_PART = 1 << 28
# below this many cells the caller's order is kept: sorting them costs more
# than the whole sweep saves
_ORDER_MIN = 2048
_PLANS: dict = {}


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
    memory report for each kernel). Either outcome is an event of the
    compile log (``obs.device.native_build_event``): a build, or a cache
    hit."""
    so = _so_path()
    if os.path.exists(so):
        native_build_event("cuda", 0.0)
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
    secs = time.perf_counter() - t0
    native_build_event("cuda", secs)
    return so, secs, proc.stdout + proc.stderr


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build()[0])
            ptr, i64 = ctypes.c_void_p, ctypes.c_int64
            lib.scc_dcs_keys.restype = ctypes.c_int
            lib.scc_dcs_keys.argtypes = [ptr, ptr] + [i64] * 5 + [ptr]
            lib.scc_dcs_group.restype = ctypes.c_int
            lib.scc_dcs_group.argtypes = [ptr] * 9 + [i64] * 12 + [ptr]
            lib.scc_dcs_blocks_per_sm.restype = ctypes.c_int
            lib.scc_dcs_blocks_per_sm.argtypes = [i64, i64,
                                                  ctypes.POINTER(ctypes.c_int)]
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


def _valid_ids(ids: torch.Tensor, k: int) -> torch.Tensor:
    """The ids with every one outside [0, K) set to −1 (no cluster)."""
    return torch.where((ids >= 0) & (ids < k), ids, torch.full_like(ids, -1))


def _cut_groups(c: int, k: int):
    """Column slices of the cuts that one sweep takes together: at most 4,
    and few enough that their ids, packed in base K + 2, fit in an int64."""
    top = max(g for g in range(1, _CUT_WIDTHS[-1] + 1)
              if (k + 2) ** g < 2 ** 62)
    return [slice(g, min(g + top, c)) for g in range(0, c, top)]


def _on(dev: torch.device):
    """The device guard for launches on ``dev``: the kernel library
    launches on the calling thread's current device."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _order_keys(ids: torch.Tensor, k: int, cuts: slice) -> torch.Tensor:
    """(N,) int64: each cell's ids in the columns ``cuts`` of ``ids``,
    those outside [0, K) taken as −1, packed into one number in base K + 2
    with the first cut most significant (the group must fit:
    ``_cut_groups``). On a CUDA tensor the kernel library's ``keys_kernel``
    computes them; on the CPU, torch."""
    n, c = ids.shape
    start, stop, _ = cuts.indices(c)
    if ids.device.type == "cuda" and n:
        keys = torch.empty(n, dtype=torch.int64, device=ids.device)
        with _on(ids.device):
            rc = _load().scc_dcs_keys(
                ids.data_ptr(), keys.data_ptr(), n, c, start, stop - start,
                k, torch.cuda.current_stream(ids.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"keys kernel launch failed: CUDA error {rc}")
        return keys
    key = torch.zeros(n, dtype=torch.int64, device=ids.device)
    for col in _valid_ids(ids[:, cuts], k).long().unbind(1):
        key = key * (k + 2) + col + 1
    return key


def _cell_order(ids: torch.Tensor, k: int, cuts: slice = slice(None)
                ) -> torch.Tensor:
    """The permutation that puts the cells in cluster order by the columns
    ``cuts`` of ``ids``: by the first cut's id, then by the next one's
    inside each group of the first, and so on (a stable sort of
    ``_order_keys``). Ids outside [0, K) sort together as −1. The kernel's
    columns j come in this order; its rows do not."""
    return torch.argsort(_order_keys(ids, k, cuts), stable=True)


def run_flushes(ids: torch.Tensor, k: int) -> int:
    """How many run sums the kernel writes for each row when j is not
    split: the runs of ids in [0, K), in the order the wrapper hands the
    kernel (cluster order from ``_ORDER_MIN`` cells on, the caller's order
    below), summed over the cuts. In cluster order: K for one cut that uses
    every id, at most C × the number of distinct id tuples, N·C when no two
    neighbours share an id."""
    total = 0
    for g in _cut_groups(ids.shape[1], k):
        key = _valid_ids(ids[:, g], k)
        if ids.shape[0] >= _ORDER_MIN:
            key = key[_cell_order(ids, k, g)]
        for col in key.unbind(1):
            ends = torch.ones_like(col, dtype=torch.bool)
            ends[:-1] = col[1:] != col[:-1]
            total += int((ends & (col >= 0)).sum())
    return total


def _plan_splits(n: int, k: int, n_sm: int, per_sm: int) -> Tuple[int, int]:
    """(splits of j, tiles per split) for N rows and K clusters on a card
    with ``n_sm`` SMs that hold ``per_sm`` sweep blocks each. Of 1 to 8
    splits, the first whose blocks come within 10 % of filling their last
    round of the SMs (rounds of ``per_sm`` blocks an SM, no SM more than
    one block behind another), or the best; the partial sums (splits, K,
    N) stay within ``_MAX_PART`` floats and every split has a tile."""
    row_blocks = -(-n // _TM)
    tiles = -(-n // _TN)
    cap = max(1, min(8, tiles, _MAX_PART // max(k * n, 1)))
    best, best_eff = 1, 0.0
    for s in range(1, cap + 1):
        per = -(-row_blocks * s // n_sm)          # blocks on the busiest SM
        eff = row_blocks * s / (n_sm * per_sm * -(-per // per_sm))
        if eff > best_eff + 1e-9:
            best, best_eff = s, eff
        if eff >= 0.9:
            break
    per = -(-tiles // best)
    return -(-tiles // per), per


def launch_plan(n: int, d: int, c: int, k: int, device) -> dict:
    """How the wrapper launches the kernel for x (N, d), C cuts and K
    clusters on a CUDA ``device``: the groups of cuts (one sweep each), the
    cut width the sweep is built for, blocks an SM holds, the splits of j
    and tiles of j per split, whether the cells are put in cluster order,
    and the scratch it needs (byte offsets of the ordered features, norms,
    ids, run-end masks and partial sums, and the total). Kept per shape."""
    device = torch.device(device)
    key = (n, d, c, k, device.index)
    if key in _PLANS:
        return _PLANS[key]
    lib = _load()
    groups = _cut_groups(c, k)
    width = next(w for w in _CUT_WIDTHS if w >= groups[0].stop)
    got = ctypes.c_int(0)
    rc = lib.scc_dcs_blocks_per_sm(d, width, ctypes.byref(got))
    if rc != 0 or got.value < 1:
        raise RuntimeError(f"occupancy query failed: CUDA error {rc}")
    per_sm = got.value
    splits, per = _plan_splits(
        n, k, torch.cuda.get_device_properties(device).multi_processor_count,
        per_sm)
    dc = 16 if d <= 16 else 32
    n_pad = -(-n // _TN) * _TN
    offsets, total = {}, 0
    for name, nbytes in (("xs", 4 * -(-d // dc) * n_pad * dc),
                         ("b2", 4 * n_pad), ("ids", 4 * n_pad * width),
                         ("ends", 4 * n_pad),
                         ("part", 4 * splits * k * n if splits > 1 else 0)):
        offsets[name] = total
        total += -(-nbytes // 256) * 256
    plan = {"groups": groups, "width": width, "blocks_per_sm": per_sm,
            "splits": splits, "tiles_per_split": per,
            "ordered": n >= _ORDER_MIN, "n_pad": n_pad,
            "offsets": offsets, "scratch_bytes": total}
    _PLANS[key] = plan
    return plan


def distance_cluster_sums(x: torch.Tensor, labels: torch.Tensor, k: int
                          ) -> torch.Tensor:
    """(N, K) S[i, k] = Σ ‖x_i − x_j‖ over the (j, c) with
    labels[j, c] == k, for x (N, d) contiguous float32 and labels (N, C)
    contiguous int32 on one device: C labelings of the same cells (the
    deepSplit cuts), their ids in disjoint ranges of [0, K); an id outside
    [0, K) is no cluster. Equal to dist(x, x) @ onehot for the one-hot of
    the ids (``labels_onehot``).

    On a CUDA tensor: puts the cells in cluster order on the card (from
    ``_ORDER_MIN`` cells on), launches the hand-written kernel on the
    current stream (and counts the call in
    ``distance_cluster_sums.launches``), or raises. On a CPU tensor: the
    plain version."""
    _check(x, labels, k)
    if x.device.type == "cpu":
        return distance_cluster_sums_reference(x, labels, k)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, d = x.shape
    c = labels.shape[1]
    dev = x.device
    out = torch.empty((n, k), dtype=torch.float32, device=dev)
    if n == 0 or k == 0:
        return out
    if d == 0 or c == 0:
        return out.zero_()
    lib = _load()
    plan = launch_plan(n, d, c, k, dev)
    groups = plan["groups"]
    scratch = torch.empty(plan["scratch_bytes"], dtype=torch.uint8,
                          device=dev)
    ptr = {name: scratch.data_ptr() + off
           for name, off in plan["offsets"].items()}
    with _on(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for gi, g in enumerate(groups):
            cg = g.stop - g.start
            order = _cell_order(labels, k, g) if plan["ordered"] else None
            rc = lib.scc_dcs_group(
                x.data_ptr(), labels.data_ptr(),
                None if order is None else order.data_ptr(),
                ptr["xs"], ptr["b2"], ptr["ids"], ptr["ends"], ptr["part"],
                out.data_ptr(), n, d, c, g.start, cg,
                next(w for w in _CUT_WIDTHS if w >= cg), k, plan["n_pad"],
                plan["tiles_per_split"], plan["splits"], int(gi == 0),
                int(gi == len(groups) - 1), stream)
            if rc != 0:
                raise RuntimeError(
                    f"distance_cluster_sums kernel launch failed: CUDA error "
                    f"{rc} (N={n}, d={d}, C={c}, K={k})")
    distance_cluster_sums.launches += 1
    return out


distance_cluster_sums.launches = 0
