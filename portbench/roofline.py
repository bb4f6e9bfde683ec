"""The card's peaks and the operation and byte counts of the kernels whose
roofline share the benchmark reports.

Peaks: NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit;
a card set below it runs slower, so every share is stated beside the
card's ``power.limit``. The port computes in float32 on the CUDA cores
(TF32 off), so its matrix work is held to the float32 rate.

``dcs_counts`` counts what one launch of the distance × cluster-sum
kernel (``csrc/distance_cluster_sums.cu``: S[i, k] = Σ over cells j of
cluster k of ‖x_i − x_j‖, every cut's clusters in one pass) needs for its
shapes, whatever code computes it: 2·N²·d operations for the cross
products, 3·N² for a² + b² − 2ab, the root and the clamp, and one add per
row for each (cell, cut) id inside a cluster; the points (N, d) and the
ids (N, C) read once and the sums (N, K) written once, 4 bytes each.
"""

from __future__ import annotations

__all__ = ["PEAK_FP32_FLOPS", "PEAK_BYTES", "least_seconds", "dcs_counts"]

PEAK_FP32_FLOPS = 67e12     # float32 outside the tensor cores
PEAK_BYTES = 3.35e12        # HBM3


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES)


def dcs_counts(n: int, d: int, c: int, k: int, nnz: int):
    """(operations, bytes) of one launch over n points of d dimensions,
    c cuts with k clusters in all and nnz (cell, cut) ids inside one."""
    ops = n * n * (2.0 * d + 3.0) + float(n) * nnz
    nbytes = 4.0 * (n * d + n * c + n * k)
    return ops, nbytes
