"""Device-resident data path on the PyTorch port: the counterpart of
``examples/device_resident.py``. The full refinement runs without the
matrix crossing the host↔device link as a dense block, on the card by
default or on the CPU with ``--device cpu``.

Two entry routes, both ending in the same ``refine()`` call the quickstart
uses:

  1. synthetic data: ``utils.synthetic.synthetic_scrna_device`` draws the
     gamma–Poisson matrix on the device from an explicit
     ``torch.Generator`` seeded with the draw's seed; only the labels and
     per-gene parameters cross;
  2. a sparse load: ``io.csr_to_device`` ships only the CSR triplet
     (values, column indices and row pointer, about nnz·8 bytes) and
     densifies it on the device.

Either way ``recluster_de_consensus_fast`` takes the device tensor as it
lies and keeps every stage on the device, fetching only O(N)-sized
results (embedding scores, labels, NODG).

Run:  python examples/torch_device_resident.py [--cells 1200]
      [--genes 400] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=1200)
    ap.add_argument("--genes", type=int, default=400)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    import numpy as np
    import scipy.sparse as sp
    import torch

    import scconsensus_tpu_torch as scc
    from scconsensus_tpu_torch.io import csr_to_device
    from scconsensus_tpu_torch.utils.synthetic import (
        noisy_labeling,
        synthetic_scrna_device,
    )

    dev = torch.device(args.device)

    # Route 1: draw the matrix on the device.
    t0 = time.perf_counter()
    data, truth, _ = synthetic_scrna_device(
        n_genes=args.genes, n_cells=args.cells, n_clusters=5,
        n_markers_per_cluster=min(30, args.genes // 5), seed=7,
        device=dev)
    resident = isinstance(data, torch.Tensor) and data.device.type == dev.type
    print(f"on-device gen: {tuple(data.shape)} on {data.device} in "
          f"{time.perf_counter() - t0:.2f}s (device-resident: {resident})")

    sup = noisy_labeling(truth, 0.05, n_out_clusters=3, seed=1, prefix="T")
    uns = noisy_labeling(truth, 0.10, seed=2, prefix="L")
    consensus = scc.plot_contingency_table(sup, uns, filename=None)

    t0 = time.perf_counter()
    res = scc.recluster_de_consensus_fast(data, consensus, q_val_thrs=0.05,
                                          device=dev)
    print(f"refine over device matrix: {time.perf_counter() - t0:.2f}s, "
          f"union={res.de_gene_union_idx.size}, "
          f"clusters per deepSplit="
          f"{ {k: len(set(v)) for k, v in res.dynamic_colors.items()} }")

    # Route 2: the same pipeline fed from a sparse load staged on the
    # device as its CSR triplet.
    host = data.cpu().numpy()
    host[host < 0.4] = 0.0  # sparsify for the demo
    csr = sp.csr_matrix(host)
    dev2 = csr_to_device(csr, device=dev)
    print(f"csr_to_device: {csr.nnz} stored entries crossed as the "
          f"triplet; dense on {dev2.device}")
    res2 = scc.recluster_de_consensus_fast(dev2, consensus, q_val_thrs=0.05,
                                           device=dev)
    print(f"refine over csr_to_device matrix: "
          f"union={res2.de_gene_union_idx.size}")


if __name__ == "__main__":
    main()
