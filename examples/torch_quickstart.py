"""Worked scConsensus session on the PyTorch port: the counterpart of
``examples/quickstart.py`` (the reference README's workflow,
README.md:38-162) through ``scconsensus_tpu_torch``, on the card by
default or on the CPU with ``--device cpu``, with no external data
(a synthetic 26k-PBMC-shaped draw stands in for the Zenodo dataset).

Steps, in the reference's order:
  1. a (genes × cells) log-normalized matrix and two labelings
     (supervised cell-type names × unsupervised cluster ids),
  2. the gene filter rowSums(data > 0) > threshold      (README.md:116),
  3. plot_contingency_table → automated consensus       (README.md:85),
  4. the manual consensus override                      (README.md:91-101),
  5. recluster_de_consensus(method="edgeR", ...)        (README.md:118),
     the slow path, and the fast Wilcoxon path,
  6. per-deepSplit colors → cell-type annotation        (README.md:127-138),
  7. both plots (contingency heatmap and DE heatmap PDFs),
  8. resume: refine() again with an artifact_dir skips the stored stages.

Run:  python examples/torch_quickstart.py [--cells 2000] [--genes 800]
      [--outdir .] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import scconsensus_tpu_torch as scc  # noqa: E402
from scconsensus_tpu_torch.utils.synthetic import (  # noqa: E402
    noisy_labeling,
    synthetic_scrna,
)


def main(n_cells: int = 2000, n_genes: int = 800, outdir: str = ".",
         device: str = "cuda") -> dict:
    out = pathlib.Path(outdir)
    out.mkdir(parents=True, exist_ok=True)

    # -- 1. inputs: matrix + two labelings ------------------------------
    data, truth, _ = synthetic_scrna(
        n_genes=n_genes, n_cells=n_cells, n_clusters=6,
        n_markers_per_cluster=min(40, n_genes // 8), seed=7,
    )
    gene_names = np.array([f"gene{i}" for i in range(data.shape[0])])
    celltypes = ["T_Naive", "T_Cytotoxic", "B_Cells", "NK_Cells",
                 "Monocytes", "pDC"]
    supervised = np.array([celltypes[v] for v in noisy_labeling(
        truth, 0.05, seed=1, prefix="").astype(int)])
    unsupervised = noisy_labeling(truth, 0.10, seed=2, prefix="uns")

    # -- 2. gene filter: rowSums(data > 0) > threshold ------------------
    keep = (data > 0).sum(axis=1) > max(10, n_cells // 250)
    data, gene_names = data[keep], gene_names[keep]
    print(f"[torch-quickstart] gene filter kept {keep.sum()}/{keep.size} "
          "genes")

    # -- 3. contingency table + automated consensus ---------------------
    consensus = scc.plot_contingency_table(
        supervised, unsupervised,
        filename=str(out / "Contingency_Table.pdf"))
    print(f"[torch-quickstart] consensus labels: {len(set(consensus))} "
          "clusters")

    # -- 4. manual consensus override (user-in-the-loop) ----------------
    consensus = np.asarray(consensus, dtype=object)
    rare = [lab for lab in set(consensus)
            if (consensus == lab).sum() < max(20, n_cells // 100)]
    for lab in rare:
        consensus[consensus == lab] = str(lab).split("_")[0]
    consensus = consensus.astype(str)
    print(f"[torch-quickstart] after manual override: "
          f"{len(set(consensus))} clusters")

    # -- 5. DE refinement: the edgeR slow path + the fast Wilcoxon ------
    de_obj = scc.recluster_de_consensus(
        data, consensus, method="edgeR", q_val_thrs=0.01, fc_thrs=2.0,
        mean_scaling_factor=0.5, deep_split_values=(1, 2, 3, 4),
        min_cluster_size=10, gene_names=gene_names,
        plot_name=str(out / "Reclustered_DE_edgeR_Heatmap.pdf"),
        device=device)
    print(f"[torch-quickstart] edgeR DE union: {de_obj.de_gene_union.size} "
          f"genes; deep_split_info: {de_obj.deep_split_info}")
    fast_obj = scc.recluster_de_consensus_fast(
        data, consensus, method="wilcox", q_val_thrs=0.1,
        deep_split_values=(1, 2), gene_names=gene_names, device=device)
    print(f"[torch-quickstart] wilcox DE union: "
          f"{fast_obj.de_gene_union.size} genes")

    # -- 6. annotate refined clusters by color --------------------------
    colors = de_obj.dynamic_colors["deepsplit: 3"]
    annotation = {}
    for color in dict.fromkeys(colors):        # stable order
        if color == "grey":
            annotation[color] = "Unknown"
            continue
        vals, counts = np.unique(consensus[colors == color],
                                 return_counts=True)
        annotation[color] = str(vals[np.argmax(counts)])
    print(f"[torch-quickstart] annotated {len(annotation)} refined "
          f"clusters: {sorted(set(annotation.values()))}")

    # -- 8. resume from the artifact store ------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(method="wilcox", q_val_thrs=0.1, deep_split_values=(1, 2),
                  artifact_dir=tmp, device=device)
        first = scc.recluster_de_consensus_fast(data, consensus, **kw)
        resumed = scc.recluster_de_consensus_fast(data, consensus, **kw)
        def stages(res):
            return [s["stage"] for s in res.metrics.get("stages", [])]

        assert "wilcox_test" in stages(first)
        assert "wilcox_test" not in stages(resumed), \
            "resume should skip the DE stage"
        for key, labels in first.dynamic_labels.items():
            assert np.array_equal(resumed.dynamic_labels[key], labels), key
        print("[torch-quickstart] resume: DE stage skipped via artifact "
              "store")

    return {
        "device": device,
        "consensus_k": len(set(consensus)),
        "edger_union": int(de_obj.de_gene_union.size),
        "wilcox_union": int(fast_obj.de_gene_union.size),
        "annotation": annotation,
        "outputs": sorted(p.name for p in out.glob("*.pdf")),
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=2000)
    ap.add_argument("--genes", type=int, default=800)
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    summary = main(args.cells, args.genes, args.outdir, args.device)
    print(f"[torch-quickstart] done: {summary}")
