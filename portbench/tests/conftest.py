"""The benchmark's own tests. They run on the CPU; tests marked ``cuda``
need the card and skip here, deciding inside the ``cuda`` fixture."""

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"n_cells": 1200, "n_genes": 600, "n_clusters": 5,
        "n_markers_per_cluster": 20}
# the branches a small cell can take: the exact tree (below
# approx_threshold) and the pool (past it, on a pool of 200 centroids)
EXACT = {"refine": {}, "limits": {"tree_gap": 1e-8, "cut_mismatch": 0,
                                  "silhouette_gap": 1e-7}}
POOL = {"refine": {"approx_threshold": 600, "n_pool_centroids": 200},
        "limits": None}
BRANCHES = {"exact": EXACT, "pool": POOL}


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def make_root(tmp, branch="exact", sizes=TINY, config="tm100k",
              cell="tm100k.wilcox"):
    """A copy of the benchmark under ``tmp`` with one more cell,
    ``tiny.wilcox``: the ``config`` configuration at ``sizes`` taking
    ``branch`` (exact tree or pool), the ``cell``'s traffic and its
    limits, with the exact tree's numbers in place of the pool's for the
    exact branch. Only new files and a new entry of ``BENCHMARK.json``."""
    root = str(tmp)
    shutil.copytree(BENCH, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("_out", "__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    here = os.path.join(root, "portbench")
    with open(os.path.join(here, "configs", config + ".json")) as f:
        cfg = json.load(f)
    spec = BRANCHES[branch]
    cfg.update(name="tiny", refine=spec["refine"], **sizes)
    with open(os.path.join(here, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(here, "workloads", cell + ".json")) as f:
        limits = json.load(f)["limits"]
    if spec["limits"] is not None:
        limits = {k: v for k, v in limits.items()
                  if not k.startswith("pool_")}
        limits.update(spec["limits"])
    with open(os.path.join(here, "workloads", "tiny.wilcox.json"), "w") as f:
        json.dump({"limits": limits}, f)
    src = [w for w in bench["workloads"] if w["name"] == cell][0]
    bench["workloads"].append({**src, "name": "tiny.wilcox",
                               "config": "tiny"})
    for m in bench["per_layer"] + bench["end_to_end"]:
        if cell in m.get("workloads", []):
            m["workloads"].append("tiny.wilcox")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture(params=sorted(BRANCHES))
def tiny_root(tmp_path, request):
    return make_root(tmp_path, branch=request.param)
