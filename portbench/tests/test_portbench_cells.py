"""A cell and a metric added as files; the reference against the port at
a small size; the faults the judge has to catch."""

import hashlib
import json
import math
import os

import numpy as np
import pytest

import run as harness
from conftest import BENCH, ROOT, make_root

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

LOOSE = {"log_fc_gap": 1e-4, "log_p_gap": 1e-4, "embed_gap": 1e-4,
         "tree_gap": 1e-4, "silhouette_gap": 1e-4,
         "pool_silhouette_gap": 1e-4}


def _digest(top):
    out = {}
    for d, _, files in os.walk(top):
        if "_out" in d or "__pycache__" in d:
            continue
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, top)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def _cpu_run(root, seconds=0.0, traced=False):
    cell = harness.Cell("tiny.wilcox", root)
    # on the CPU the port's silhouette is its plain float32 version, not
    # the kernel: the small-size checks use loose tolerances
    cell.limits = {k: LOOSE.get(k, v) for k, v in cell.limits.items()}
    run = harness.run_cell(cell, 2**33 + 7, seconds, traced, device="cpu")
    return run, harness.result_line(run, "cpu")


def test_a_cell_and_a_metric_added_as_files(tiny_root):
    before = _digest(BENCH)
    here = os.path.join(tiny_root, "portbench")
    with open(os.path.join(here, "metrics", "jobs_in_window.py"), "w") as f:
        f.write('"""Jobs the window completed."""\n\n\n'
                "def read(run):\n    return float(len(run.jobs))\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": "jobs_in_window", "unit": "jobs", "better": "higher",
        "source": "host_clock", "layer": "entry", "moves": "refine_s",
        "workloads": ["tiny.wilcox"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    run, line = _cpu_run(tiny_root, traced=True)
    assert line["correct"], line["checks"]
    assert line["metrics"]["jobs_in_window"]["value"] == len(run.jobs) >= 1
    assert {"de_s", "tree_s", "cuts_s"} <= set(line["metrics"])
    assert list(line)[-1] == "checks"
    # nothing of the benchmark itself was edited to add them
    assert _digest(BENCH) == before
    assert _digest(here).items() >= before.items()


def test_reference_against_the_port_at_a_small_size(tiny_root):
    run, line = _cpu_run(tiny_root, seconds=1.0)
    assert line["correct"], line["checks"]
    checks = line["checks"]
    assert set(checks) == set(harness.Cell("tiny.wilcox", tiny_root).limits)
    exact = ("consensus_mismatch", "de_tested_mismatch", "de_mask_mismatch",
             "union_mismatch", "nodg_mismatch",
             "cut_mismatch" if "cut_mismatch" in checks
             else "pool_cut_structure")
    for name in exact:
        assert checks[name]["value"] == 0.0
    assert 0.0 < checks["log_p_gap"]["value"] < 1e-5
    assert line["attempted"] == len(run.jobs) >= 1 and line["failed"] == 0


def _patched(monkeypatch, target, wrap):
    import importlib

    mod_name, attr = target.rsplit(".", 1)
    mod = importlib.import_module(mod_name)
    monkeypatch.setattr(mod, attr, wrap(getattr(mod, attr)))


def _alter_log_p(fn):
    def f(*a, **k):
        res = fn(*a, **k)
        idx = res.tested.nonzero()[0]
        res.log_p[idx[0], idx[1]] *= 2.0           # one answer altered
        return res
    return f


def _half_the_pairs(fn):
    def f(*a, **k):
        res = fn(*a, **k)
        half = res.tested.shape[0] // 2            # half the batch left out
        res.tested[half:] = False
        res.de_mask[half:] = False
        res.log_p[half:] = math.nan
        return res
    return f


def _alter_cut(fn):
    def f(*a, **k):
        lab = fn(*a, **k)
        lab = np.array(lab)
        lab[0] = lab.max() + 1                     # one label altered
        return lab
    return f


def _alter_consensus(fn):
    def f(*a, **k):
        cons = np.array(fn(*a, **k))
        cons[0] = cons[-1] if cons[0] != cons[-1] else "altered"
        return cons
    return f


def _alter_silhouette(fn):
    def f(*a, **k):
        out = list(fn(*a, **k))
        mean, per = out[0]
        out[0] = (mean + 0.01, per)                # one answer altered
        return out
    return f


def _misnumbered(fn):
    def f(*a, **k):
        lab = np.array(fn(*a, **k))
        return np.where(lab > 0, lab + 1, lab)     # clusters 2..K+1
    return f


FAULTS = {
    "answer_altered": ("scconsensus_tpu_torch.models.pipeline.pairwise_de",
                       _alter_log_p, "log_p_gap"),
    "half_the_batch": ("scconsensus_tpu_torch.models.pipeline.pairwise_de",
                       _half_the_pairs, "de_tested_mismatch"),
    "cut_altered": ("scconsensus_tpu_torch.models.pipeline.cutree_hybrid",
                    _alter_cut, "cut_mismatch"),
    "consensus_altered": ("scconsensus_tpu_torch.plot_contingency_table",
                          _alter_consensus, "consensus_mismatch"),
    "silhouette_altered": (
        "scconsensus_tpu_torch.models.pipeline.multi_cut_silhouette",
        _alter_silhouette, "silhouette_gap"),
    "pooled_silhouette_altered": (
        "scconsensus_tpu_torch.models.pipeline.pooled_multi_cut_silhouette",
        _alter_silhouette, "pool_silhouette_gap"),
    "pool_cut_misnumbered": (
        "scconsensus_tpu_torch.models.pipeline.cutree_hybrid",
        _misnumbered, "pool_cut_structure"),
}
# which faults each branch's timed path can have
BRANCH_FAULTS = {
    "exact": ("answer_altered", "half_the_batch", "cut_altered",
              "consensus_altered", "silhouette_altered"),
    "pool": ("answer_altered", "half_the_batch", "consensus_altered",
             "pooled_silhouette_altered", "pool_cut_misnumbered"),
}


@pytest.mark.parametrize("branch, fault", [
    (b, f) for b, fs in BRANCH_FAULTS.items() for f in fs])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, branch,
                                            fault):
    target, wrap, number = FAULTS[fault]
    _patched(monkeypatch, target, wrap)
    _, line = _cpu_run(make_root(tmp_path, branch=branch))
    assert line["correct"] is False
    c = line["checks"][number]
    assert c["value"] is None or c["value"] > c["limit"]
