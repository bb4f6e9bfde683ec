"""The port's cost attribution (``obs.cost``): gating, memoization per
abstract signature, span accumulation, the per-stage summary pinned to
the reference's, the counts held against an analytic count of the
rank-sum GEMMs, and the engine's wiring (ladder buckets priced, results
unchanged)."""

import numpy as np
import pytest
import torch

import scconsensus_tpu.obs.cost as ref_cost
import scconsensus_tpu_torch as port
from scconsensus_tpu_torch import ReclusterConfig
from scconsensus_tpu_torch.obs import cost as obs_cost
from scconsensus_tpu_torch.obs.trace import Tracer
from scconsensus_tpu_torch.ops.ranksum_allpairs import ranksum_body
from scconsensus_tpu_torch.utils.synthetic import (
    noisy_labeling,
    synthetic_scrna,
)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cost_on(monkeypatch):
    monkeypatch.setenv("SCC_OBS_COST", "1")


def _mm(x, y):
    return torch.exp(x @ y)


class TestAttachCost:
    def test_off_by_default_is_noop(self, monkeypatch):
        monkeypatch.delenv("SCC_OBS_COST", raising=False)
        tr = Tracer(sync="off")
        with tr.span("s") as sp:
            assert obs_cost.attach_cost(sp, _mm, torch.ones(8, 8),
                                        torch.ones(8, 8)) is None
        assert "xla_cost" not in tr.span_records()[0].get("attrs", {})

    def test_counts_flops_bytes_and_transcendentals(self, cost_on):
        x, y = torch.ones(16, 8), torch.ones(8, 4)
        ca = obs_cost.cost_analysis_of(_mm, x, y)
        # the GEMM's 2·m·k·n; each non-view op's inputs and outputs
        assert ca["flops"] == 2 * 16 * 8 * 4
        assert ca["bytes_accessed"] == 4 * ((16 * 8 + 8 * 4 + 16 * 4)
                                            + 2 * 16 * 4)
        assert ca["transcendentals"] == 16 * 4

    def test_attaches_and_accumulates(self, cost_on):
        x = torch.ones(16, 16)
        tr = Tracer(sync="off")
        with tr.span("s") as sp:
            first = obs_cost.attach_cost(sp, _mm, x, x)
            obs_cost.attach_cost(sp, _mm, x, x)
        c = tr.span_records()[0]["attrs"]["xla_cost"]
        assert first["flops"] > 0 and c["kernels"] == 2
        assert c["flops"] == pytest.approx(2 * first["flops"])

    def test_memoized_per_shape(self, cost_on):
        calls = []

        def fn(x):
            calls.append(1)
            return x @ x

        a = torch.ones(32, 32)
        first = obs_cost.cost_analysis_of(fn, a)
        assert obs_cost.cost_analysis_of(fn, torch.zeros(32, 32)) is first
        assert len(calls) == 1
        b = torch.ones(64, 64)
        assert obs_cost.cost_analysis_of(fn, b)["flops"] > first["flops"]
        assert len(calls) == 2

    def test_ambient_span_attach(self, cost_on):
        x = torch.ones(8, 8)
        tr = Tracer(sync="off")
        with tr.span("stage_k"):
            obs_cost.attach_cost(None, _mm, x, x)
        assert tr.span_records()[0]["attrs"]["xla_cost"]["kernels"] == 1

    def test_uncosted_callable_degrades_to_none(self, cost_on):
        assert obs_cost.attach_cost(None, object(), 1) is None


def _span(i, name, parent, kind, wall, flops=None):
    s = {"name": name, "span_id": i, "parent_id": parent,
         "depth": 0 if parent is None else 1, "kind": kind, "t0_s": 0.0,
         "wall_submitted_s": wall,
         "wall_synced_s": wall if kind == "stage" else None,
         "synced": kind == "stage"}
    if flops is not None:
        s["attrs"] = {"xla_cost": {"flops": flops, "bytes_accessed": flops / 2,
                                   "transcendentals": 3.0, "kernels": 1}}
    return s


@pytest.mark.parametrize("spans", [
    [],
    [_span(0, "wilcox", None, "stage", 2.0),
     _span(1, "bucket", 0, "detail", 1.0, flops=6e9),
     _span(2, "bucket", 0, "detail", 0.5, flops=2e9),
     _span(3, "tree", None, "stage", 1.0)],
    [_span(0, "de", None, "stage", 0.0, flops=1e6),
     _span(1, "de", None, "stage", 0.25, flops=5e8),
     _span(2, "x", 1, "detail", 0.1, flops=1e3)],
], ids=["empty", "roll-up", "repeated-stages"])
def test_stage_cost_summary_equals_the_reference(spans):
    assert obs_cost.stage_cost_summary(spans) == \
        ref_cost.stage_cost_summary(spans)


@pytest.mark.parametrize("window", [0, 32])
def test_rank_sum_counts_against_the_analytic_gemms(cost_on, window):
    """The rank-sum body's GEMM form: per gene the (K, W) × (W, K) sums
    of V and of E (2·K²·W each), the pair selections of u, b_ij and b_ji
    (2·K²·P each) and of the two tie diagonals (2·K·P each), plus in
    zero-block mode the three (K → P) selections of nnz and z."""
    g, n, k = 6, 48, 4
    rng = np.random.default_rng(0)
    vals = np.where(rng.random((g, n)) < 0.5, 0.0,
                    rng.random((g, n))).astype(np.float32)
    cid = torch.as_tensor(rng.integers(0, k, n))
    pi, pj = np.triu_indices(k, 1)
    p = pi.size
    tn = torch.bincount(cid, minlength=k)
    ca = obs_cost.cost_analysis_of(
        ranksum_body, torch.as_tensor(vals), cid, tn, torch.as_tensor(pi),
        torch.as_tensor(pj), k, window=window, cpu_forms=False)
    w = min(window, n) if window else n
    want = g * (4 * k * k * w + 6 * k * k * p + 4 * k * p)
    if window:
        want += g * 3 * 2 * k * p
    assert ca["flops"] == want
    assert ca["bytes_accessed"] > 0 and ca["transcendentals"] > 0


def test_the_fake_tensor_count_is_what_a_real_run_moves(cost_on):
    """The counted run dispatches on fake tensors; its byte tally equals
    the same tally taken over a real run of the call."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    rng = np.random.default_rng(1)
    vals = torch.as_tensor(rng.random((16, 64)).astype(np.float32))
    cid = torch.as_tensor(rng.integers(0, 3, 64))
    pi, pj = (torch.as_tensor(a) for a in np.triu_indices(3, 1))
    args = (vals, cid, torch.bincount(cid, minlength=3), pi, pj, 3)
    moved = []

    class Tally(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            if not func.is_view:
                moved.append(sum(
                    t.numel() * t.element_size()
                    for t in tree_leaves((a, kw or {}, out))
                    if isinstance(t, torch.Tensor)))
            return out

    with torch.no_grad(), Tally():
        ranksum_body(*args)
    ca = obs_cost.cost_analysis_of(ranksum_body, *args)
    assert ca["bytes_accessed"] == sum(moved)


def test_ladder_buckets_priced_and_results_unchanged(monkeypatch):
    data, truth, _ = synthetic_scrna(n_genes=60, n_cells=150, n_clusters=2,
                                     n_markers_per_cluster=8, seed=3)
    labels = noisy_labeling(truth, 0.05, seed=1)
    base = port.refine(data, labels, ReclusterConfig(), device="cpu")
    monkeypatch.setenv("SCC_OBS_COST", "1")
    res = port.refine(data, labels, ReclusterConfig(), device="cpu")
    spans = res.metrics["spans"]
    costed = [s for s in spans if s["name"] == "wilcox_bucket"
              and (s.get("attrs") or {}).get("xla_cost")]
    assert costed and all(s["attrs"]["xla_cost"]["bytes_accessed"] > 0
                          for s in costed)
    summ = obs_cost.stage_cost_summary(spans)
    assert summ["wilcox_test"]["achieved_gbps"] > 0
    assert summ == ref_cost.stage_cost_summary(spans)
    np.testing.assert_array_equal(base.de.log_p.numpy(),
                                  res.de.log_p.numpy())
    for key in base.dynamic_labels:
        np.testing.assert_array_equal(base.dynamic_labels[key],
                                      res.dynamic_labels[key])
