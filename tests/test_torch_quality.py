"""The port's quality telemetry (``obs/quality.py``) against the JAX
package's, on the CPU: the numeric sentinels, the DE gate funnel, the
cluster structure, the section's validation, and the ``quality`` section
of a default ``refine()`` equal to the reference's on the same seeded
input (fast Wilcoxon, edgeR and from CSR).

Tolerances: funnel counts, cluster sizes, entropies and ARIs are exact
(the labels agree, and both packages round entropies and ARIs to six
places); silhouettes within 1e-4 (float32 distance sums over a few
hundred cells in another order). The window ladder's buckets agree key
for key except ``padded_rows``, ``padded_elems`` and ``pad_ratio``: the
reference pads each block's rows to a power of two (at least 256) to
bound XLA's compile cache, the port runs each block on its own rows. The
reference runs its scan rank-sum kernel (``SCC_NO_RUNSPACE=1``), the one
the port has and the reference runs on an accelerator."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from scconsensus_tpu.config import ReclusterConfig as RefConfig
from scconsensus_tpu.obs import quality as ref_quality
from scconsensus_tpu.obs.trace import Tracer as RefTracer
from scconsensus_tpu.utils.synthetic import noisy_labeling, synthetic_scrna
import scconsensus_tpu_torch as port
from scconsensus_tpu_torch.carry import (
    config_from_reference,
    omega_from_reference,
)
from scconsensus_tpu_torch.de import engine as port_engine
from scconsensus_tpu_torch.obs import quality
from scconsensus_tpu_torch.obs.trace import Tracer

PADDING_KEYS = ("padded_rows", "padded_elems", "pad_ratio")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs six workers on the machine's cores; two torch threads
    # a worker keep these small tensors from crowding out the other files
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def numeric_on(monkeypatch):
    monkeypatch.setenv("SCC_OBS_NUMERIC", "1")


def _tiny():
    data, truth, _ = synthetic_scrna(
        n_genes=100, n_cells=240, n_clusters=3, n_markers_per_cluster=8,
        seed=5,
    )
    return data, noisy_labeling(truth, 0.05, seed=2)


def _omega(ref_res, cfg, n_cells):
    """The reference's PCA projection draw for its union size."""
    f = ref_res.de_gene_union_idx.size
    return omega_from_reference(np.asarray(jax.random.normal(
        jax.random.PRNGKey(0), (f, min(cfg.n_pcs + 10, f, n_cells)),
        jnp.float32)))


def _both(data, labels, ref_cfg):
    """One configuration through both packages' ``refine``; the port gets
    the reference's config JSON and projection draw."""
    from scconsensus_tpu.models.pipeline import refine as ref_refine

    ref = ref_refine(data, labels, ref_cfg, mesh=None)
    cfg = config_from_reference(ref_cfg.to_json())
    got = port.refine(data, labels, cfg, device="cpu",
                      omega=_omega(ref, ref_cfg, data.shape[1]))
    return ref, got


def _assert_quality_equal(got, ref):
    assert set(got) == set(ref)
    assert got["de_funnel"] == ref["de_funnel"]
    assert got["numeric_health"] == ref["numeric_health"]
    gs, rs = got["cluster_structure"], ref["cluster_structure"]
    assert set(gs) == set(rs)
    for k in rs:
        if k != "cuts":
            assert gs[k] == pytest.approx(rs[k], abs=1e-12), k
    for g, r in zip(gs["cuts"], rs["cuts"], strict=True):
        assert set(g) == set(r)
        for k in r:
            if k == "silhouette":
                assert abs(g[k] - r[k]) <= 1e-4
            else:
                assert g[k] == r[k], k
    if "wilcox_ladder" in ref:
        gl, rl = got["wilcox_ladder"], ref["wilcox_ladder"]
        strip = lambda d: {k: v for k, v in d.items()  # noqa: E731
                           if k not in PADDING_KEYS + ("buckets",)}
        assert strip(gl) == strip(rl)
        assert [strip(b) for b in gl["buckets"]] == \
            [strip(b) for b in rl["buckets"]]
        for b in gl["buckets"]:
            assert b["padded_rows"] == b["n_genes"]


# --------------------------------------------------------------------------
# numeric-health sentinels
# --------------------------------------------------------------------------

class TestSentinel:
    def test_trip_records_span_metrics_and_registry(self, numeric_on):
        x = np.ones(50, np.float32)
        x[3] = np.nan
        x[7] = np.inf
        rtr = RefTracer(sync="off")
        with rtr.span("stage_x") as rsp:
            want = ref_quality.check_array("bad", x, span=rsp)
        tr = Tracer(sync="off")
        with tr.span("stage_x") as sp:
            trip = quality.check_array("bad", torch.from_numpy(x), span=sp)
        assert trip == want == {"span": "stage_x", "array": "bad",
                                "nan": 1, "inf": 1, "size": 50}
        assert quality.trips(tr) == [trip]
        rec = sp.record()
        assert rec["metrics"]["numeric_nan"]["value"] == 1
        assert rec["metrics"]["numeric_inf"]["value"] == 1
        assert rec["attrs"]["numeric_trips"] == [
            {"array": "bad", "nan": 1, "inf": 1}
        ]

    def test_expected_nan_does_not_trip(self, numeric_on):
        tr = Tracer(sync="off")
        with tr.span("s") as sp:
            x = torch.full((10,), float("nan"))
            assert quality.check_array("lp", x, kinds=("nan",),
                                       expected_nan=10, span=sp) is None
            # one more NaN than expected trips with the excess only
            trip = quality.check_array("lp", x, kinds=("nan",),
                                       expected_nan=9, span=sp)
        assert trip["nan"] == 1
        assert quality.checks_run(tr) == 2

    def test_disabled_flag_is_noop(self, monkeypatch):
        monkeypatch.delenv("SCC_OBS_NUMERIC", raising=False)
        tr = Tracer(sync="off")
        with tr.span("s"):
            x = torch.full((4,), float("nan"))
            assert quality.check_array("lp", x) is None
        assert quality.trips(tr) == []
        assert quality.checks_run(tr) == 0

    def test_tensor_and_tensor_expected_count(self, numeric_on):
        tr = Tracer(sync="off")
        with tr.span("s") as sp:
            x = torch.where(torch.arange(6) < 2, float("nan"), 1.0)
            trip = quality.check_array(
                "dev", x, kinds=("nan",),
                expected_nan=torch.as_tensor(1), span=sp,
            )
            # integer tensors carry no NaN: no check at all
            assert quality.check_array("ints", torch.arange(4)) is None
        assert trip["nan"] == 1
        assert quality.checks_run(tr) == 1

    def test_injected_nan_mid_wilcox_names_the_stage(self, numeric_on,
                                                     monkeypatch):
        """NaN injected into tested entries of the rank-sum output: the
        quality section names the ``wilcox_test`` stage, as the
        reference's does for the same injection."""
        orig = port_engine._run_wilcox

        def poisoned(*a, **kw):
            lp, u = orig(*a, **kw)
            lp = lp.clone()
            lp[0, :5] = float("nan")
            return lp, u

        monkeypatch.setattr(port_engine, "_run_wilcox", poisoned)
        data, labels = _tiny()
        res = port.recluster_de_consensus_fast(
            data, labels, deep_split_values=(1,), device="cpu")
        nh = res.metrics["quality"]["numeric_health"]
        assert nh["enabled"] is True
        (trip,) = [t for t in nh["trips"] if t["array"] == "log_p"]
        assert trip["span"] == "wilcox_test"
        assert trip["nan"] >= 1  # the poisoned entries that were tested
        quality.validate_quality(res.metrics["quality"])


# --------------------------------------------------------------------------
# funnel conservation
# --------------------------------------------------------------------------

def _funnel_is_conserved(f):
    stages = [s for s in quality.FUNNEL_STAGES if s in f["total"]]
    for a, b in zip(stages, stages[1:]):
        assert f["total"][a] >= f["total"][b], (a, b, f["total"])
    for s in stages:
        assert len(f["per_pair"][s]) == f["n_pairs"]
        assert sum(f["per_pair"][s]) == f["total"][s]
    for a, b in zip(stages, stages[1:]):
        for va, vb in zip(f["per_pair"][a], f["per_pair"][b]):
            assert va >= vb


class TestFunnel:
    def test_fast_path_funnel_conserved_and_equal(self):
        from scconsensus_tpu.de.engine import pairwise_de as ref_de

        data, labels = _tiny()
        ref_cfg = RefConfig()
        cfg = config_from_reference(ref_cfg.to_json())
        res = port_engine.pairwise_de(data, labels, cfg, device="cpu")
        f = quality.de_funnel(res, cfg)
        assert set(f["total"]) == set(quality.FUNNEL_STAGES)
        assert f["total"]["input"] == f["n_pairs"] * f["n_genes"]
        _funnel_is_conserved(f)
        assert f["total"]["significant"] == int(res.de_mask.sum())
        assert f == ref_quality.de_funnel(ref_de(data, labels, ref_cfg),
                                          ref_cfg)

    def test_slow_path_funnel_omits_gate_stages(self):
        from scconsensus_tpu.de.engine import pairwise_de as ref_de

        data, labels = _tiny()
        ref_cfg = RefConfig.slow_path_preset(
            q_val_thrs=0.05, fc_thrs=1.5, method="wilcoxon",
        )
        cfg = config_from_reference(ref_cfg.to_json())
        res = port_engine.pairwise_de(data, labels, cfg, device="cpu")
        f = quality.de_funnel(res, cfg)
        assert "pct_gate" not in f["total"]
        assert "logfc_gate" not in f["total"]
        _funnel_is_conserved(f)
        assert f == ref_quality.de_funnel(ref_de(data, labels, ref_cfg),
                                          ref_cfg)

    def test_funnel_reads_counts_only(self):
        """The funnel leaves the (P, G) fields where they are and fetches
        (P,) count vectors."""
        data, labels = _tiny()
        cfg = port.ReclusterConfig()
        res = port_engine.pairwise_de(data, labels, cfg, device="cpu")
        before = {f: getattr(res, f) for f in ("log_p", "tested",
                                               "de_mask", "pct1")}
        quality.de_funnel(res, cfg)
        for f, v in before.items():
            assert getattr(res, f) is v, f
            assert isinstance(v, torch.Tensor)


# --------------------------------------------------------------------------
# cluster structure
# --------------------------------------------------------------------------

class TestClusterStructure:
    def test_sizes_entropy_ari_and_churn(self):
        rng = np.random.default_rng(0)
        inp = rng.integers(0, 3, 200)
        cut1 = inp.copy() + 1                     # identical (labels > 0)
        cut2 = np.where(cut1 == 3, 4, cut1)       # renamed cluster
        cut2[:5] = 0                              # a few unassigned
        args = ({"deepsplit: 1": cut1, "deepsplit: 2": cut2},)
        kw = dict(deep_split_info=[{"deep_split": 1, "silhouette": 0.5}],
                  input_labels=inp)
        cs = quality.cluster_structure(*args, **kw)
        assert cs == ref_quality.cluster_structure(*args, **kw)
        c1, c2 = cs["cuts"]
        assert c1["n_clusters"] == 3 and sum(c1["sizes"]) == 200
        assert c1["silhouette"] == 0.5
        assert c2["n_unassigned"] == 5
        assert cs["ari_vs_input"]["deepsplit: 1"] == 1.0
        assert cs["input_entropy"] > 0
        assert c1["contingency_entropy"] == pytest.approx(
            cs["input_entropy"])  # identical labeling: joint == marginal
        (ch,) = cs["churn"]
        assert ch["from"] == "deepsplit: 1" and ch["ari"] > 0.9

    @pytest.mark.parametrize("form", ["str", "de_codes", "int_gaps"])
    def test_coded_input_gives_the_reference_section(self, form):
        """The section from the input's integer codes (as ``refine()``
        passes the DE's) is the reference's from the str-cast labels,
        exactly, with cuts that skip ids and leave cells unassigned."""
        rng = np.random.default_rng(11)
        raw = rng.integers(0, 9, 3000)
        labels = np.array([f"c{v}" for v in raw])
        inp = {"str": labels,
               "de_codes": port_engine.encode_labels(labels)[1],
               "int_gaps": raw * 5 + 2}[form]
        cuts = {f"deepsplit: {d}": rng.integers(0, 4 + 6 * d, 3000)
                * (1 + d % 2) for d in (1, 2, 3)}
        cuts["deepsplit: 2"] = cuts["deepsplit: 2"].astype(np.int32)
        info = [{"deep_split": d, "silhouette": 0.1 * d} for d in (1, 2, 3)]
        got = quality.cluster_structure(cuts, info, inp)
        assert got == ref_quality.cluster_structure(cuts, info, labels)
        assert got["n_input_clusters"] == 9
        assert len(got["churn"]) == 2

    def test_pipeline_section_validates(self):
        data, labels = _tiny()
        res = port.recluster_de_consensus_fast(
            data, labels, deep_split_values=(1, 2), device="cpu")
        q = res.metrics["quality"]
        quality.validate_quality(q)
        ref_quality.validate_quality(q)
        cs = q["cluster_structure"]
        assert len(cs["cuts"]) == 2
        assert all("silhouette" in c for c in cs["cuts"])
        assert len(cs["churn"]) == 1
        lad = q["wilcox_ladder"]
        assert lad["n_buckets"] >= 1
        assert lad["genes_bucketed"] == lad["n_genes"]
        assert lad["real_elems"] <= lad["padded_elems"]


# --------------------------------------------------------------------------
# schema validation of the quality section
# --------------------------------------------------------------------------

def _base():
    return {
        "de_funnel": {
            "n_pairs": 2, "n_genes": 10,
            "per_pair": {"input": [10, 10], "tested": [8, 7],
                         "significant": [2, 1]},
            "total": {"input": 20, "tested": 15, "significant": 3},
        },
        "numeric_health": {"enabled": True, "checks": 1, "trips": []},
    }


def _non_monotone(q):
    q["de_funnel"]["total"]["significant"] = 99


def _pair_sum(q):
    q["de_funnel"]["per_pair"]["tested"] = [8, 8]


def _bad_trip(q):
    q["numeric_health"]["trips"] = [{"array": "x", "nan": 1}]


def _unknown_stage(q):
    q["de_funnel"]["total"]["bogus"] = 1


def _sizes(q):
    q["cluster_structure"] = {"cuts": [
        {"cut": "c", "n_clusters": 2, "sizes": [5]}]}


class TestValidation:
    @pytest.mark.parametrize("pkg", ["port", "ref"])
    def test_valid_section_passes(self, pkg):
        {"port": quality, "ref": ref_quality}[pkg].validate_quality(_base())

    @pytest.mark.parametrize("breaker,match", [
        (_non_monotone, "not monotone"),
        (_pair_sum, "sums to"),
        (_bad_trip, "span"),
        (_unknown_stage, "unknown funnel stage"),
        (_sizes, "sizes"),
    ], ids=["non_monotone_total", "per_pair_sum_mismatch", "malformed_trip",
            "unknown_funnel_stage", "cluster_sizes_must_match_count"])
    def test_rejected_by_both_packages(self, breaker, match):
        q = _base()
        breaker(q)
        for mod in (quality, ref_quality):
            with pytest.raises(ValueError, match=match):
                mod.validate_quality(q)


# --------------------------------------------------------------------------
# the default refine()'s quality section equals the reference's
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flagship_case():
    """200 genes × 400 cells × 4 clusters, seed 7, truth labels."""
    data, truth, _ = synthetic_scrna(n_genes=200, n_cells=400, n_clusters=4,
                                     seed=7)
    return data, np.array([f"c{v}" for v in truth])


@pytest.mark.parametrize("case", ["wilcox", "edger", "csr"])
def test_default_refine_quality_equals_the_reference(case, flagship_case,
                                                     monkeypatch):
    monkeypatch.setenv("SCC_NO_RUNSPACE", "1")
    data, labels = flagship_case
    if case == "edger":
        # the slow path's headline settings (bench.py's edgeR call)
        ref_cfg = RefConfig(method="edger", q_val_thrs=0.01,
                            log_fc_thrs=math.log(2.0),
                            mean_scaling_factor=2.0,
                            deep_split_values=(1, 2))
    else:
        ref_cfg = RefConfig(deep_split_values=(1, 2))
    x = sp.csr_matrix(data) if case == "csr" else data
    ref, got = _both(x, labels, ref_cfg)
    assert "quality" in got.metrics
    _assert_quality_equal(got.metrics["quality"], ref.metrics["quality"])
    # the default run carries no robustness and no integrity section
    assert "robustness" not in got.metrics
    assert "integrity" not in got.metrics


def test_numeric_sentinels_count_the_reference_s_checks(flagship_case,
                                                        monkeypatch):
    """With SCC_OBS_NUMERIC on, both packages run the same checks (log p,
    log q, the embedding, the silhouettes) and trip none."""
    monkeypatch.setenv("SCC_NO_RUNSPACE", "1")
    monkeypatch.setenv("SCC_OBS_NUMERIC", "1")
    data, labels = flagship_case
    ref, got = _both(data, labels, RefConfig(deep_split_values=(1, 2)))
    nh = got.metrics["quality"]["numeric_health"]
    assert nh == ref.metrics["quality"]["numeric_health"]
    assert nh["checks"] == 4 and nh["trips"] == []


def test_live_summary_carries_trips_and_funnel(numeric_on):
    """The heartbeat's compact view: the trip count, the newest trip and
    the latest funnel totals of one tracer, as the reference builds it."""
    x = np.array([np.nan, 1.0], np.float32)
    views = []
    for mod, tracer in ((quality, Tracer(sync="off")),
                        (ref_quality, RefTracer(sync="off"))):
        assert mod.live_summary(tracer) is None
        with tracer.span("s") as sp:
            mod.check_array("x", x, span=sp)
        mod.note_funnel({"input": 4, "significant": 1}, tracer=tracer)
        views.append(mod.live_summary(tracer))
    assert views[0] == views[1]
    assert views[0]["trips"] == 1 and views[0]["funnel"]["input"] == 4
