"""The port's workload zoo (``workloads/``) and its scenario scorers
(``obs/quality.py``) against the JAX package's, on the CPU.

Tolerances, each where it is used: the generators and the labeling
strategies byte for byte; the scorers (per-batch ARI, batch-mixing
entropy, ``ari_final_vs``, the multi-sample block) equal on the same
labels (both packages round to six places; the port's ARI takes the
pair-count product in float64, equal wherever the reference's int64 does
not wrap); every validator's ``ValueError`` message word for word; the
k-means labeling identical on separated blobs; the PCA embed within
1e-4 of the largest |score| after per-column sign alignment, with the
reference's ``PRNGKey(seed)`` draw carried; the multi-sample refine at
the reference tests' tiny shape with the reference's draw carried: the
same union and DE mask, ARI 1 per deepSplit, silhouettes within 1e-4
(float32 distance sums over 1,200 cells in another order)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scconsensus_tpu import workloads as ref_workloads
from scconsensus_tpu.obs import export as ref_export
from scconsensus_tpu.obs import quality as ref_quality
from scconsensus_tpu.obs.regress import adjusted_rand_index as ref_ari
from scconsensus_tpu.workloads import common as ref_common
from scconsensus_tpu.workloads import data as ref_data
from scconsensus_tpu.workloads import labelings as ref_labelings
from scconsensus_tpu.workloads import multisample as ref_multisample
from scconsensus_tpu_torch import workloads
from scconsensus_tpu_torch.carry import omega_from_reference
from scconsensus_tpu_torch.obs import export
from scconsensus_tpu_torch.obs import quality
from scconsensus_tpu_torch.workloads import common, data, labelings
from scconsensus_tpu_torch.workloads import multisample, soak


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs six workers on the machine's cores; two torch threads
    # a worker keep these small tensors from crowding out the other files
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# the reference tests' overrides under the registered smoke shapes
# (tests/test_workloads.py)
_TINY = {
    "multi_sample": dict(n_cells=1200, n_genes=120, n_clusters=3,
                         n_samples=2),
    "cite_dual": dict(n_cells=1000, n_genes=120, n_adt=12, k_fine=4,
                      k_coarse=2),
    "atlas_transfer": dict(n_atlas=900, n_query=600, n_genes=120,
                           n_clusters=4, cells_per=100),
    "topo_inputs": dict(n_cells=1000, n_genes=120, n_clusters=3,
                        n_covers=8),
}


def _raises_same(port_fn, ref_fn, arg, exc=ValueError) -> str:
    """Both functions raise ``exc`` on ``arg`` with the same message."""
    msgs = []
    for fn in (port_fn, ref_fn):
        with pytest.raises(exc) as ei:
            fn(arg)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    return msgs[0]


# --------------------------------------------------------------------------
# the registry and the surfaces
# --------------------------------------------------------------------------

def test_surfaces_equal_the_reference():
    assert workloads.__all__ == ref_workloads.__all__
    assert quality.__all__ == ref_quality.__all__
    assert common.__all__ == ref_common.__all__
    assert export.UNPORTED_SECTIONS == ()
    assert workloads.scenario_names() == ref_workloads.scenario_names()
    for name, ref in ref_workloads.SCENARIOS.items():
        got = workloads.SCENARIOS[name]
        assert (got.name, got.doc, got.unit, got.full, got.smoke) == (
            ref.name, ref.doc, ref.unit, ref.full, ref.smoke)
        assert got.runner_module == ref.runner_module.replace(
            "scconsensus_tpu.", "scconsensus_tpu_torch.")
        for params, smoke in ((ref.full, False), (ref.smoke, True)):
            sec = workloads.build_scenario_section(name, params, smoke)
            assert sec == ref_workloads.build_scenario_section(
                name, params, smoke)
            workloads.validate_scenario(sec)


def test_unknown_scenario_raises_the_same_key_error():
    _raises_same(workloads.get_scenario, ref_workloads.get_scenario,
                 "nope", KeyError)


def test_run_scenario_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        workloads.run_scenario("multi_sample",
                               overrides=_TINY["multi_sample"], smoke=True)


# --------------------------------------------------------------------------
# data and labelings: byte for byte
# --------------------------------------------------------------------------

_GENERATORS = {
    "multi_sample": ("multi_sample_dataset",
                     dict(n_cells=400, n_genes=80, n_clusters=3,
                          n_samples=3, seed=7)),
    "multi_sample_seed11": ("multi_sample_dataset",
                            dict(n_cells=300, n_genes=120, n_clusters=4,
                                 n_samples=2, seed=11, batch_shift=1.1)),
    "cite_seq": ("cite_seq_dataset",
                 dict(n_cells=300, n_genes=90, n_adt=8, k_coarse=2,
                      k_fine=4, seed=7)),
    "atlas_query": ("atlas_query_dataset",
                    dict(n_atlas=200, n_query=150, n_genes=30,
                         n_clusters=4, seed=7)),
}


@pytest.mark.parametrize("case", sorted(_GENERATORS))
def test_generator_bytes_equal_the_reference(case):
    fn, kw = _GENERATORS[case]
    got = getattr(data, fn)(**kw)
    want = getattr(ref_data, fn)(**kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_cite_seq_refuses_fine_below_coarse_as_the_reference():
    kw = dict(n_cells=50, n_genes=40, n_adt=4, k_coarse=4, k_fine=3)
    _raises_same(lambda k: data.cite_seq_dataset(**k),
                 lambda k: ref_data.cite_seq_dataset(**k), kw)


@pytest.mark.parametrize("n_way", [2, 3, 4])
def test_truth_perturb_bytes_equal_the_reference(n_way):
    truth = np.random.default_rng(0).integers(0, 8, size=500)
    got = labelings.truth_perturb(truth, 8, n_way=n_way)
    want = ref_labelings.truth_perturb(truth, 8, n_way=n_way)
    assert len(got) == len(want) == n_way
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 7])
def test_per_sample_labels_equal_the_reference(seed):
    truth = np.random.default_rng(2).integers(0, 4, size=400)
    batches = np.random.default_rng(3).integers(0, 3, size=400)
    got = labelings.per_sample_unsupervised(truth, batches, seed=seed)
    want = ref_labelings.per_sample_unsupervised(truth, batches, seed=seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert sorted(labelings.STRATEGIES) == sorted(ref_labelings.STRATEGIES)
    assert labelings.STRATEGIES["per_sample"] is \
        labelings.per_sample_unsupervised


def test_multi_sample_inputs_equal_the_reference():
    params = dict(_TINY["multi_sample"], seed=7)
    got = multisample.multi_sample_inputs(params)
    want = ref_multisample.multi_sample_inputs(params)
    for g, w in zip(got, want):
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()


# --------------------------------------------------------------------------
# the scorers: equal on the same labels
# --------------------------------------------------------------------------

def _labels(seed, n=600, k=5, b=3):
    rng = np.random.default_rng(seed)
    truth = rng.integers(0, k, size=n)
    final = np.where(rng.random(n) < 0.2, rng.integers(0, k + 1, size=n),
                     truth)
    batches = rng.integers(0, b, size=n)
    return final, truth, batches


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_per_batch_ari_and_mixing_equal_the_reference(seed):
    final, truth, batches = _labels(seed)
    strings = np.array([f"c{v}" for v in final])
    for lab in (final, strings):
        assert quality.per_batch_ari(lab, truth, batches) == \
            ref_quality.per_batch_ari(lab, truth, batches)
        assert quality.batch_mixing_entropy(lab, batches) == \
            ref_quality.batch_mixing_entropy(lab, batches)
    got = multisample.multi_sample_scores(final, truth, batches)
    assert got == ref_multisample.multi_sample_scores(final, truth, batches)
    quality.validate_scenario_scores(got)


def test_scorers_on_the_reference_tests_fixtures():
    truth = np.array([0, 0, 1, 1, 0, 0, 1, 1])
    final = np.array([5, 5, 7, 7, 5, 7, 5, 7])
    batches = np.array([0, 0, 0, 0, 1, 1, 1, 1])
    assert quality.per_batch_ari(final, truth, batches) == \
        {"0": 1.0, "1": -0.5}
    # a one-cell batch is skipped, never scored 1.0
    got = quality.per_batch_ari(np.array([0, 1, 0, 1, 0]),
                                np.array([0, 1, 0, 1, 0]),
                                np.array([0, 0, 0, 0, 9]))
    assert got == {"0": 1.0}
    out = quality.batch_mixing_entropy(np.array(["m", "m", "m", "p"]),
                                       np.array([0, 0, 1, 1]))
    h_m = -(2 / 3) * math.log(2 / 3) - (1 / 3) * math.log(1 / 3)
    assert out["mean_norm_entropy"] == pytest.approx(
        h_m * 3 / 4 / math.log(2), abs=1e-5)
    assert out == ref_quality.batch_mixing_entropy(
        np.array(["m", "m", "m", "p"]), np.array([0, 0, 1, 1]))


@pytest.mark.parametrize("fn", ["per_batch_ari", "batch_mixing_entropy"])
def test_scorer_size_mismatch_raises_the_same_message(fn):
    args = {"per_batch_ari": (np.zeros(4), np.zeros(4), np.zeros(3)),
            "batch_mixing_entropy": (np.zeros(4), np.zeros(5))}[fn]
    _raises_same(lambda a: getattr(quality, fn)(*a),
                 lambda a: getattr(ref_quality, fn)(*a), args)


@pytest.mark.parametrize("seed", [0, 3])
def test_ari_final_vs_and_cluster_structure_refs_equal_the_reference(seed):
    final, truth, batches = _labels(seed)
    cuts = {"deepsplit: 1": truth + 1, "deepsplit: 2": final + 1}
    refs = {"sup": truth, "uns": np.array([f"u{v}" for v in final]),
            "short": truth[:10]}
    got = quality.ari_final_vs(cuts, refs)
    assert got == ref_quality.ari_final_vs(cuts, refs)
    assert set(got) == {"sup", "uns"}      # size-mismatched refs skipped
    assert quality.ari_final_vs({}, refs) == {} == \
        quality.ari_final_vs(cuts, {})
    cs = quality.cluster_structure(cuts, None, truth, refs)
    assert cs == ref_quality.cluster_structure(cuts, None, truth, refs)
    assert cs["ari_final_vs"] == got
    q = quality.build_quality_section(dynamic_labels=cuts,
                                      input_labels=truth,
                                      ref_labelings=refs)
    assert q["cluster_structure"]["ari_final_vs"] == got
    quality.validate_quality(q)


# --------------------------------------------------------------------------
# the validators: the reference's messages word for word
# --------------------------------------------------------------------------

def _good_scores():
    return {
        "name": "multi_sample",
        "metrics": {"ari_pooled": 0.9},
        "per_batch_ari": {"0": 0.95, "1": 0.9},
        "batch_mixing": {
            "n_batches": 2,
            "mean_norm_entropy": 0.8,
            "per_cluster": {"1": {"entropy": 0.5, "n": 10}},
        },
    }


def _edit(path, value):
    """A good scoring block with one key at ``path`` set (or deleted,
    when ``value`` is the string "<del>")."""
    s = _good_scores()
    d = s
    for k in path[:-1]:
        d = d[k]
    if value == "<del>":
        del d[path[-1]]
    else:
        d[path[-1]] = value
    return s


_BAD_SCORES = {
    "not_an_object": lambda: [1],
    "empty_name": lambda: _edit(("name",), ""),
    "no_name": lambda: _edit(("name",), "<del>"),
    "no_batch_mixing": lambda: _edit(("batch_mixing",), "<del>"),
    "no_per_batch_ari": lambda: _edit(("per_batch_ari",), "<del>"),
    "ari_out_of_range": lambda: _edit(("per_batch_ari", "0"), 1.5),
    "empty_per_batch_ari": lambda: _edit(("per_batch_ari",), {}),
    "nan_metric": lambda: _edit(("metrics", "ari_pooled"), float("nan")),
    "bool_metric": lambda: _edit(("metrics", "ari_pooled"), True),
    "empty_metrics": lambda: _edit(("metrics",), {}),
    "one_batch": lambda: _edit(("batch_mixing", "n_batches"), 1),
    "mixing_above_one": lambda: _edit(
        ("batch_mixing", "mean_norm_entropy"), 1.5),
    "no_per_cluster": lambda: _edit(("batch_mixing", "per_cluster"), {}),
    "empty_cluster": lambda: _edit(
        ("batch_mixing", "per_cluster", "1"), {"entropy": 0.1, "n": 0}),
    "mixing_not_an_object": lambda: _edit(("batch_mixing",), 3),
}


def test_good_scores_pass_both_validators():
    quality.validate_scenario_scores(_good_scores())
    ref_quality.validate_scenario_scores(_good_scores())


@pytest.mark.parametrize("case", sorted(_BAD_SCORES))
def test_bad_scores_raise_the_reference_message(case):
    block = _BAD_SCORES[case]()
    _raises_same(quality.validate_scenario_scores,
                 ref_quality.validate_scenario_scores, block)
    # the same block inside a quality section
    _raises_same(quality.validate_quality, ref_quality.validate_quality,
                 {"scenario": block})


_BAD_SECTIONS = {
    "not_an_object": [],
    "no_name": {"params": {"a": 1}},
    "empty_name": {"name": "", "params": {"a": 1}},
    "unknown": {"name": "nope", "params": {"a": 1}},
    "no_params": {"name": "multi_sample"},
    "empty_params": {"name": "multi_sample", "params": {}},
    "non_scalar_param": {"name": "multi_sample", "params": {"a": [1, 2]}},
    "smoke_not_bool": {"name": "multi_sample", "params": {"a": 1},
                       "smoke": "yes"},
}


@pytest.mark.parametrize("case", sorted(_BAD_SECTIONS))
def test_bad_scenario_sections_raise_the_reference_message(case):
    sec = _BAD_SECTIONS[case]
    _raises_same(workloads.validate_scenario,
                 ref_workloads.validate_scenario, sec)
    rec = export.build_run_record("x", 1.0, scenario=sec)
    _raises_same(export.validate_run_record,
                 ref_export.validate_run_record, rec)


_C21_CASES = {
    "scenario_without_name": {"scenario": {"name": ""}},
    "ari_final_vs_out_of_range": {
        "cluster_structure": {"cuts": [], "ari_final_vs": {"sup": 7.0}}},
    "ari_final_vs_not_an_object": {
        "cluster_structure": {"cuts": [], "ari_final_vs": [0.5]}},
}


@pytest.mark.parametrize("case", sorted(_C21_CASES))
def test_quality_refuses_what_the_reference_refuses(case):
    """The port's ``validate_quality`` checks ``quality.scenario`` and
    ``cluster_structure.ari_final_vs`` as the reference's does, with its
    messages; before the zoo it let both through unchecked."""
    msg = _raises_same(quality.validate_quality,
                       ref_quality.validate_quality, _C21_CASES[case])
    assert msg.startswith("quality section: ")
    rec = export.build_run_record("x", 1.0, quality=_C21_CASES[case])
    _raises_same(export.validate_run_record,
                 ref_export.validate_run_record, rec)


# --------------------------------------------------------------------------
# the device pieces on the CPU
# --------------------------------------------------------------------------

def _blobs(n=600, k=4, d=6, seed=5, spread=0.5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 6.0, size=(k, d))
    lab = rng.integers(0, k, size=n)
    x = (centers[lab]
         + rng.normal(0.0, spread, size=(n, d))).astype(np.float32)
    return x, lab


@pytest.mark.parametrize("seed,k", [(0, 4), (3, 4), (7, 6)])
def test_kmeans_labeling_equals_the_reference_on_separated_blobs(seed, k):
    x, _ = _blobs(k=4, seed=seed + 11)
    got = common.kmeans_labeling(x, k, seed=seed, prefix="adt",
                                 device="cpu")
    want = ref_common.kmeans_labeling(x, k, seed=seed, prefix="adt")
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _low_rank(g=60, n=400, seed=9):
    """(G, N) data of rank 6 with spread singular values, plus noise: the
    six components an embed of six PCs keeps are well separated."""
    rng = np.random.default_rng(seed)
    u = np.linalg.qr(rng.normal(size=(g, 6)))[0]
    v = rng.normal(size=(6, n))
    s = np.array([40.0, 30.0, 22.0, 15.0, 10.0, 6.0])[:, None]
    return (u @ (s * v) + 0.05 * rng.normal(size=(g, n))).astype(np.float32)


def _ref_draw(f, k, seed):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (f, k),
                                        jnp.float32))


@pytest.mark.parametrize("seed", [0, 7])
def test_pca_embed_equals_the_reference_with_its_draw(seed):
    x = _low_rank()
    want = ref_common.pca_embed(x, 6, seed=seed)
    omega = omega_from_reference(_ref_draw(x.shape[0], 16, seed))
    got = common.pca_embed(x, 6, seed=seed, omega=omega, device="cpu")
    assert got.shape == want.shape == (400, 6)
    sign = np.sign(np.sum(got * want, axis=0))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got * sign, want, rtol=0, atol=1e-4 * scale)


# --------------------------------------------------------------------------
# the slice: the multi-sample refine against the reference's
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_multi_sample():
    params = dict(_TINY["multi_sample"], seed=7)
    dat, truth, batches, _, cons = multisample.multi_sample_inputs(params)
    ref_el, ref = ref_common.refine_consensus(dat, cons, True, seed=7,
                                              mesh=None)
    f = ref.de_gene_union_idx.size
    omega = omega_from_reference(_ref_draw(f, min(25, f, dat.shape[1]), 0))
    el, got = common.refine_consensus(dat, cons, True, seed=7,
                                      device="cpu", omega=omega)
    return dict(ref=ref, got=got, truth=truth, batches=batches)


def test_multi_sample_refine_equals_the_reference(tiny_multi_sample):
    ref, got = tiny_multi_sample["ref"], tiny_multi_sample["got"]
    np.testing.assert_array_equal(got.de_gene_union_idx,
                                  ref.de_gene_union_idx)
    np.testing.assert_array_equal(got.de.de_mask.numpy(),
                                  np.asarray(ref.de.de_mask))
    assert list(got.dynamic_labels) == list(ref.dynamic_labels) == \
        ["deepsplit: 1", "deepsplit: 2"]
    for key in ref.dynamic_labels:
        assert ref_ari(got.dynamic_labels[key],
                       ref.dynamic_labels[key]) == 1.0, key
    for g, r in zip(got.deep_split_info, ref.deep_split_info, strict=True):
        assert g["n_clusters"] == r["n_clusters"]
        assert abs(g["silhouette"] - r["silhouette"]) <= 1e-4
    final = common.final_labels(got)
    assert np.array_equal(final, ref_common.final_labels(ref))
    t, b = tiny_multi_sample["truth"], tiny_multi_sample["batches"]
    assert multisample.multi_sample_scores(final, t, b) == \
        ref_multisample.multi_sample_scores(
            ref_common.final_labels(ref), t, b)


# --------------------------------------------------------------------------
# wiring: the four runners produce records both validators accept
# --------------------------------------------------------------------------

def _record(out, name):
    return export.build_run_record(
        metric=out.metric, value=out.value, unit=out.unit,
        extra=dict({k: v for k, v in out.extra.items()
                    if isinstance(v, (int, float, str, bool))},
                   config=name, platform="cpu"),
        spans=out.spans, quality=out.quality, serving=out.serving,
        scenario=out.scenario, residency=out.residency,
    )


@pytest.mark.parametrize("name", sorted(_TINY))
def test_runner_records_pass_both_validators(name, tmp_path):
    out = workloads.run_scenario(name, overrides=_TINY[name], smoke=True,
                                 workdir=str(tmp_path), device="cpu")
    rec = _record(out, name)
    export.validate_run_record(rec)
    ref_export.validate_run_record(rec)
    assert rec["scenario"]["name"] == name
    assert rec["scenario"]["smoke"] is True
    assert rec["quality"]["scenario"]["name"] == name
    cs = rec["quality"]["cluster_structure"]
    assert [c["cut"] for c in cs["cuts"]] == ["deepsplit: 1",
                                              "deepsplit: 2"]
    m = rec["quality"]["scenario"]["metrics"]
    if name == "multi_sample":
        sc = rec["quality"]["scenario"]
        assert set(sc["per_batch_ari"]) == {"0", "1"}
        assert sc["batch_mixing"]["n_batches"] == 2
    elif name == "atlas_transfer":
        assert m["answered_frac"] == 1.0
        assert rec["serving"]["requests"]["submitted"] == 6
        assert out.unit == "cells/sec" and out.value > 0
    elif name == "topo_inputs":
        assert m["topo_replay_identical"] == 1.0
    elif name == "cite_dual":
        assert set(m) == {"adt_ari_vs_coarse", "rna_ari_vs_fine",
                          "final_ari_vs_fine", "final_ari_vs_coarse"}


# --------------------------------------------------------------------------
# the soak worker
# --------------------------------------------------------------------------

def test_soak_worker_resume_identity_in_process(tmp_path):
    """A second run over the same durable store adopts stage artifacts
    and reproduces the labels sha byte for byte."""
    kw = dict(n_cells=900, n_genes=100, n_clusters=3, n_samples=2, seed=7)
    first = soak.run_workload_soak(str(tmp_path), fresh=True,
                                   device="cpu", **kw)
    assert first["ok"] and not first["resumed_stages"]
    assert first["record"]["extra"]["platform"] == "cpu"
    second = soak.run_workload_soak(str(tmp_path), device="cpu", **kw)
    assert second["ok"]
    assert set(second["resumed_stages"]) >= {"de", "embed"}
    assert second["labels_sha"] == first["labels_sha"]
    assert second["record"]["scenario"]["name"] == "multi_sample"
    ref_export.validate_run_record(second["record"])
