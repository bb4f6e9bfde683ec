"""The port's out-of-core streaming layer against the JAX package's, on
the CPU: the validated ``streaming`` section, the host-memory budget, the
chunked CSR store and its on-disk format, the stream fault sites and the
streaming integrity checks.

All of it is host code (numpy, scipy, the filesystem) copied from the
reference, so the tolerance is exact: the same input gives the same
section, verdict, bytes or arrays in both packages, and a store written by
either loads in the other to equal arrays with nothing quarantined."""

import json
import os

import numpy as np
import pytest
import scipy.sparse as sp

import scconsensus_tpu.config as ref_config
from scconsensus_tpu.robust import faults as ref_faults
from scconsensus_tpu.robust import integrity as ref_integrity
from scconsensus_tpu.robust import record as ref_record
from scconsensus_tpu.stream import record as ref_stream_record
from scconsensus_tpu.stream import runner as ref_runner
from scconsensus_tpu.stream import soak as ref_soak
from scconsensus_tpu.stream.budget import (
    HostBudgetAccountant as RefAccountant,
)
from scconsensus_tpu.stream.store import ChunkedCSRStore as RefStore
from scconsensus_tpu_torch import config as port_config
from scconsensus_tpu_torch.obs import residency
from scconsensus_tpu_torch.obs.device import (
    host_peak_rss_bytes,
    host_rss_bytes,
)
from scconsensus_tpu_torch.robust import faults, integrity, record, retry
from scconsensus_tpu_torch.stream import record as stream_record
from scconsensus_tpu_torch.stream import runner, soak
from scconsensus_tpu_torch.stream.budget import (
    MB,
    HostBudgetAccountant,
    HostBudgetExceeded,
)
from scconsensus_tpu_torch.stream.store import ChunkCorrupt, ChunkedCSRStore

STREAM_FLAGS = ("SCC_STREAM_HOST_BUDGET_MB", "SCC_STREAM_STAGE_BUDGET_MB",
                "SCC_STREAM_WINDOW", "SCC_STREAM_DIR")


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    """Millisecond backoffs, no plan, no integrity mode, fresh logs."""
    monkeypatch.setenv("SCC_ROBUST_BACKOFF_S", "0.002")
    monkeypatch.delenv("SCC_FAULT_PLAN", raising=False)
    monkeypatch.delenv("SCC_INTEGRITY", raising=False)
    for mod in (faults, ref_faults):
        mod.reset()
    for mod in (record, ref_record, integrity, ref_integrity):
        mod.begin_run()
    yield
    for mod in (faults, ref_faults):
        mod.reset()


def _plan(tmp_path, rules, monkeypatch):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({"faults": rules}))
    monkeypatch.setenv("SCC_FAULT_PLAN", str(path))
    faults.reset()
    ref_faults.reset()
    return str(path)


def _random_csr(g, n, density=0.2, seed=1):
    m = sp.random(g, n, density=density, format="csr", dtype=np.float32,
                  random_state=np.random.RandomState(seed))
    m.data = np.abs(m.data) + 0.1
    return m


def _flip_byte(path):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))


# --------------------------------------------------------------------------
# the validated streaming section
# --------------------------------------------------------------------------

_SECTION = dict(planned=5, fresh=5, resumed=0, recomputed=0, quarantined=0,
                window_initial=32, window_final=32, halvings=0,
                ckpt_initial=1, ckpt_final=1, limit_mb=4096.0,
                stage_limit_mb=256.0, baseline_rss_mb=500.0,
                peak_rss_mb=600.0, peak_staged_mb=10.0, complete=True)


def _both_sections(**over):
    kw = dict(_SECTION, **over)
    return (stream_record.build_streaming_section(**kw),
            ref_stream_record.build_streaming_section(**kw))


def _set(path, value):
    def edit(sm):
        d = sm
        for k in path[:-1]:
            d = d[k]
        d[path[-1]] = value
    return edit


def _bump(path, by=1):
    def edit(sm):
        d = sm
        for k in path[:-1]:
            d = d[k]
        d[path[-1]] += by
    return edit


# the reference's rejection rules (tests/test_stream.py:224-283), each an
# edit of a clean section and the text its rejection names
REJECTIONS = {
    "no-rss-evidence": (_set(("budget", "peak_rss_mb"), None),
                        "RSS evidence"),
    "over-budget-claim": (_set(("budget", "peak_rss_mb"), 9999.0),
                          "over budget"),
    "counts-do-not-sum": (_bump(("chunks", "resumed")),
                          "chunk counts do not sum"),
    "completed-past-planned": (_set(("chunks", "planned"), 4),
                               "exceeds planned"),
    "complete-needs-all": (_set(("chunks", "planned"), 6),
                           "complete claimed"),
    "phantom-recompute": (_set(("chunks", "recomputed"), 1),
                          "phantom corruption"),
    "recompute-without-fresh": (
        lambda sm: sm["chunks"].update(fresh=0, resumed=5, recomputed=1,
                                       quarantined=1),
        "every recompute is fresh work"),
    "window-only-shrinks": (_set(("window", "final_rows"), 64),
                            "shrinks the window"),
    "window-rows-positive": (_set(("window", "final_rows"), 0),
                             "window rows must be >= 1"),
    "ckpt-only-coarsens": (_set(("ckpt", "final_every"), 0),
                           "only ever coarsens"),
    "negative-count": (_set(("chunks", "fresh"), -1), "int >= 0"),
    "non-int-count": (_set(("chunks", "fresh"), 5.0), "int >= 0"),
    "limit-positive": (_set(("budget", "limit_mb"), 0),
                       "limit_mb must be a positive number"),
    "chunks-object": (_set(("chunks",), None), "chunks must be an object"),
    "window-object": (_set(("window",), []), "window must be an object"),
    "budget-object": (_set(("budget",), "x"), "budget must be an object"),
}


@pytest.mark.parametrize("rule", sorted(REJECTIONS))
def test_validate_streaming_rejects_as_the_reference(rule):
    edit, text = REJECTIONS[rule]
    ours, ref = _both_sections()
    edit(ours)
    edit(ref)
    assert ours == ref
    with pytest.raises(ValueError) as e_ours:
        stream_record.validate_streaming(ours)
    with pytest.raises(ValueError) as e_ref:
        ref_stream_record.validate_streaming(ref)
    assert text in str(e_ours.value)
    assert str(e_ours.value) == str(e_ref.value)


@pytest.mark.parametrize("over", [
    {}, {"peak_rss_mb": 5000.0}, {"peak_rss_mb": None},
    {"baseline_rss_mb": None}, {"fresh": 3, "resumed": 2},
    {"fresh": 1, "resumed": 4, "recomputed": 1, "quarantined": 2},
    {"complete": False, "fresh": 2},
], ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()) or "clean")
def test_build_streaming_section_equals_the_reference(over):
    ours, ref = _both_sections(**over)
    assert ours == ref
    # within_budget is computed, never asserted: an honest over-budget or
    # evidence-free record validates
    stream_record.validate_streaming(ours)
    assert ours["budget"]["within_budget"] is bool(
        isinstance(ours["budget"]["peak_rss_mb"], float)
        and ours["budget"]["peak_rss_mb"] <= ours["budget"]["limit_mb"])


def test_live_feed_registers_and_clears():
    a = HostBudgetAccountant(budget_mb=1 << 14, stage_budget_mb=1 << 14)
    assert stream_record.live_summary() is None
    with a:
        assert stream_record.live_summary()["budget_bytes"] == 1 << 34
    assert stream_record.live_summary() is None
    # a failing source reads as no feed, never as an error
    stream_record.set_active(lambda: 1 / 0)
    try:
        assert stream_record.live_summary() is None
    finally:
        stream_record.set_active(None)


# --------------------------------------------------------------------------
# the flags and the host gauges
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", STREAM_FLAGS)
def test_stream_flags_match_the_reference(name, monkeypatch):
    ours, ref = port_config.ENV_FLAGS[name], ref_config.ENV_FLAGS[name]
    assert (ours.name, ours.type, ours.default, ours.doc) == (
        ref.name, ref.type, ref.default, ref.doc)
    assert port_config.env_flag(name) == ref_config.env_flag(name)
    monkeypatch.setenv(name, "48")
    assert port_config.env_flag(name) == ref_config.env_flag(name)


def test_host_rss_gauges():
    from scconsensus_tpu.obs import device as ref_device

    cur, peak = host_rss_bytes(), host_peak_rss_bytes()
    assert cur and peak and peak >= cur // 2
    # the same kernel counter as the reference's accessor
    assert abs(peak - ref_device.host_peak_rss_bytes()) <= 64 * MB


# --------------------------------------------------------------------------
# the budget accountant
# --------------------------------------------------------------------------

def _accountants(**kw):
    return HostBudgetAccountant(**kw), RefAccountant(**kw)


def test_charge_release_ledger_equals_the_reference():
    for a in _accountants(budget_mb=1 << 14, stage_budget_mb=1.0):
        a.charge(256 * 1024, "x")
        a.charge(256 * 1024, "y")
        a.release(256 * 1024, "x")
        assert a.staged == 256 * 1024 and a.peak_staged == 512 * 1024
        assert a.charges == {"y": 256 * 1024}
        assert a.consumed_s > 0


@pytest.mark.parametrize("kind", ["staged", "rss"])
def test_breach_is_typed_before_the_allocation(kind):
    kw = (dict(budget_mb=1 << 14, stage_budget_mb=1.0) if kind == "staged"
          else dict(budget_mb=1, stage_budget_mb=1 << 14))
    # the port's RSS bound is the budget over the accountant's baseline
    # (the peak RSS when it was built): a charge past the whole baseline
    # plus the 1 MB budget breaks it in both packages (a charge books
    # bytes, it allocates none)
    straw = (200 * 1024 if kind == "staged"
             else host_peak_rss_bytes() + 8 * MB)
    msgs = []
    for a in _accountants(**kw):
        if kind == "staged":
            a.charge(900 * 1024, "big")
        with pytest.raises(RuntimeError) as ei:
            a.charge(straw, "straw")
        assert ei.value.kind == kind and ei.value.what == "straw"
        # the refused charge was not booked
        assert a.staged == (900 * 1024 if kind == "staged" else 0)
        msgs.append(str(ei.value).split(" on top of ")[0])
    assert isinstance(ei.value, RuntimeError)
    assert msgs[0] == msgs[1]


def test_default_budget_is_taken_over_the_baseline_rss(monkeypatch):
    """A torch process with CUDA up starts at ~4.8 GB resident, above the
    4,096 MB default: the budget bounds what the run adds over the
    baseline, so the first charge goes through, a charge past baseline +
    budget is refused, and the section records both parts and validates
    in both packages."""
    from scconsensus_tpu_torch.obs import device as obs_device

    rss = {"cur": 4800 * MB, "peak": 4800 * MB}
    monkeypatch.setattr(obs_device, "host_rss_bytes", lambda: rss["cur"])
    monkeypatch.setattr(obs_device, "host_peak_rss_bytes",
                        lambda: rss["peak"])
    monkeypatch.delenv("SCC_STREAM_HOST_BUDGET_MB", raising=False)
    a = HostBudgetAccountant(stage_budget_mb=1 << 14)
    assert a.baseline_rss == 4800 * MB and a.limit_bytes == 4096 * MB
    a.charge(64 * MB, "first")            # 4,864 MB resident: allowed
    rss["cur"] = rss["peak"] = 4800 * MB + 4000 * MB
    a.charge(64 * MB, "inside")           # 8,864 MB: still inside
    with pytest.raises(HostBudgetExceeded) as ei:
        a.charge(200 * MB, "over")        # 9,000 MB > 4,800 + 4,096
    assert ei.value.kind == "rss"
    assert ei.value.limit_bytes == (4800 + 4096) * MB
    f = a.budget_fields()
    assert f["limit_mb"] == 4800 + 4096 and f["budget_mb"] == 4096
    assert f["baseline_rss_mb"] == 4800 and f["peak_rss_mb"] == 8800
    sec = stream_record.build_streaming_section(
        planned=1, fresh=1, resumed=0, recomputed=0, quarantined=0,
        window_initial=32, window_final=32, halvings=0, ckpt_initial=1,
        ckpt_final=1, limit_mb=f["limit_mb"],
        stage_limit_mb=f["stage_limit_mb"],
        baseline_rss_mb=f["baseline_rss_mb"], peak_rss_mb=f["peak_rss_mb"],
        peak_staged_mb=f["peak_staged_mb"], complete=True,
        budget_mb=f["budget_mb"])
    assert sec["budget"]["within_budget"] is True
    assert sec["budget"]["budget_mb"] == 4096.0
    stream_record.validate_streaming(sec)
    ref_stream_record.validate_streaming(sec)
    # the same peak against the budget alone would be over it
    assert not f["peak_rss_mb"] <= f["budget_mb"]


def test_transfers_tally_by_boundary():
    a = HostBudgetAccountant(budget_mb=1 << 14, stage_budget_mb=1 << 14)
    with a:
        with residency.boundary("input_staging"):
            residency.note_transfer("h2d", 1000)
        with residency.boundary("stream_block_fetch"):
            residency.note_transfer("d2h", 500)
        residency.note_transfer("d2h", 7)
    residency.note_transfer("d2h", 9)  # no listener: not tallied
    assert a.transfers_by_boundary == {
        "input_staging": {"to_device_bytes": 1000, "to_host_bytes": 0},
        "stream_block_fetch": {"to_device_bytes": 0, "to_host_bytes": 500},
        "<undeclared>": {"to_device_bytes": 0, "to_host_bytes": 7},
    }
    with pytest.raises(KeyError, match="undeclared residency boundary"):
        with residency.boundary("no_such_crossing"):
            pass


def test_live_summary_and_budget_fields():
    a = HostBudgetAccountant(budget_mb=1 << 14, stage_budget_mb=64)
    a.charge(MB, "x")
    a.note_progress(stage="de", chunks_done=3, chunks_planned=5)
    live = a.live_summary()
    assert live["staged_bytes"] == MB and live["chunks_done"] == 3
    f = a.budget_fields()
    assert f["peak_staged_mb"] == 1.0 and f["stage_limit_mb"] == 64.0
    assert f["peak_rss_mb"] >= f["baseline_rss_mb"] > 0


# --------------------------------------------------------------------------
# the chunk store and its on-disk format
# --------------------------------------------------------------------------

def _fill(cls, root, full, w):
    st = cls.create(str(root), full.shape[0], full.shape[1], w)
    for i in range(st.n_chunks):
        g0, g1 = st.chunk_rows(i)
        st.write_chunk(i, full[g0:g1])
    return st


def test_round_trip(tmp_path):
    full = _random_csr(37, 100)
    st = _fill(ChunkedCSRStore, tmp_path / "cs", full, 8)
    assert st.n_chunks == 5
    back = sp.vstack([st.load_chunk(i) for i in range(st.n_chunks)])
    assert (back != full).nnz == 0
    meta = json.load(open(tmp_path / "cs" / "chunk_00000.json"))
    assert meta["_integrity"]["sha256"] and meta["nnz"] == full[:8].nnz
    assert (meta["g0"], meta["g1"]) == (0, 8)
    with np.load(tmp_path / "cs" / "chunk_00000.npz") as z:
        assert z["indices"].dtype == np.int64
        assert z["indptr"].dtype == np.int64 and z["data"].dtype == np.float32


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_stores_cross_between_the_packages(tmp_path, writer):
    full = _random_csr(29, 120, seed=4)
    wcls, rcls = ((ChunkedCSRStore, RefStore) if writer == "port"
                  else (RefStore, ChunkedCSRStore))
    st = _fill(wcls, tmp_path / "cs", full, 8)
    other = rcls(str(tmp_path / "cs"))
    assert other.manifest() == st.manifest() and other.shape == (29, 120)
    for i in range(st.n_chunks):
        got, want = other.load_chunk(i), st.load_chunk(i)
        for f in ("data", "indices", "indptr"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert got.shape == want.shape
        assert other.chunk_host_bytes(i) == st.chunk_host_bytes(i)
    other.adopt_durable()
    assert other.counters == {"fresh": 0, "resumed": st.n_chunks,
                              "recomputed": 0, "quarantined": 0}
    assert not any(".quarantined-" in n for n in os.listdir(tmp_path / "cs"))


def test_shape_mismatch_refused(tmp_path):
    ChunkedCSRStore.create(str(tmp_path / "cs"), 10, 20, 4)
    with pytest.raises(ValueError, match="different matrix shape"):
        ChunkedCSRStore.create(str(tmp_path / "cs"), 10, 21, 4)


@pytest.mark.parametrize("damage", ["flip", "truncate", "sidecar"])
def test_damaged_chunk_quarantines_and_recomputes(tmp_path, damage):
    full = _random_csr(16, 60)
    _fill(ChunkedCSRStore, tmp_path / "cs", full, 8)
    npz = str(tmp_path / "cs" / "chunk_00001.npz")
    if damage == "flip":
        _flip_byte(npz)
    elif damage == "truncate":
        with open(npz, "r+b") as f:
            f.truncate(os.path.getsize(npz) // 2)
    else:
        with open(npz[:-4] + ".json", "w") as f:
            f.write("{not json")
    st = ChunkedCSRStore(str(tmp_path / "cs"))
    with pytest.raises(ChunkCorrupt, match="quarantined"):
        st.load_chunk(1)
    assert any(".quarantined-" in n for n in os.listdir(tmp_path / "cs"))
    assert not st.has_chunk(1)
    block = st.ensure_chunk(1, lambda g0, g1: full[g0:g1])
    assert (block != full[8:16]).nnz == 0
    assert st.counters["fresh"] == 1
    # without a generator a corrupt chunk propagates typed
    _flip_byte(npz)
    st2 = ChunkedCSRStore(str(tmp_path / "cs"))
    with pytest.raises(ChunkCorrupt):
        st2.ensure_chunk(1)
    assert st2.counters["quarantined"] == 1


def test_counters_sum_and_reclassify(tmp_path):
    full = _random_csr(16, 50)
    gen = lambda g0, g1: full[g0:g1]  # noqa: E731
    counters = []
    for cls in (ChunkedCSRStore, RefStore):
        root = str(tmp_path / cls.__module__.split(".")[0])
        st = cls.create(root, 16, 50, 8)
        st.ingest(gen)
        st2 = cls(root)
        st2.ingest(gen)
        assert st2.counters["resumed"] == 2
        with open(os.path.join(root, "chunk_00000.npz"), "r+b") as f:
            f.seek(10)
            f.write(b"\xff\xff")
        st2.ensure_chunk(0, gen)
        counters.append((dict(st.counters), dict(st2.counters)))
    assert counters[0] == counters[1]
    assert counters[0][1] == {"fresh": 1, "resumed": 1, "recomputed": 1,
                              "quarantined": 1}


def test_mid_ingest_store_resumes_exactly_the_rest(tmp_path):
    full = _random_csr(40, 30)
    gen = lambda g0, g1: full[g0:g1]  # noqa: E731
    st = ChunkedCSRStore.create(str(tmp_path / "cs"), 40, 30, 8)
    for i in (0, 2):
        st.ensure_chunk(i, gen)
    assert st.completed_chunks() == 2
    st2 = ChunkedCSRStore(str(tmp_path / "cs"))
    assert st2.ingest(gen) == 3
    assert st2.counters == {"fresh": 3, "resumed": 2, "recomputed": 0,
                            "quarantined": 0}


# --------------------------------------------------------------------------
# keys and generators, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(0, 0, 32, 1200, "ab:10:3:None:5"),
                                  (7, 224, 256, 10_000_000, "x" * 40)])
def test_chunk_key_equals_the_reference(args):
    assert runner._chunk_key(*args) == ref_runner._chunk_key(*args)


@pytest.mark.parametrize("shape", [(96, 1200, 3, 5, 0.25),
                                   (64, 4000, 16, 11, 0.02)])
def test_chunk_generator_equals_the_reference(shape):
    g, n, k, seed, density = shape
    ours = soak.chunk_generator(g, n, k, seed, density=density)
    ref = ref_soak.chunk_generator(g, n, k, seed, density=density)
    for g0, g1 in ((0, 32), (17, 40), (g - 5, g)):
        a, b = ours(g0, g1), ref(g0, g1)
        for f in ("data", "indices", "indptr"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(soak.truth_labels(n, k, seed),
                                  ref_soak.truth_labels(n, k, seed))
    lab = soak.consensus_input(n, k, seed)
    np.testing.assert_array_equal(lab, ref_soak.consensus_input(n, k, seed))
    assert runner._labels_sha(lab) == ref_runner._labels_sha(lab)
    cuts = {"deepsplit: 1": np.arange(n) % 3, "deepsplit: 2": np.arange(n)}
    assert soak._labels_sha(cuts) == ref_soak._labels_sha(cuts)


def test_chunk_aggregates_equal_the_reference():
    block = ref_soak.chunk_generator(40, 900, 3, 2)(0, 40)
    cid = np.random.default_rng(0).integers(-1, 3, 900).astype(np.int32)
    ours = runner._chunk_aggregates(block, cid, 3)
    ref = ref_runner._chunk_aggregates(block, cid, 3)
    for f in ref:
        np.testing.assert_array_equal(ours[f], ref[f])


def test_gram_pca_equals_the_reference():
    full = ref_soak.chunk_generator(40, 600, 3, 9)(0, 40)
    union = np.array([1, 2, 5, 9, 17, 18, 30, 39])

    class _Store:
        shape = (40, 600)
        n_chunks = 5

        @staticmethod
        def chunk_rows(i):
            return i * 8, (i + 1) * 8

    def load_part(i):
        g0, g1 = _Store.chunk_rows(i)
        sel = np.nonzero((union >= g0) & (union < g1))[0]
        return full[g0:g1][union[sel] - g0], sel

    acct = HostBudgetAccountant(budget_mb=1 << 14, stage_budget_mb=1 << 10)
    ours = runner._gram_pca_streamed(_Store, union, acct, 5, load_part)
    ref = ref_runner._gram_pca_streamed(
        _Store, union, RefAccountant(budget_mb=1 << 14,
                                     stage_budget_mb=1 << 10), 5, load_part)
    np.testing.assert_array_equal(ours, ref)
    assert acct.charges == {"scores": 600 * 5 * 4}


# --------------------------------------------------------------------------
# the stream fault sites
# --------------------------------------------------------------------------

@pytest.mark.parametrize("site", ["stream_chunk_read", "stream_chunk_write",
                                  "stream_stage"])
def test_stream_sites_fire_their_faults(site, tmp_path, monkeypatch):
    """The sites the port refused before the streaming layer was ported
    now fire (the scaffold's stream_chunk_read case, and the robust
    suite's stream_stage and stream_chunk_write cases, moved here)."""
    _plan(tmp_path, [{"site": site, "class": "disk"}], monkeypatch)
    with pytest.raises(faults.InjectedDiskFault, match="No space left"):
        faults.fault_point(site)
    faults.fault_point(site)  # times=1: the second visit passes
    assert record.current_run().faults[0]["site"] == site


def test_chunk_read_fault_at_load(tmp_path, monkeypatch):
    st = _fill(ChunkedCSRStore, tmp_path / "cs", _random_csr(8, 20), 8)
    _plan(tmp_path, [{"site": "stream_chunk_read", "class": "transient"}],
          monkeypatch)
    with pytest.raises(faults.InjectedTransientError):
        st.load_chunk(0)
    assert st.load_chunk(0).shape == (8, 20)


def test_disk_fault_on_chunk_write_sweeps_and_retries(tmp_path, monkeypatch):
    full = _random_csr(16, 30)
    st = ChunkedCSRStore.create(str(tmp_path / "cs"), 16, 30, 8)
    corpse = tmp_path / "cs" / "chunk_00009.npz.quarantined-0"
    corpse.write_bytes(b"x" * 100)
    _plan(tmp_path, [{"site": "stream_chunk_write", "class": "disk"}],
          monkeypatch)
    st.write_chunk(0, full[:8])
    assert not corpse.exists()
    assert (st.load_chunk(0) != full[:8]).nnz == 0
    run = record.current_run()
    assert run.retries[0]["error_class"] == "disk"
    assert run.retries[0]["recovered"]
    assert run.degradations[0]["action"] == "sweep-reclaimable"


def test_kill_at_chunk_write_leaves_durable_chunks(tmp_path):
    import subprocess
    import sys

    plan = tmp_path / "kill.json"
    plan.write_text(json.dumps({"faults": [
        {"site": "stream_chunk_write", "class": "kill", "after": 2}]}))
    code = (
        "import sys\n"
        "from scconsensus_tpu_torch.stream.store import ChunkedCSRStore\n"
        "from scconsensus_tpu_torch.stream.soak import chunk_generator\n"
        "st = ChunkedCSRStore.create(sys.argv[1], 40, 200, 8)\n"
        "st.ingest(chunk_generator(40, 200, 3, 1))\n"
        "print('survived')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "cs")], cwd=repo,
        env={**os.environ, "SCC_FAULT_PLAN": str(plan)},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == -9 and "survived" not in out.stdout
    st = ChunkedCSRStore(str(tmp_path / "cs"))
    assert st.completed_chunks() == 2
    gen = soak.chunk_generator(40, 200, 3, 1)
    assert st.ingest(gen) == 3
    for i in range(st.n_chunks):
        assert (st.load_chunk(i) != gen(*st.chunk_rows(i))).nnz == 0


def test_torn_chunk_plan_is_caught_at_load(tmp_path, monkeypatch):
    _plan(tmp_path, [{"site": "artifact:stream_chunk", "class": "corrupt",
                      "mode": "flip"}], monkeypatch)
    st = _fill(ChunkedCSRStore, tmp_path / "cs", _random_csr(8, 40), 8)
    with pytest.raises(ChunkCorrupt, match="torn chunk"):
        st.load_chunk(0)


@pytest.mark.parametrize("mode", ["scale", "signflip"])
def test_stream_block_corruption_equals_the_reference(mode, tmp_path,
                                                      monkeypatch):
    rng = np.random.default_rng(3)
    lp = -rng.random((6, 10)).astype(np.float32)
    u = (rng.random((6, 10)) * 100).astype(np.float32)
    _plan(tmp_path, [{"site": "stream_block", "class": "corruption",
                      "mode": mode}], monkeypatch)
    ours = faults.corrupt_value("stream_block", (lp.copy(), u.copy()))
    ref = ref_faults.corrupt_value("stream_block", (lp.copy(), u.copy()))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(ours[0], lp)
    np.testing.assert_array_equal(ours[1], u)


def test_chunk_corrupt_classifies_disk():
    assert retry.classify_exception(ChunkCorrupt(
        "chunk 1: torn chunk — content checksum mismatch; "
        "quarantined")) == "disk"
    assert retry.classify_exception(HostBudgetExceeded(
        "staged", 1, 2, 3, "chunk")) == "fatal"


# --------------------------------------------------------------------------
# the streaming integrity checks
# --------------------------------------------------------------------------

def _block_and_outputs():
    """One chunk's slab and its (P, Gb) log p and U from the reference's
    float64 oracle (the port's own check runs over what it is handed)."""
    block = ref_soak.chunk_generator(6, 300, 3, 4)(0, 6)
    cids = ref_soak.truth_labels(300, 3, 4).astype(np.int32)
    n_of = np.bincount(cids, minlength=3).astype(np.int32)
    pair_i, pair_j = np.array([0, 0, 1]), np.array([1, 2, 2])
    lp = np.zeros((3, 6), np.float32)
    u = np.zeros((3, 6), np.float32)
    rows = block.toarray()
    for p, (i, j) in enumerate(zip(pair_i, pair_j)):
        for g in range(6):
            sel = (cids == i) | (cids == j)
            lp[p, g], u[p, g] = integrity.wilcox_oracle_pair(
                rows[g][sel], cids[sel], int(n_of[i]), int(n_of[j]), i, j,
                pad_zeros=False)
    return block, cids, n_of, pair_i, pair_j, lp, u


@pytest.mark.parametrize("corrupt", [None, "signflip-lp", "u-past-bound"])
def test_stream_checks_settle_as_the_reference(corrupt, monkeypatch):
    monkeypatch.setenv("SCC_INTEGRITY", "audit")
    block, cids, n_of, pi, pj, lp, u = _block_and_outputs()
    if corrupt == "signflip-lp":
        lp = lp.copy()
        lp.flat[np.argmax(np.abs(lp))] *= -1
    elif corrupt == "u-past-bound":
        u = u * 3.0
    sections = []
    for mod in (integrity, ref_integrity):
        mod.begin_run()
        mod.check_wilcox_host("stream_block", lp, u, n_of[pi], n_of[pj])
        assert mod.current().want_replay("stream_chunk", 0)
        mod.replay_stream_chunk("stream_block", "chunk:0", block, cids,
                                n_of, pi, pj, lp, u)
        sec = mod.section()
        sec.pop("consumed_s", None)
        sections.append(sec)
    assert sections[0] == sections[1]
    assert sections[0]["all_checks_passed"] is (corrupt is None)


def test_stream_checks_raise_typed_in_enforce(monkeypatch):
    monkeypatch.setenv("SCC_INTEGRITY", "enforce")
    block, cids, n_of, pi, pj, lp, u = _block_and_outputs()
    integrity.check_wilcox_host("stream_block", lp, u, n_of[pi], n_of[pj])
    integrity.replay_stream_chunk("stream_block", "chunk:0", block, cids,
                                  n_of, pi, pj, lp, u)
    bad = lp.copy()
    bad.flat[np.argmax(np.abs(bad))] *= -1
    with pytest.raises(integrity.InvariantViolation):
        integrity.check_wilcox_host("stream_block", bad, u, n_of[pi],
                                    n_of[pj])
    with pytest.raises(integrity.GhostReplayMismatch):
        integrity.replay_stream_chunk("stream_block", "chunk:0", block,
                                      cids, n_of, pi, pj, lp * 1.5, u)
    assert retry.classify_exception(
        integrity.InvariantViolation("x")) == "silent_corruption"


# --------------------------------------------------------------------------
# the landmark engine's budget hook
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["landmark_pool", "landmark_ward_linkage"])
def test_landmark_staging_is_charged_as_the_reference(fn):
    from scconsensus_tpu.ops import pooling as ref_pooling
    from scconsensus_tpu_torch.ops import pooling

    x = np.random.default_rng(2).normal(size=(600, 5)).astype(np.float32)
    calls = {"port": [], "reference": []}
    getattr(pooling, fn)(x, n_landmarks=16, sketch=300, device="cpu",
                         charge=lambda nb, what: calls["port"].append(
                             (nb, what)))
    getattr(ref_pooling, fn)(x, n_landmarks=16, sketch=300,
                             charge=lambda nb, what: calls[
                                 "reference"].append((nb, what)))
    assert calls["port"] == calls["reference"] == [
        (600 * 5 * 4, "landmark_staging")]
    # a charge past the budget raises typed before the staging exists
    acct = HostBudgetAccountant(budget_mb=1 << 14, stage_budget_mb=0.001)
    with pytest.raises(HostBudgetExceeded) as ei:
        getattr(pooling, fn)(x, n_landmarks=16, sketch=300, device="cpu",
                             charge=acct.charge)
    assert ei.value.what == "landmark_staging"
