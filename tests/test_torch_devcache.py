"""The port's upload cache (``utils/devcache.py``) against the JAX
package's, on the CPU.

One scripted sequence of uploads runs through both packages, and the
hit/miss trace (and the cache's size after each step) must be equal: a
hit on the same array; a miss after an in-place edit the strided sample
catches, and after one only the full sum catches (one zeroed gene row);
the FIFO cap of 2; an entry dying with its array; NaN baselines; an
object that cannot be weakly referenced, uploaded and not cached. Then
the port's wiring: ``as_device_matrix`` reaches the cache, an
``input_staging`` OOM plan degrades through ``evict-devcache`` on both
the matrix's upload and a direct call, and an elastic shrink and the
embed's OOM degrade clear the cache. Exact: a trace is a list of words.
"""

import gc

import numpy as np
import pytest
import torch

from scconsensus_tpu.utils import devcache as ref_devcache
from scconsensus_tpu_torch.robust import faults, record
from scconsensus_tpu_torch.utils import devcache

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _empty_caches(monkeypatch):
    monkeypatch.delenv("SCC_FAULT_PLAN", raising=False)
    monkeypatch.setenv("SCC_ROBUST_BACKOFF_S", "0.002")
    for mod in (devcache, ref_devcache):
        mod.clear_cache()
    faults.reset()
    record.begin_run()
    yield
    for mod in (devcache, ref_devcache):
        mod.clear_cache()
    faults.reset()


class _Side:
    """One package's cache, driven by name: ``put`` uploads and returns
    "hit" when the call returned the buffer the cache held for that array
    before it, else "miss"."""

    def __init__(self, mod, port: bool):
        self.mod, self.port = mod, port

    def _key(self, x):
        return (id(x), str(CPU)) if self.port else id(x)

    def put(self, x):
        ent = self.mod._cache.get(self._key(x))
        before = ent.buf if ent is not None else None
        out = (self.mod.device_put_cached(x, CPU) if self.port
               else self.mod.device_put_cached(x))
        want = x.astype(np.float32) if x.dtype == np.float64 else x
        np.testing.assert_array_equal(np.asarray(out), want)
        return "hit" if before is not None and out is before else "miss"

    def size(self):
        return len(self.mod._cache)


def _script(side: _Side) -> list:
    trace = []

    def step(word, x):
        trace.append((word, side.put(x), side.size()))

    rng = np.random.default_rng(0)
    # 9,000 genes x 8 cells: the strided sample takes every 17th element,
    # so gene row 1 (elements 8..15) lies between two samples
    x = rng.random((9000, 8), dtype=np.float32) + 0.5
    step("first", x)
    step("again", x)
    x[0, 0] += 1.0  # element 0 is sampled
    step("sample-edit", x)
    step("after-sample-edit", x)
    digest = side.mod._sample_hash(x)
    x[1, :] = 0.0  # a whole gene row the sample does not see
    assert side.mod._sample_hash(x) == digest
    step("row-zeroed", x)
    step("after-row-zeroed", x)
    # the cap: two more arrays push x out (FIFO)
    y = np.ones((6, 5), np.float32)
    z = np.full((6, 5), 2.0, np.float32)
    step("y", y)
    step("z", z)
    step("x-after-cap", x)
    step("z-kept", z)
    # an entry dies with its array: float64 input uploads a narrowed copy
    # in both packages, so the buffer does not hold the host array
    w = rng.random((7, 3))
    step("w", w)
    del w
    gc.collect()
    trace.append(("w-gone", None, side.size()))
    # NaN baselines count as equal
    n = np.full((4, 4), np.nan, np.float32)
    step("nan", n)
    step("nan-again", n)
    return trace


def test_the_hit_and_miss_trace_equals_the_reference():
    ours = _script(_Side(devcache, port=True))
    ref = _script(_Side(ref_devcache, port=False))
    assert ours == ref
    words = {w: hit for w, hit, _ in ours}
    assert words["again"] == "hit" and words["first"] == "miss"
    assert words["sample-edit"] == words["row-zeroed"] == "miss"
    assert words["after-row-zeroed"] == "hit"
    assert words["x-after-cap"] == "miss" and words["z-kept"] == "hit"
    assert words["nan-again"] == "hit"
    assert max(size for *_, size in ours) == 2


class _NoWeakref:
    @staticmethod
    def ref(*_a, **_k):
        raise TypeError("cannot create weak reference")


def test_an_object_without_weak_references_is_uploaded_not_cached(
        monkeypatch):
    traces = []
    for side in (_Side(devcache, port=True), _Side(ref_devcache, port=False)):
        monkeypatch.setattr(side.mod, "weakref", _NoWeakref)
        x = np.arange(12, dtype=np.float32).reshape(3, 4)
        traces.append([side.put(x), side.put(x), side.size()])
    assert traces[0] == traces[1] == ["miss", "miss", 0]


def test_a_tensor_on_the_device_is_returned_as_it_is():
    t = torch.ones(3, 4)
    assert devcache.device_put_cached(t, "cpu") is t
    assert devcache._cache == {}


def test_the_uploaded_dtype_is_the_references():
    for dtype in (np.float64, np.float32, np.int64, np.int32, np.uint8):
        x = np.arange(6, dtype=dtype).reshape(2, 3)
        ours = devcache.device_put_cached(x, "cpu")
        ref = ref_devcache.device_put_cached(x)
        assert str(ours.dtype).replace("torch.", "") == str(ref.dtype)


def test_the_key_names_the_device():
    x = np.ones((4, 4), np.float32)
    devcache.device_put_cached(x, "cpu")
    assert list(devcache._cache) == [(id(x), "cpu")]


def test_the_matrix_upload_of_a_run_goes_through_the_cache():
    from scconsensus_tpu_torch.de.engine import as_device_matrix

    x = np.random.default_rng(1).random((20, 30), dtype=np.float32)
    devcache.reset_stats()
    a = as_device_matrix(x, CPU)
    b = as_device_matrix(x, CPU)
    assert a is b and a.dtype == torch.float32
    assert devcache.STATS == {"hits": 1, "misses": 1}
    # CSR input and tensors keep their own paths
    import scipy.sparse as sp

    as_device_matrix(sp.csr_matrix(x), CPU)
    as_device_matrix(torch.from_numpy(x), CPU)
    assert devcache.STATS == {"hits": 1, "misses": 1}


def _oom_plan(tmp_path, monkeypatch):
    import json

    path = tmp_path / "plan.json"
    path.write_text(json.dumps(
        {"faults": [{"site": "input_staging", "class": "oom"}]}))
    monkeypatch.setenv("SCC_FAULT_PLAN", str(path))
    faults.reset()


def test_an_input_staging_oom_evicts_the_cache_and_uploads_again(
        tmp_path, monkeypatch):
    from scconsensus_tpu.robust import faults as ref_faults
    from scconsensus_tpu.robust import record as ref_record

    keep = np.ones((5, 5), np.float32)
    devcache.device_put_cached(keep, CPU)
    ref_devcache.device_put_cached(keep)
    assert len(devcache._cache) == len(ref_devcache._cache) == 1
    _oom_plan(tmp_path, monkeypatch)
    ref_faults.reset()
    ref_record.begin_run()
    x = np.arange(20, dtype=np.float32).reshape(4, 5)
    try:
        out = devcache.device_put_cached(x, CPU)
        ref_devcache.device_put_cached(x)
        sec, ref_sec = record.section(), ref_record.section()
    finally:
        ref_faults.reset()
    np.testing.assert_array_equal(out.numpy(), x)
    # the degrade dropped the earlier entry; the re-upload is cached
    assert list(devcache._cache) == [(id(x), "cpu")]
    assert list(ref_devcache._cache) == [id(x)]
    assert [(d["site"], d["action"], d["detail"])
            for d in sec["degradations"]] == [
        ("input_staging", "evict-devcache",
         "dropped every pinned device buffer before re-upload")]
    assert sec["degradations"] == ref_sec["degradations"]
    assert any(r["site"] == "input_staging" and r["recovered"]
               and r["error_class"] == "resource" for r in sec["retries"])


def test_an_input_staging_oom_in_a_run_degrades_through_the_cache(
        tmp_path, monkeypatch):
    import scconsensus_tpu_torch as port
    from scconsensus_tpu_torch.utils.synthetic import synthetic_scrna

    data, truth, _ = synthetic_scrna(n_genes=120, n_cells=240, n_clusters=3,
                                     seed=3)
    labels = np.array([f"c{v}" for v in truth])
    _oom_plan(tmp_path, monkeypatch)
    res = port.refine(data, labels, port.ReclusterConfig(
        deep_split_values=(1,)), device="cpu")
    rb = res.metrics["robustness"]
    assert [(d["site"], d["action"]) for d in rb["degradations"]] == [
        ("input_staging", "evict-devcache")]
    assert (id(data), "cpu") in devcache._cache


def test_an_elastic_shrink_clears_the_cache():
    from scconsensus_tpu_torch.parallel.mesh import make_mesh
    from scconsensus_tpu_torch.robust.elastic import ElasticMeshSupervisor

    x = np.ones((5, 5), np.float32)
    devcache.device_put_cached(x, CPU)
    sup, mesh = ElasticMeshSupervisor.resolve(make_mesh(4, device="cpu"))
    assert mesh.size == 4 and len(devcache._cache) == 1
    sup.shrink("sharded:ranksum")
    assert sup.mesh.size == 2 and devcache._cache == {}


def test_the_embed_oom_degrade_clears_the_cache(tmp_path, monkeypatch):
    import json

    import scconsensus_tpu_torch as port
    from scconsensus_tpu_torch.utils.synthetic import synthetic_scrna

    data, truth, _ = synthetic_scrna(n_genes=120, n_cells=240, n_clusters=3,
                                     seed=3)
    labels = np.array([f"c{v}" for v in truth])
    cleared = []
    real = devcache.clear_cache
    monkeypatch.setattr(devcache, "clear_cache",
                        lambda: (cleared.append(len(devcache._cache)),
                                 real()))
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(
        {"faults": [{"site": "stage:embed", "class": "oom"}]}))
    monkeypatch.setenv("SCC_FAULT_PLAN", str(path))
    faults.reset()
    res = port.refine(data, labels, port.ReclusterConfig(
        deep_split_values=(1,)), device="cpu")
    # the matrix's entry was there when the degrade dropped it
    assert cleared == [1] and devcache._cache == {}
    rb = res.metrics["robustness"]
    assert ("stage:embed", "evict-devcache") in [
        (d["site"], d["action"]) for d in rb["degradations"]]
