"""The port's artifact store and stage resume against the JAX package's, on
the CPU: atomic writes, the reference's 12 files with the reference's
keys, resume, refusal of another config or other input, quarantine of a
corrupt artifact, and stores that cross between the two packages in both
directions."""

import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import scconsensus_tpu.models.pipeline as ref_pl
from scconsensus_tpu.config import ReclusterConfig as RefConfig
from scconsensus_tpu.utils import artifacts as ref_artifacts
from scconsensus_tpu.utils.synthetic import synthetic_scrna
import scconsensus_tpu_torch as port
from scconsensus_tpu_torch.carry import config_from_reference
from scconsensus_tpu_torch.de.engine import PairwiseDEResult
from scconsensus_tpu_torch.io.sparsemat import DeviceCSR
from scconsensus_tpu_torch.models import pipeline
from scconsensus_tpu_torch.utils import artifacts
from scconsensus_tpu_torch.utils.artifacts import (
    ArtifactCorrupt,
    ArtifactStore,
)

CPU = torch.device("cpu")
FILES = sorted(["config.json", "robust_state.json"]
               + [f"{s}.{e}" for s in ("de", "union", "embed", "tree", "cuts")
                  for e in ("npz", "json")])


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs six workers on the machine's cores; two torch threads
    # a worker keep these small tensors from crowding out the other files
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    """200 genes × 400 cells × 4 clusters."""
    data, truth, _ = synthetic_scrna(n_genes=200, n_cells=400, n_clusters=4,
                                     seed=7)
    return data, np.array([f"c{v}" for v in truth])


def _configs(store_dir, **kw):
    """The same configuration in both packages (the JSON crosses)."""
    ref = RefConfig(artifact_dir=str(store_dir), deep_split_values=(1, 2),
                    **kw)
    return ref, config_from_reference(ref.to_json())


def _poison(monkeypatch, module, names):
    def boom(*a, **kw):
        raise AssertionError("a stage ran on resume")

    for n in names:
        monkeypatch.setattr(module, n, boom)


def _same_result(a, b):
    np.testing.assert_array_equal(a.de_gene_union_idx, b.de_gene_union_idx)
    assert a.dynamic_labels.keys() == b.dynamic_labels.keys()
    for key in a.dynamic_labels:
        np.testing.assert_array_equal(a.dynamic_labels[key],
                                      b.dynamic_labels[key])
    for x, y in zip(a.deep_split_info, b.deep_split_info):
        assert x["silhouette"] == y["silhouette"]


def _keys(root):
    """{file: array keys (npz) or top-level keys (json)}."""
    out = {}
    for n in sorted(os.listdir(root)):
        path = os.path.join(root, n)
        if n.endswith(".npz"):
            with np.load(path) as z:
                out[n] = sorted(z.files)
        else:
            with open(path) as f:
                out[n] = sorted(json.load(f))
    return out


def test_a_failed_save_leaves_no_partial_file(tmp_path, monkeypatch):
    store = ArtifactStore(str(tmp_path))

    def boom(*a, **kw):
        raise RuntimeError("disk full")

    monkeypatch.setattr(np, "savez_compressed", boom)
    with pytest.raises(RuntimeError):
        store.save("de", arrays={"x": np.arange(4)}, meta={"k": 1})
    monkeypatch.undo()
    assert not store.has("de")
    assert not [n for n in os.listdir(tmp_path)
                if n.startswith(artifacts._TMP_PREFIX)]
    store.save("de", arrays={"x": np.arange(4)})
    arrays, meta = store.load("de")
    np.testing.assert_array_equal(arrays["x"], np.arange(4))
    assert set(meta) == {"_integrity"}


def test_stale_temp_files_are_swept_on_open(tmp_path):
    stale = tmp_path / f"{artifacts._TMP_PREFIX}dead"
    stale.write_bytes(b"half-written")
    fresh = tmp_path / f"{artifacts._TMP_PREFIX}live"
    fresh.write_bytes(b"another writer, mid-write")
    old = os.path.getmtime(stale) - 7200
    os.utime(stale, (old, old))
    ArtifactStore(str(tmp_path))
    assert not stale.exists()
    assert fresh.exists()


def test_each_corrupt_copy_is_kept_under_its_own_name(tmp_path):
    store = ArtifactStore(str(tmp_path))
    for n in range(2):
        store.save("cuts", {"ds1": np.arange(3)})
        path = tmp_path / "cuts.npz"
        path.write_bytes(path.read_bytes()[:-5])
        with pytest.raises(ArtifactCorrupt):
            store.load("cuts")
        assert not store.has("cuts")
    assert sorted(n for n in os.listdir(tmp_path) if "quarantined" in n) == [
        f"cuts.{e}.quarantined-{n}" for e in ("json", "npz")
        for n in range(2)]


def test_load_many_reads_in_parallel_and_quarantines_nothing(tmp_path):
    """``load_many`` gives what ``load`` gives, None for a stage that
    fails its checksum, and leaves that stage's files in place; a
    ``load`` of it then quarantines it."""
    store = ArtifactStore(str(tmp_path))
    for i in range(5):
        store.save(f"blk_{i}", {"a": np.arange(1000) * i}, meta={"i": i},
                   compress=bool(i % 2))
    npz = tmp_path / "blk_3.npz"
    raw = bytearray(npz.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    npz.write_bytes(bytes(raw))
    assert store.stages_with_prefix("blk_") == [f"blk_{i}" for i in range(5)]
    got = store.load_many(store.stages_with_prefix("blk_"))
    assert got["blk_3"] is None
    for i in (0, 1, 2, 4):
        arrays, meta = got[f"blk_{i}"]
        np.testing.assert_array_equal(arrays["a"], np.arange(1000) * i)
        assert meta["i"] == i
    assert store.has("blk_3")
    with pytest.raises(ArtifactCorrupt):
        store.load("blk_3")
    assert not store.has("blk_3")
    assert store.stages_with_prefix("blk_") == ["blk_0", "blk_1", "blk_2",
                                                "blk_4"]


def test_the_sidecar_checksum_is_the_reference_s(tmp_path):
    ArtifactStore(str(tmp_path)).save("union", {"idx": np.arange(5)},
                                      meta={"k": 1})
    with open(tmp_path / "union.json") as f:
        integrity = json.load(f)["_integrity"]
    npz = str(tmp_path / "union.npz")
    assert integrity == {"sha256": artifacts.file_sha256(npz),
                         "size": os.path.getsize(npz)}
    # the reference verifies it, and refuses the same file flipped
    ref = ref_artifacts.ArtifactStore(str(tmp_path))
    np.testing.assert_array_equal(ref.load("union")[0]["idx"], np.arange(5))
    with open(npz, "r+b") as f:
        f.seek(os.path.getsize(npz) // 2)
        f.write(b"\xff" * 8)
    with pytest.raises(ref_artifacts.ArtifactCorrupt):
        ref.load("union")


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_checksums_follow_scc_robust_checksum(tmp_path, monkeypatch, pkg):
    """SCC_ROBUST_CHECKSUM=0: saves stamp no _integrity and loads verify
    none, so an arrays file replaced behind a checksummed sidecar loads;
    with the default (on) the same store refuses it. Both packages give
    the same verdicts."""
    mod = artifacts if pkg == "port" else ref_artifacts
    monkeypatch.setenv("SCC_ROBUST_CHECKSUM", "0")
    off = mod.ArtifactStore(str(tmp_path / "off"))
    off.save("union", {"idx": np.arange(5)}, meta={"k": 1})
    with open(tmp_path / "off" / "union.json") as f:
        assert json.load(f) == {"k": 1}
    off.save("bare", {"idx": np.arange(3)})
    assert not os.path.exists(tmp_path / "off" / "bare.json")
    np.testing.assert_array_equal(off.load("bare")[0]["idx"], np.arange(3))

    monkeypatch.delenv("SCC_ROBUST_CHECKSUM")
    root = tmp_path / "on"
    on = mod.ArtifactStore(str(root))
    on.save("union", {"idx": np.arange(5)}, meta={"k": 1})
    with open(root / "union.json") as f:
        assert "_integrity" in json.load(f)
    # other valid arrays behind the old sidecar
    with open(root / "union.npz", "wb") as f:
        np.savez_compressed(f, idx=np.arange(7))
    monkeypatch.setenv("SCC_ROBUST_CHECKSUM", "0")
    np.testing.assert_array_equal(mod.ArtifactStore(str(root)).load(
        "union")[0]["idx"], np.arange(7))
    monkeypatch.delenv("SCC_ROBUST_CHECKSUM")
    with pytest.raises(mod.ArtifactCorrupt, match="checksum mismatch"):
        mod.ArtifactStore(str(root)).load("union")


@pytest.mark.parametrize("kind", ["numpy", "tensor", "csr", "device_csr"])
def test_input_fingerprint_equals_the_reference(case, kind):
    data, labels = case
    data = data.copy()
    data[0, :50] = 0.0
    m = sp.csr_matrix(data)
    want = ref_artifacts.input_fingerprint(m if "csr" in kind else data,
                                           labels)
    got = artifacts.input_fingerprint(
        {"numpy": data, "tensor": torch.from_numpy(data), "csr": m,
         "device_csr": DeviceCSR.from_scipy(m, CPU)}[kind], labels)
    assert got == want


def test_file_sha_equals_the_reference(tmp_path):
    p = tmp_path / "f.bin"
    p.write_bytes(os.urandom(3 << 20))
    assert artifacts.file_sha256(str(p)) == ref_artifacts.file_sha256(str(p))


@pytest.fixture(scope="module")
def ref_store(case, tmp_path_factory):
    """A reference run with its store (and the store's directory)."""
    data, labels = case
    root = tmp_path_factory.mktemp("ref") / "store"
    rc, _ = _configs(root)
    return root, ref_pl.refine(data, labels, rc, mesh=None)


def test_the_port_writes_the_reference_files_and_keys(case, ref_store,
                                                      tmp_path):
    data, labels = case
    root = tmp_path / "store"
    _, cfg = _configs(root)
    port.refine(data, labels, cfg, device="cpu")
    assert sorted(os.listdir(root)) == FILES
    assert _keys(root) == _keys(ref_store[0])
    with open(root / "robust_state.json") as f:
        assert json.load(f) == {"budget_used": 0}


def test_resume_skips_every_stage_and_gives_the_same_result(
        case, tmp_path, monkeypatch):
    data, labels = case
    _, cfg = _configs(tmp_path / "store")
    first = port.refine(data, labels, cfg, device="cpu")
    _poison(monkeypatch, pipeline,
            ("pairwise_de", "de_gene_union", "pca_scores", "ward_linkage",
             "cutree_hybrid"))
    again = port.refine(data, labels, cfg, device="cpu")
    _same_result(again, first)
    np.testing.assert_array_equal(again.embedding, first.embedding)
    # the DE save is timed as its own stage, and a resume runs neither
    assert "de_store" in first.metrics["stage_walls_s"]
    assert "de" not in again.metrics["stage_walls_s"]
    assert "de_store" not in again.metrics["stage_walls_s"]
    np.testing.assert_array_equal(again.de.de_mask.numpy(),
                                  first.de.de_mask.numpy())


def test_a_changed_config_or_input_is_refused(case, tmp_path):
    data, labels = case
    _, cfg = _configs(tmp_path / "store")
    port.refine(data, labels, cfg, device="cpu")
    _, other = _configs(tmp_path / "store", q_val_thrs=0.05)
    with pytest.raises(ValueError, match="different config"):
        port.refine(data, labels, other, device="cpu")
    changed = data.copy()
    changed[:, 0] += 1.0
    with pytest.raises(ValueError, match="different input data"):
        port.refine(changed, labels, cfg, device="cpu")


@pytest.mark.parametrize("damage", ["flip", "truncate"])
@pytest.mark.parametrize("stage", ["de", "tree"])
def test_a_corrupt_artifact_is_quarantined_and_recomputed(
        case, tmp_path, stage, damage):
    data, labels = case
    root = tmp_path / "store"
    _, cfg = _configs(root)
    first = port.refine(data, labels, cfg, device="cpu")
    path = root / f"{stage}.npz"
    raw = bytearray(path.read_bytes())
    if damage == "flip":
        raw[len(raw) // 2] ^= 0xFF
    else:
        raw = raw[:len(raw) // 3]
    path.write_bytes(bytes(raw))
    again = port.refine(data, labels, cfg, device="cpu")
    _same_result(again, first)
    names = os.listdir(root)
    assert f"{stage}.npz.quarantined-0" in names
    assert f"{stage}.json.quarantined-0" in names
    assert f"{stage}.npz" in names       # recomputed and stored again
    assert (stage == "de") == ("de" in again.metrics["stage_walls_s"])


def test_de_result_round_trips_through_the_store(case):
    data, labels = case
    res = port.refine(data, labels, port.ReclusterConfig(method="roc"),
                      device="cpu").de
    arrays, meta = res.to_store()
    assert {"aux_auc", "aux_power", "aux_funnel_gate_full"} <= set(arrays)
    back = PairwiseDEResult.from_store(arrays, meta, device="cpu")
    for f in PairwiseDEResult._ARRAY_FIELDS + ("pct1", "pct2"):
        a, b = getattr(back, f), getattr(res, f)
        np.testing.assert_array_equal(
            a.numpy() if isinstance(a, torch.Tensor) else a,
            b.numpy() if isinstance(b, torch.Tensor) else b)
    assert sorted(back.aux) == sorted(res.aux)
    with pytest.raises(ValueError, match="incomplete"):
        PairwiseDEResult.from_store(arrays, {})


def test_a_reference_store_resumes_in_the_port(case, ref_store,
                                               monkeypatch):
    data, labels = case
    root, ref = ref_store
    # the same config JSON (artifact_dir included) and the same input
    # fingerprint: the port accepts the reference's pin
    _, cfg = _configs(root)
    _poison(monkeypatch, pipeline,
            ("pairwise_de", "pca_scores", "ward_linkage", "cutree_hybrid"))
    got = port.refine(data, labels, cfg, device="cpu")
    np.testing.assert_array_equal(got.de_gene_union_idx,
                                  ref.de_gene_union_idx)
    for key in ref.dynamic_labels:
        np.testing.assert_array_equal(got.dynamic_labels[key],
                                      ref.dynamic_labels[key])
    np.testing.assert_array_equal(got.embedding, ref.embedding)
    np.testing.assert_array_equal(got.de.de_mask.numpy(),
                                  np.asarray(ref.de.de_mask))


def test_a_port_store_resumes_in_the_reference(case, tmp_path, monkeypatch):
    data, labels = case
    root = tmp_path / "store"
    rc, cfg = _configs(root)
    got = port.refine(data, labels, cfg, device="cpu")
    _poison(monkeypatch, ref_pl,
            ("pairwise_de", "ward_linkage", "cutree_hybrid"))
    ref = ref_pl.refine(data, labels, rc, mesh=None)
    np.testing.assert_array_equal(ref.de_gene_union_idx,
                                  got.de_gene_union_idx)
    for key in got.dynamic_labels:
        np.testing.assert_array_equal(ref.dynamic_labels[key],
                                      got.dynamic_labels[key])
    np.testing.assert_array_equal(ref.embedding, got.embedding)


@pytest.mark.parametrize("branch", ["pool", "landmark"])
def test_an_approximate_tree_resumes_with_its_branch(case, tmp_path, branch,
                                                     monkeypatch):
    data, labels = case
    kw = dict(approx_threshold=100, n_pool_centroids=64)
    if branch == "landmark":
        kw.update(landmark_threshold=100, landmark_k=64)
    _, cfg = _configs(tmp_path / "store", **kw)
    first = port.refine(data, labels, cfg, device="cpu")
    with np.load(tmp_path / "store" / "tree.npz") as z:
        keys = set(z.files)
    assert {"pool_assign", "pool_centroids"} <= keys
    assert ("landmark_k" in keys) == (branch == "landmark")
    _poison(monkeypatch, pipeline,
            ("pairwise_de", "pooled_ward_linkage", "landmark_ward_linkage",
             "cutree_hybrid"))
    again = port.refine(data, labels, cfg, device="cpu")
    _same_result(again, first)
    assert again.metrics["tree"] == first.metrics["tree"]
    assert again.metrics["landmark"] == first.metrics["landmark"]
    assert again.metrics["silhouette"] == first.metrics["silhouette"]
