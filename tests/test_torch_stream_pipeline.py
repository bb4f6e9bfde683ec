"""``streaming_refine`` in the port against the JAX package's, on the CPU.

Both packages read the same chunk store: 1,200 cells × 96 genes × 3
planted clusters from the reference's generator (seed 5), window 32, the
reference's test shape (``tests/test_stream.py``). The reference's config
crosses as its JSON string and its PCA projection as a numpy draw
(``carry``). Held exactly: the DE union, the DE mask, nodg, the
per-deepSplit partitions (ARI = 1 and, with the same projection, equal
labels), the Gram-regime scores (host numpy on both sides: the same bits)
and the stage dirs, which resume across the packages with every chunk
resumed. Silhouettes within 1e-4. Then the port's recovery ladders on
the port alone: full resume, window halving, the floor breach, a torn
chunk mid-run, SIGKILL mid-ingest in a subprocess, ENOSPC on a
checkpoint write, and the configurations the streaming path refuses."""

import json
import os
import shutil
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import scconsensus_tpu_torch as port
from scconsensus_tpu.config import ReclusterConfig as RefConfig
from scconsensus_tpu.obs.regress import adjusted_rand_index
from scconsensus_tpu.robust import record as ref_record
from scconsensus_tpu.stream.budget import (
    HostBudgetAccountant as RefAccountant,
)
from scconsensus_tpu.stream.budget import (
    HostBudgetExceeded as RefBudgetExceeded,
)
from scconsensus_tpu.stream.runner import streaming_refine as ref_streaming
from scconsensus_tpu.stream.soak import chunk_generator, consensus_input
from scconsensus_tpu.stream.store import ChunkedCSRStore as RefStore
from scconsensus_tpu_torch.carry import (
    config_from_reference,
    omega_from_reference,
)
from scconsensus_tpu_torch.robust import faults
from scconsensus_tpu_torch.stream import (
    ChunkedCSRStore,
    HostBudgetAccountant,
    HostBudgetExceeded,
    streaming_refine,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = dict(n_cells=1200, n_genes=96, n_clusters=3)
SEED = 5
WINDOW = 32
# between the dense embed's reservation (1,200 × |U| × 12 bytes and the
# largest chunk) and every DE charge: the embed takes the Gram regime
GRAM_STAGE_MB = 0.5


@pytest.fixture(autouse=True)
def _roomy_host_budget(monkeypatch):
    # the long-lived test process carries the RSS of earlier tests; the
    # default 4 GB budget would judge that, not the streaming layer (the
    # reference's suite does the same)
    monkeypatch.setenv("SCC_STREAM_HOST_BUDGET_MB", "16384")
    monkeypatch.setenv("SCC_ROBUST_BACKOFF_S", "0.002")
    monkeypatch.delenv("SCC_FAULT_PLAN", raising=False)
    monkeypatch.delenv("SCC_INTEGRITY", raising=False)
    faults.reset()


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ref_config(**over):
    kw = dict(method="wilcox", q_val_thrs=0.1, log_fc_thrs=0.25,
              min_pct=5.0, deep_split_values=(1, 2), min_cluster_size=10,
              n_top_de_genes=20, random_seed=SEED)
    kw.update(over)
    return RefConfig(**kw)


def _config(**over):
    return config_from_reference(_ref_config(**over).to_json())


def _omega(ref, n_cells):
    # the reference's embed draws its projection from PRNGKey(0) at
    # (|union|, min(n_pcs + 10, |union|, N)) (scconsensus_tpu/ops/pca.py)
    f = ref.de_gene_union_idx.size
    return omega_from_reference(np.asarray(jax.random.normal(
        jax.random.PRNGKey(0), (f, min(15 + 10, f, n_cells)),
        jnp.float32)))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """One chunk store written by the reference, its CSR, the labels, the
    generator, the reference's run (dense embed) and its stage dir."""
    root = tmp_path_factory.mktemp("stream-case")
    gen = chunk_generator(SHAPE["n_genes"], SHAPE["n_cells"],
                          SHAPE["n_clusters"], SEED)
    st = RefStore.create(str(root / "chunks"), SHAPE["n_genes"],
                         SHAPE["n_cells"], WINDOW)
    st.ingest(gen)
    full = sp.vstack([st.load_chunk(i) for i in range(st.n_chunks)]).tocsr()
    labels = consensus_input(SHAPE["n_cells"], SHAPE["n_clusters"], SEED)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCC_STREAM_HOST_BUDGET_MB", "16384")
        ref = ref_streaming(RefStore(st.root), labels, _ref_config(),
                            stage_dir=str(root / "ref-stages"), regen=gen)
    return dict(root=st.root, full=full, labels=labels, gen=gen, ref=ref,
                ref_stages=str(root / "ref-stages"),
                omega=_omega(ref, SHAPE["n_cells"]))


def _port_run(case, stage_dir, **kw):
    kw.setdefault("regen", case["gen"])
    return streaming_refine(ChunkedCSRStore(case["root"]), case["labels"],
                            kw.pop("config", _config()),
                            stage_dir=str(stage_dir), device="cpu", **kw)


def _same_partitions(a, b, equal_labels=True):
    for key in a.dynamic_labels:
        x, y = a.dynamic_labels[key], b.dynamic_labels[key]
        m = (x > 0) & (y > 0)
        assert m.sum() > 0, key
        assert adjusted_rand_index(x[m], y[m]) == pytest.approx(1.0), key
        if equal_labels:
            np.testing.assert_array_equal(x, y)


# --------------------------------------------------------------------------
# the port against the reference
# --------------------------------------------------------------------------

def test_streaming_equals_the_reference(case, tmp_path):
    ref = case["ref"]
    got = _port_run(case, tmp_path / "s", omega=case["omega"])
    np.testing.assert_array_equal(got.de_gene_union_idx,
                                  ref.de_gene_union_idx)
    np.testing.assert_array_equal(got.de.de_mask.numpy(),
                                  np.asarray(ref.de.de_mask))
    np.testing.assert_array_equal(got.nodg, ref.nodg)
    _same_partitions(got, ref)
    for a, b in zip(got.deep_split_info, ref.deep_split_info):
        assert a["n_clusters"] == b["n_clusters"]
        assert a["silhouette"] == pytest.approx(b["silhouette"], abs=1e-4)
    sm = got.metrics["streaming"]
    assert sm == {**ref.metrics["streaming"],
                  "budget": sm["budget"]}  # RSS is each process's own
    assert sm["complete"] and sm["budget"]["within_budget"]
    assert got.metrics["stream"]["embed_regime"] == "dense"
    assert got.metrics["stream"]["chunk_loads"]["de"]["loads"] == 3


def test_gram_regime_scores_equal_the_reference(case, tmp_path):
    """The Gram eigenbasis and its scores are host numpy in both
    packages: the same bits, and so the same tree and cuts."""
    gen = case["gen"]
    ref = ref_streaming(
        RefStore(case["root"]), case["labels"], _ref_config(),
        stage_dir=str(tmp_path / "ref"), regen=gen,
        accountant=RefAccountant(stage_budget_mb=GRAM_STAGE_MB))
    got = _port_run(case, tmp_path / "port",
                    accountant=HostBudgetAccountant(
                        stage_budget_mb=GRAM_STAGE_MB))
    assert got.metrics["stream"]["embed_regime"] == "gram"
    assert any(d["action"] == "gram-pca-embed"
               for d in got.metrics["robustness"]["degradations"])
    assert got.metrics["streaming"]["window"]["halvings"] == 0
    np.testing.assert_array_equal(got.embedding, np.asarray(ref.embedding))
    _same_partitions(got, ref)
    # the union rows of each chunk load once per join and once for scores
    assert got.metrics["stream"]["chunk_loads"]["embed"]["loads"] == 3 + 3 + 3


@pytest.mark.parametrize("direction", ["reference-to-port",
                                       "port-to-reference"])
def test_stage_dirs_cross_between_the_packages(case, tmp_path, direction):
    stage_dir = str(tmp_path / "stages")
    if direction == "reference-to-port":
        shutil.copytree(case["ref_stages"], stage_dir)
        got = _port_run(case, stage_dir)
        resumed = got.metrics["stream"]["de_resumed_chunks"]
        first, second = case["ref"], got
    else:
        first = _port_run(case, stage_dir, omega=case["omega"])
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("SCC_STREAM_HOST_BUDGET_MB", "16384")
            ref_record.begin_run()
            second = ref_streaming(RefStore(case["root"]), case["labels"],
                                   _ref_config(), stage_dir=stage_dir,
                                   regen=case["gen"])
        rb = second.metrics.get("robustness") or {}
        resumed = next(p["completed"] for p in rb["resume_points"]
                       if p["stage"] == "stream_de")
    assert resumed == 3
    rb = second.metrics.get("robustness") or {}
    assert any(p["stage"] == "stream_de" for p in rb["resume_points"])
    assert not any(".quarantined-" in n for n in os.listdir(stage_dir))
    _same_partitions(first, second)
    np.testing.assert_array_equal(first.nodg, second.nodg)


def test_streaming_equals_the_ports_in_memory_refine(case, tmp_path):
    mem = port.refine(case["full"], case["labels"], _config(),
                      device="cpu")
    got = _port_run(case, tmp_path / "s")
    np.testing.assert_array_equal(mem.de_gene_union_idx,
                                  got.de_gene_union_idx)
    np.testing.assert_array_equal(mem.de.de_mask.numpy(),
                                  got.de.de_mask.numpy())
    np.testing.assert_array_equal(mem.nodg, got.nodg)
    # the dense twin: the same bytes through the same subspace iteration
    np.testing.assert_array_equal(mem.embedding, got.embedding)
    _same_partitions(mem, got)
    for a, b in zip(mem.deep_split_info, got.deep_split_info):
        assert a["silhouette"] == pytest.approx(b["silhouette"], abs=1e-4)


def test_refine_routes_a_chunk_store(case, tmp_path):
    res = port.refine(ChunkedCSRStore(case["root"]), case["labels"],
                      _config(artifact_dir=str(tmp_path / "stages")),
                      device="cpu")
    assert res.metrics["streaming"]["complete"] is True
    assert os.path.exists(tmp_path / "stages" / "nodg.npz")


def test_default_device_needs_a_card(case, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        streaming_refine(ChunkedCSRStore(case["root"]), case["labels"],
                         _config(), stage_dir=str(tmp_path / "s"))


# --------------------------------------------------------------------------
# recovery
# --------------------------------------------------------------------------

def test_full_resume_is_byte_identical_and_counted(case, tmp_path):
    r1 = _port_run(case, tmp_path / "s")
    r2 = _port_run(case, tmp_path / "s")
    for key in r1.dynamic_labels:
        np.testing.assert_array_equal(r1.dynamic_labels[key],
                                      r2.dynamic_labels[key])
    np.testing.assert_array_equal(r1.embedding, r2.embedding)
    rb = r2.metrics.get("robustness") or {}
    assert any(p["stage"] == "stream_de" for p in rb["resume_points"])
    assert r2.metrics["streaming"]["chunks"]["resumed"] == 3


def test_window_halving_recovers_deterministically(case, tmp_path):
    def tight(tag):
        return _port_run(case, tmp_path / tag,
                         accountant=HostBudgetAccountant(
                             stage_budget_mb=0.25))

    r1, r2 = tight("a"), tight("b")
    sm = r1.metrics["streaming"]
    assert sm["window"]["halvings"] >= 1
    assert sm["window"]["final_rows"] < sm["window"]["initial_rows"]
    assert any(d["action"] == "halve-window"
               for d in r1.metrics["robustness"]["degradations"])
    for key in r1.dynamic_labels:
        np.testing.assert_array_equal(r1.dynamic_labels[key],
                                      r2.dynamic_labels[key])


def test_floor_breach_fails_typed(case, tmp_path):
    with pytest.raises(HostBudgetExceeded):
        _port_run(case, tmp_path / "s",
                  accountant=HostBudgetAccountant(stage_budget_mb=0.001))


def test_chunk_charge_breaks_first_in_both_packages(case, tmp_path):
    """The 10M finding at this scale: a stage budget below one chunk's
    ``chunk_host_bytes`` breaks at the first chunk's charge, outside the
    window ladder, in both packages (at 10M cells one brain10m chunk is
    about 365 MB against the 256 MB default)."""
    st = ChunkedCSRStore(case["root"])
    chunk_mb = max(st.chunk_host_bytes(i) for i in range(st.n_chunks)) / 2**20
    budget = chunk_mb * 0.5
    assert budget * 2**20 > SHAPE["n_cells"] * 4  # the cell groups fit
    with pytest.raises(HostBudgetExceeded) as ours:
        _port_run(case, tmp_path / "p",
                  accountant=HostBudgetAccountant(stage_budget_mb=budget))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCC_STREAM_HOST_BUDGET_MB", "16384")
        with pytest.raises(RefBudgetExceeded) as ref:
            ref_streaming(RefStore(case["root"]), case["labels"],
                          _ref_config(), stage_dir=str(tmp_path / "r"),
                          regen=case["gen"],
                          accountant=RefAccountant(stage_budget_mb=budget))
    for e in (ours.value, ref.value):
        assert (e.kind, e.what) == ("staged", "chunk")
    assert ours.value.need_bytes == ref.value.need_bytes


def test_torn_chunk_mid_run_recovers_identically(case, tmp_path):
    root = str(tmp_path / "chunks")
    shutil.copytree(case["root"], root)
    ref = _port_run(case, tmp_path / "a")
    path = os.path.join(root, "chunk_00002.npz")
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))
    res = streaming_refine(ChunkedCSRStore(root), case["labels"], _config(),
                           stage_dir=str(tmp_path / "b"), regen=case["gen"],
                           device="cpu")
    sm = res.metrics["streaming"]
    assert sm["chunks"]["quarantined"] >= 1
    assert sm["chunks"]["recomputed"] >= 1
    for key in ref.dynamic_labels:
        np.testing.assert_array_equal(ref.dynamic_labels[key],
                                      res.dynamic_labels[key])


def test_enospc_on_a_checkpoint_coarsens_it(case, tmp_path):
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"faults": [
        {"site": "stream_chunk_write", "class": "disk"}]}))
    ref = _port_run(case, tmp_path / "a")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCC_FAULT_PLAN", str(plan))
        faults.reset()
        res = _port_run(case, tmp_path / "b")
    faults.reset()
    assert res.metrics["streaming"]["ckpt"]["final_every"] == 2
    actions = [d["action"] for d in res.metrics["robustness"]["degradations"]]
    assert "shrink-ckpt-granularity" in actions
    # chunk 1 skipped its checkpoint under the coarser granularity
    stages = sorted(n for n in os.listdir(tmp_path / "b")
                    if n.startswith("stream_de_") and n.endswith(".npz"))
    assert len(stages) == 2
    for key in ref.dynamic_labels:
        np.testing.assert_array_equal(ref.dynamic_labels[key],
                                      res.dynamic_labels[key])


def test_stream_block_corruption_recomputes_to_the_same_bits(case, tmp_path):
    ref = _port_run(case, tmp_path / "a")
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"faults": [
        {"site": "stream_block", "class": "corruption",
         "mode": "signflip"}]}))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCC_FAULT_PLAN", str(plan))
        mp.setenv("SCC_INTEGRITY", "enforce")
        faults.reset()
        res = _port_run(case, tmp_path / "b")
    faults.reset()
    ig = res.metrics["integrity"]
    assert ig["violations"] and ig["ghost"]["recomputes"] >= 1
    for key in ref.dynamic_labels:
        np.testing.assert_array_equal(ref.dynamic_labels[key],
                                      res.dynamic_labels[key])


@pytest.mark.parametrize("over,text", [
    (dict(method="edger"), "wilcox"),
    (dict(distance="pearson"), "euclidean"),
])
def test_unsupported_configs_raise(case, tmp_path, over, text):
    with pytest.raises(NotImplementedError, match=text):
        _port_run(case, tmp_path / "s", config=_config(**over))


def test_sigkill_mid_ingest_resumes_identical_sha(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "SCC_FAULT_PLAN"}
    args = ["--cells", "1500", "--genes", "64", "--clusters", "3",
            "--window", "8", "--device", "cpu"]

    def run(workdir, plan=None, fresh=False):
        e = dict(env)
        if plan:
            e["SCC_FAULT_PLAN"] = plan
        cmd = [sys.executable, "-m", "scconsensus_tpu_torch.stream.soak",
               "--dir", workdir,
               "--summary", os.path.join(workdir, "S.json")] + args
        if fresh:
            cmd.append("--fresh")
        p = subprocess.run(cmd, env=e, cwd=REPO, capture_output=True,
                           text=True, timeout=240)
        try:
            with open(os.path.join(workdir, "S.json")) as f:
                return p.returncode, json.load(f)
        except OSError:
            return p.returncode, None

    rc, ref = run(str(tmp_path / "ref"), fresh=True)
    assert rc == 0 and ref and ref["ok"], (ref or {}).get("invalid")
    plan = str(tmp_path / "plan.json")
    with open(plan, "w") as f:
        json.dump({"faults": [{"site": "stream_chunk_write",
                               "class": "kill", "after": 3}]}, f)
    rc_kill, s_kill = run(str(tmp_path / "kill"), plan=plan, fresh=True)
    assert rc_kill == -signal.SIGKILL and s_kill is None
    st = ChunkedCSRStore(str(tmp_path / "kill" / "chunks"))
    done = st.completed_chunks()
    assert 0 < done < st.n_chunks
    rc2, resumed = run(str(tmp_path / "kill"))
    assert rc2 == 0 and resumed and resumed["ok"]
    assert resumed["chunks"]["resumed"] >= done
    assert resumed["labels_sha"] == ref["labels_sha"]
