"""``refine()`` from sparse input in the port against the JAX package on
the CPU, both handed the same CSR: the exact tree on the verify recipe
(synthetic_scrna(300, 800, 5, seed 7) and its consensus), and the
landmark tree past ``approx_threshold`` on 3,000 cells × 300 genes with
four planted clusters. The reference's config crosses as its JSON string
and its PCA projection as a numpy draw (``carry``); the landmark branch
also runs once with the reference's PCA scores handed to the port, which
holds the tree, cut and silhouette stages on the same points. Last, a
never-densify guard: a CSR whose dense conversions raise goes through
``refine`` with every gene chunk the device path gathers narrower than
the matrix."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import scconsensus_tpu as ref_pkg
import scconsensus_tpu_torch as port
from scconsensus_tpu.config import ReclusterConfig as RefConfig
from scconsensus_tpu.obs.regress import adjusted_rand_index
from scconsensus_tpu.utils.synthetic import noisy_labeling, synthetic_scrna
from scconsensus_tpu_torch.carry import config_from_reference, omega_from_reference
from scconsensus_tpu_torch.de import edger
from scconsensus_tpu_torch.io import sparsemat
from scconsensus_tpu_torch.models import pipeline as port_pipeline

LANDMARK_FLAGS = ("SCC_TREE_LANDMARK_THRESHOLD", "SCC_TREE_LANDMARK_K",
                  "SCC_TREE_LANDMARK_C", "SCC_TREE_EXACT")
LANDMARK = dict(approx_threshold=1000, landmark_threshold=1000)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs six workers on the machine's cores; two torch threads
    # a worker keep these small tensors from crowding out the other files
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _verify():
    data, truth, _ = synthetic_scrna(n_genes=300, n_cells=800, n_clusters=5,
                                     seed=7)
    sup = noisy_labeling(truth, 0.05, n_out_clusters=3, seed=1, prefix="T")
    uns = noisy_labeling(truth, 0.10, seed=2, prefix="L")
    return sp.csr_matrix(data), np.asarray(
        ref_pkg.plot_contingency_table(sup, uns))


def _landmark_data():
    d, truth, _ = synthetic_scrna(n_cells=3000, n_genes=300, n_clusters=4,
                                  n_markers_per_cluster=25, marker_log_fc=3.0,
                                  nb_dispersion=0.2, seed=4)
    return sp.csc_matrix(d), np.array([f"c{v}" for v in truth])


def _omega(ref, cfg, n_cells):
    # the reference's embed draws its projection from PRNGKey(0) at
    # (|union|, min(n_pcs + 10, |union|, N)) (scconsensus_tpu/ops/pca.py)
    f = ref.de_gene_union_idx.size
    return omega_from_reference(np.asarray(jax.random.normal(
        jax.random.PRNGKey(0), (f, min(cfg.n_pcs + 10, f, n_cells)),
        jnp.float32)))


@pytest.fixture(scope="module")
def runs():
    """Per branch: the reference's run from CSR, the port's run from the
    same CSR with the reference's projection, and (landmark) the port's
    run handed the reference's PCA scores."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for flag in LANDMARK_FLAGS:
            mp.delenv(flag, raising=False)
        for name, (x, labels), kw in (("exact", _verify(), {}),
                                      ("landmark", _landmark_data(),
                                       LANDMARK)):
            ref = ref_pkg.recluster_de_consensus_fast(
                x, labels, q_val_thrs=0.1, mesh=None, **kw)
            cfg = config_from_reference(
                RefConfig(method="wilcox", q_val_thrs=0.1, **kw).to_json())
            got = port.refine(x, labels, cfg, device="cpu",
                              omega=_omega(ref, cfg, x.shape[1]))
            same = None
            if name == "landmark":
                with pytest.MonkeyPatch.context() as embed:
                    scores = torch.from_numpy(np.array(ref.embedding))
                    embed.setattr(port_pipeline, "pca_scores",
                                  lambda cells, n_pcs, omega=None: scores)
                    same = port.refine(x, labels, cfg, device="cpu")
            out[name] = (ref, got, same)
    return out


def _cuts_and_silhouettes_match(got, ref, max_deep_split=4):
    assert got.dynamic_labels.keys() == ref.dynamic_labels.keys()
    for g, r in zip(got.deep_split_info, ref.deep_split_info):
        if g["deep_split"] > max_deep_split:
            continue
        key = f"deepsplit: {g['deep_split']}"
        assert adjusted_rand_index(got.dynamic_labels[key],
                                   ref.dynamic_labels[key]) == 1.0, key
        assert g["n_clusters"] == r["n_clusters"]
        assert g.get("silhouette_method") == r.get("silhouette_method")
        # float32 distance sums in another order on each side
        assert abs(g["silhouette"] - r["silhouette"]) <= 1e-4


@pytest.mark.parametrize("branch", ["exact", "landmark"])
def test_union_and_de_mask_from_csr_identical(runs, branch):
    ref, got, _ = runs[branch]
    np.testing.assert_array_equal(got.de_gene_union_idx,
                                  ref.de_gene_union_idx)
    np.testing.assert_array_equal(got.de.de_mask.numpy(),
                                  np.asarray(ref.de.de_mask))
    assert got.metrics["wilcox_ladder"]["route"] == "csr-compacted"
    assert got.metrics["tree"]["landmark"] == (branch == "landmark")


def test_exact_tree_cuts_and_silhouettes_from_csr(runs):
    ref, got, _ = runs["exact"]
    _cuts_and_silhouettes_match(got, ref)
    # the sparse rule (stored nonzeros) on both sides
    np.testing.assert_array_equal(got.nodg, ref.nodg)
    assert got.metrics["silhouette"]["method"] == "exact"


@pytest.mark.parametrize("embedding", ["reference_scores", "own"])
def test_landmark_tree_cuts_and_silhouettes_from_csr(runs, embedding):
    ref, got, same = runs["landmark"]
    if embedding == "reference_scores":
        _cuts_and_silhouettes_match(same, ref)
        tree = next(r for r in ref.metrics["stages"]
                    if r["stage"] == "tree")
        assert same.metrics["tree"]["landmark_k"] == tree["landmark_k"]
    else:
        # the port's own float32 embed: deepSplit 4 partitions the noise
        # inside the four clusters and follows the embedding's rounding
        # (tests/test_torch_scale_pipeline.py), so the cuts that follow
        # the planted clusters are held
        _cuts_and_silhouettes_match(got, ref, max_deep_split=3)
    np.testing.assert_array_equal(got.nodg, ref.nodg)


class _NoDenseCSR(sp.csr_matrix):
    """A CSR whose whole-matrix dense conversions raise."""

    def toarray(self, *a, **k):
        if self.shape == FULL_SHAPE:
            raise AssertionError("the whole matrix was densified")
        return super().toarray(*a, **k)

    def todense(self, *a, **k):
        if self.shape == FULL_SHAPE:
            raise AssertionError("the whole matrix was densified")
        return super().todense(*a, **k)


FULL_SHAPE = (300, 800)


@pytest.mark.parametrize("method", ["wilcox", "edger"])
def test_refine_never_densifies_the_whole_matrix(monkeypatch, method):
    x, labels = _verify()
    guarded = _NoDenseCSR(x)
    assert guarded.shape == FULL_SHAPE
    with pytest.raises(AssertionError, match="densified"):
        guarded.toarray()
    # device gene chunks of at most 64 of the 300 genes (the budgets that
    # size them at scale, cut to this matrix), and no gather of every row
    # at once
    monkeypatch.setattr(sparsemat, "CHUNK_ELEMS", 64 * 800)
    monkeypatch.setattr(edger, "_CHUNK_ELEMS", 64 * 800)
    gather = sparsemat.DeviceCSR.gather_rows
    widest = []

    def narrow_gather(self, gene_ids):
        widest.append(len(gene_ids))
        assert len(gene_ids) < self.shape[0], "every gene gathered at once"
        return gather(self, gene_ids)

    monkeypatch.setattr(sparsemat.DeviceCSR, "gather_rows", narrow_gather)
    cfg = port.ReclusterConfig(method=method, q_val_thrs=0.1)
    got = port.refine(guarded, labels, cfg, device="cpu")
    want = port.refine(x.toarray(), labels, cfg, device="cpu")
    # gene chunks, and the embed's union rows
    assert max(widest) <= max(64, got.de_gene_union_idx.size)
    np.testing.assert_array_equal(got.de_gene_union_idx,
                                  want.de_gene_union_idx)
