"""The port's sparse input against the JAX package's, on the CPU: the CSR
helpers of ``io/sparsemat.py`` (host copies and the device forms on the
``DeviceCSR`` triplet), the loaders, ``ranksum_body`` on pre-compacted
windows, the CSR branches of the DE engine and edgeR, and the 1M runner's
sparse generator.

Inputs come from numpy seeds at small sizes. The host copies are the
reference's code, so they are held equal bit for bit; where a device form
sums float32 in another order than scipy, the test says so and states its
tolerance."""

import importlib.util
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from scconsensus_tpu.config import CompatFlags as RefCompat
from scconsensus_tpu.config import ReclusterConfig as RefConfig
from scconsensus_tpu.de import engine as ref_engine
from scconsensus_tpu.io import loaders as ref_loaders
from scconsensus_tpu.io import sparsemat as ref_sparse
from scconsensus_tpu.ops import ranksum_allpairs as ref_rs
from scconsensus_tpu.utils.synthetic import noisy_labeling, synthetic_scrna
from scconsensus_tpu_torch.carry import config_from_reference
from scconsensus_tpu_torch.de import engine
from scconsensus_tpu_torch.io import loaders, sparsemat
from scconsensus_tpu_torch.io.sparsemat import DeviceCSR
from scconsensus_tpu_torch.ops import ranksum_allpairs
from scconsensus_tpu_torch.utils import synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs six workers on the machine's cores; two torch threads
    # a worker keep these small tensors from crowding out the other files
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
# log p: both sides evaluate the same float32 formula from the same exact
# U and tie sums (tests/test_torch_de.py)
LOGP_RTOL, LOGP_ATOL = 1e-5, 1e-4


def _csr_case(seed=5, n_genes=40, n_cells=120, negative=False):
    """A CSR with explicit zeros among its stored entries (and, with
    ``negative``, one negative stored value), its dense form and a
    per-cell cluster id with excluded cells (−1)."""
    rng = np.random.default_rng(seed)
    x = (rng.gamma(1.5, 1.0, (n_genes, n_cells))
         * (rng.random((n_genes, n_cells)) < 0.3)).astype(np.float32)
    x[3] = 0.0                                  # a gene with no entries
    m = sp.csr_matrix(x)
    # explicit zeros: stored slots whose value is 0
    m.data[rng.random(m.nnz) < 0.1] = 0.0
    if negative:
        m.data[7] = -0.5
    cid = rng.integers(-1, 4, n_cells).astype(np.int32)
    return m, m.toarray(), cid


# --- io/sparsemat: host copies and device forms ---------------------------

@pytest.mark.parametrize("pad_rows", [0, 16])
def test_csr_window_rows_equal_the_reference(pad_rows):
    m, _, cid = _csr_case()
    stored = np.diff(m.indptr)
    ids = np.argsort(stored, kind="stable")[::3]
    w = int(stored.max())
    want = ref_sparse.csr_window_rows(m, ids, w, cid, pad_rows=pad_rows)
    got = sparsemat.csr_window_rows(m, ids, w, cid, pad_rows=pad_rows)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    # explicit zeros took a slot with their cell's cluster id
    assert (want[0][want[1] >= 0] == 0).any()
    # the device form on the triplet: the same B rows, bit for bit
    vals, wcid = DeviceCSR.from_scipy(m, CPU).window_rows(
        ids, w, torch.from_numpy(cid))
    np.testing.assert_array_equal(vals.numpy(), want[0][:ids.size])
    np.testing.assert_array_equal(wcid.numpy(), want[1][:ids.size])


def test_csr_window_rows_refuse_a_gene_wider_than_the_window():
    m, _, cid = _csr_case()
    g = int(np.argmax(np.diff(m.indptr)))
    w = int(np.diff(m.indptr)[g]) - 1
    for fn in (ref_sparse.csr_window_rows, sparsemat.csr_window_rows):
        with pytest.raises(ValueError, match="stored entries > window"):
            fn(m, np.array([g]), w, cid)
    with pytest.raises(ValueError, match="stored entries > window"):
        DeviceCSR.from_scipy(m, CPU).window_rows(
            np.array([g]), w, torch.from_numpy(cid))


@pytest.mark.parametrize("form", ["segment", "matmul"])
def test_aggregates_from_sparse_match_the_reference(form):
    m, dense, cid = _csr_case(negative=True)
    K = 4
    onehot = np.zeros((m.shape[1], K), np.float32)
    onehot[np.nonzero(cid >= 0)[0], cid[cid >= 0]] = 1.0
    want = ref_sparse.aggregates_from_sparse(m, onehot)
    for g, r in zip(sparsemat.aggregates_from_sparse(m, onehot), want):
        np.testing.assert_array_equal(g, r)
    for g, r in zip(sparsemat.aggregates_from_sparse(dense, onehot),
                    ref_sparse.aggregates_from_sparse(dense, onehot)):
        np.testing.assert_array_equal(g, r)
    # the device form: gene chunks through compute_aggregates_cid with the
    # sparse detection rule (a negative stored value counts, an explicit
    # zero does not). Counts exact; sums of ≤ 120 float32 terms in another
    # order than scipy's, and torch's expm1 against numpy's: 1e-5 relative
    agg = sparsemat.csr_aggregates(DeviceCSR.from_scipy(m, CPU),
                                   torch.from_numpy(cid), K, form=form)
    np.testing.assert_array_equal(agg.nnz.numpy(), want[3])
    np.testing.assert_array_equal(agg.counts.numpy(), want[4])
    for g, r in zip((agg.sum_log, agg.sum_expm1, agg.sum_sq), want[:3]):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-6)


def test_means_and_nodg_match_the_reference():
    m, dense, _ = _csr_case(negative=True)
    dev = DeviceCSR.from_scipy(m, CPU)
    assert sparsemat.mean_expm1(m) == ref_sparse.mean_expm1(m)
    assert sparsemat.mean_value(m) == ref_sparse.mean_value(m)
    # the device form sums in float64, scipy in float32 (pairwise)
    assert sparsemat.mean_expm1(dev) == pytest.approx(
        ref_sparse.mean_expm1(m), rel=1e-6)
    assert sparsemat.mean_value(dev) == pytest.approx(
        ref_sparse.mean_value(m), rel=1e-6)
    # the CSR rule counts the negative stored value, the dense rule x > 0
    want = ref_sparse.nodg(m)
    np.testing.assert_array_equal(sparsemat.nodg(m), want)
    np.testing.assert_array_equal(sparsemat.nodg(dev), want)
    np.testing.assert_array_equal(sparsemat.nodg(torch.from_numpy(dense)),
                                  ref_sparse.nodg(dense))
    assert not np.array_equal(want, ref_sparse.nodg(dense))
    ex = sparsemat.expm1_sparse(dev)
    np.testing.assert_allclose(ex.values.numpy(),
                               ref_sparse.expm1_sparse(m).data, rtol=1e-6)
    assert ex.indices is dev.indices


def test_rows_and_chunks_equal_the_reference():
    m, dense, _ = _csr_case()
    dev = DeviceCSR.from_scipy(m, CPU)
    idx = np.array([5, 0, 39, 3, 17])
    want = ref_sparse.rows_dense(m, idx)
    np.testing.assert_array_equal(sparsemat.rows_dense(m, idx), want)
    np.testing.assert_array_equal(sparsemat.rows_dense(dev, idx).numpy(),
                                  want)
    for g0, width in ((0, 16), (32, 16)):       # the second one pads
        want = ref_sparse.padded_row_chunk(m, g0, width)
        np.testing.assert_array_equal(
            sparsemat.padded_row_chunk(m, g0, width), want)
        np.testing.assert_array_equal(
            sparsemat.padded_row_chunk(dev, g0, width).numpy(), want)
    np.testing.assert_array_equal(
        sparsemat.row_chunk_dense(dev, 8, 20).numpy(),
        ref_sparse.row_chunk_dense(m, 8, 20))
    chunks = list(sparsemat.row_chunks(dev, 7))
    assert [(g0, g1) for g0, g1, _ in chunks][-1] == (35, 40)
    np.testing.assert_array_equal(
        torch.cat([c for _, _, c in chunks]).numpy(), dense)
    cols = torch.tensor([3, 0, 119, 50])
    np.testing.assert_array_equal(
        sparsemat.columns_dense(dev, cols).numpy(), dense[:, cols.numpy()])
    # per-cell sums of ≤ 40 float32 terms, in chunk order against numpy's
    np.testing.assert_allclose(sparsemat.column_sums(dev).numpy(),
                               dense.sum(axis=0), rtol=1e-6, atol=1e-6)


def test_as_csr_sums_duplicates_and_csr_to_device():
    rng = np.random.default_rng(9)
    rows = rng.integers(0, 20, 300)
    cols = rng.integers(0, 30, 300)
    vals = rng.random(300).astype(np.float32)
    coo = sp.coo_matrix((vals, (rows, cols)), shape=(20, 30))
    assert coo.nnz > len(set(zip(rows.tolist(), cols.tolist())))
    got, want = sparsemat.as_csr(coo), ref_sparse.as_csr(coo)
    assert sp.isspmatrix_csr(got)
    np.testing.assert_array_equal(got.toarray(), want.toarray())
    dense = np.asarray(ref_sparse.csr_to_device(coo))
    np.testing.assert_array_equal(
        sparsemat.csr_to_device(coo, device="cpu").numpy(), dense)
    # a CSR with unsorted, duplicated entries is canonicalized on upload
    raw = sp.csr_matrix((vals[:4], np.array([2, 2, 0, 5]),
                         np.array([0, 3, 4])), shape=(2, 6))
    assert not raw.has_canonical_format
    dev = DeviceCSR.from_scipy(raw, CPU)
    np.testing.assert_array_equal(dev.to_dense().numpy(), raw.toarray())
    assert dev.host_indptr[-1] == 3 and not raw.has_canonical_format
    for fmt in (sp.csc_matrix, sp.coo_matrix):
        np.testing.assert_array_equal(
            DeviceCSR.from_scipy(fmt(dense), CPU).to_dense().numpy(), dense)


# --- io/loaders ------------------------------------------------------------

def _counts(seed=2):
    rng = np.random.default_rng(seed)
    x = rng.poisson(0.4, (25, 60)).astype(np.float32)
    return sp.csr_matrix(x)


def _same_data(got, want):
    assert sp.isspmatrix_csr(got.matrix) and got.matrix.dtype == np.float32
    assert got.matrix.shape == want.matrix.shape
    np.testing.assert_array_equal(got.matrix.toarray(),
                                  want.matrix.toarray())
    for g, w in ((got.gene_names, want.gene_names),
                 (got.cell_names, want.cell_names)):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("genes_as_rows", [True, False])
def test_load_mtx_round_trip(tmp_path, genes_as_rows):
    import scipy.io as sio

    m = _counts()
    sio.mmwrite(str(tmp_path / "m.mtx"), m if genes_as_rows else m.T)
    (tmp_path / "genes.tsv").write_text(
        "".join(f"g{i}\tG{i}\n" for i in range(25)))
    (tmp_path / "barcodes.tsv").write_text(
        "".join(f"c{i}\n" for i in range(60)))
    args = (str(tmp_path / "m.mtx"), str(tmp_path / "genes.tsv"),
            str(tmp_path / "barcodes.tsv"))
    got = loaders.load_mtx(*args, genes_as_rows=genes_as_rows)
    _same_data(got, ref_loaders.load_mtx(*args, genes_as_rows=genes_as_rows))
    np.testing.assert_array_equal(got.matrix.toarray(), m.toarray())
    assert got.gene_names[0] == "g0"


def test_load_npz_round_trip(tmp_path):
    m = _counts()
    sp.save_npz(str(tmp_path / "m.npz"), sp.csc_matrix(m.astype(np.float64)))
    got = loaders.load_npz(str(tmp_path / "m.npz"))
    _same_data(got, ref_loaders.load_npz(str(tmp_path / "m.npz")))
    np.testing.assert_array_equal(got.matrix.toarray(), m.toarray())


@pytest.mark.parametrize("layout", ["csr", "csc", "inferred", "dense"])
def test_load_h5ad_round_trip(tmp_path, layout):
    h5py = pytest.importorskip("h5py")
    m = _counts()                       # genes × cells; AnnData stores X.T
    cells_by_genes = m.T
    path = str(tmp_path / "x.h5ad")
    with h5py.File(path, "w") as f:
        if layout == "dense":
            f.create_dataset("X", data=cells_by_genes.toarray())
        else:
            x = (cells_by_genes.tocsc() if layout == "csc"
                 else cells_by_genes.tocsr())
            g = f.create_group("X")
            g.create_dataset("data", data=x.data)
            g.create_dataset("indices", data=x.indices)
            g.create_dataset("indptr", data=x.indptr)
            g.attrs["shape"] = np.array(x.shape)
            if layout != "inferred":
                g.attrs["encoding-type"] = f"{layout}_matrix"
        for name, n, prefix in (("obs", 60, "cell"), ("var", 25, "gene")):
            grp = f.create_group(name)
            grp.attrs["_index"] = "_index"
            grp.create_dataset("_index", data=np.array(
                [f"{prefix}{i}".encode() for i in range(n)]))
    got = loaders.load_h5ad(path)
    _same_data(got, ref_loaders.load_h5ad(path))
    np.testing.assert_array_equal(got.matrix.toarray(), m.toarray())
    assert got.cell_names[1] == "cell1" and got.gene_names[2] == "gene2"


@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_log_normalize_matches_the_reference(kind):
    m = _counts(3)
    x = m if kind == "sparse" else m.toarray()
    got, want = loaders.log_normalize(x), ref_loaders.log_normalize(x)
    if kind == "sparse":
        assert sp.isspmatrix_csr(got)
        got, want = got.toarray(), want.toarray()
    np.testing.assert_array_equal(got, want)


# --- ops/ranksum_allpairs on compacted windows -----------------------------

def _compacted_case(width):
    """CSR rows with ≤ 128 stored entries over 240 cells (explicit zeros
    among them) compacted into (G, width) windows."""
    m, dense, cid = _csr_case(seed=13, n_genes=12, n_cells=240)
    assert np.diff(m.indptr).max() <= 128
    n_of = np.bincount(cid[cid >= 0], minlength=4).astype(np.int32)
    pi, pj = (a.astype(np.int32) for a in np.triu_indices(4, 1))
    ids = np.arange(m.shape[0])
    vals, wcid = ref_sparse.csr_window_rows(m, ids, width, cid)
    return dense, cid, vals, wcid, n_of, pi, pj


@pytest.mark.parametrize("width", [128, 256], ids=["fits", "wider_than_N"])
@pytest.mark.parametrize("ref_cpu_forms", [True, False])
@pytest.mark.parametrize("port_cpu_forms", [True, False])
def test_ranksum_body_on_compacted_windows(width, ref_cpu_forms,
                                           port_cpu_forms):
    dense, cid, vals, wcid, n_of, pi, pj = _compacted_case(width)
    ref = ref_rs.ranksum_body(
        jnp.asarray(vals), jnp.asarray(wcid), jnp.asarray(n_of),
        jnp.asarray(pi), jnp.asarray(pj), 4, window=width,
        cpu_forms=ref_cpu_forms)
    got = ranksum_allpairs.ranksum_body(
        torch.from_numpy(vals), torch.from_numpy(wcid),
        torch.from_numpy(n_of), torch.from_numpy(pi), torch.from_numpy(pj),
        4, window=width, cpu_forms=port_cpu_forms)
    lp_r, u_r, ts_r = (np.asarray(a) for a in ref)
    lp, u, ts = (a.numpy() for a in got)
    # U and the tie sums are integers or halves below 2**24: exact
    np.testing.assert_array_equal(u, u_r)
    np.testing.assert_array_equal(ts, ts_r)
    np.testing.assert_allclose(lp, lp_r, rtol=LOGP_RTOL, atol=LOGP_ATOL)
    # and the port's full-width rows over all 240 cells give the same
    full = ranksum_allpairs.ranksum_body(
        torch.from_numpy(dense), torch.from_numpy(cid),
        torch.from_numpy(n_of), torch.from_numpy(pi), torch.from_numpy(pj),
        4, cpu_forms=port_cpu_forms)
    np.testing.assert_array_equal(full[1].numpy(), u)
    np.testing.assert_array_equal(full[2].numpy(), ts)


# --- de/engine and de/edger on CSR -----------------------------------------

def _groups(labels, min_size=10):
    names, cell_idx = engine.filter_clusters(labels, min_size)
    return names, [np.nonzero(cell_idx == k)[0].astype(np.int32)
                   for k in range(len(names))]


def _de_csr(negative=False):
    """The DE test data of tests/test_torch_de.py (two clusters cut below
    50 cells, so their pair takes R's exact branch) as CSR, with explicit
    zeros among the stored entries and, with ``negative``, one negative
    value (which sends every gene to full-width chunks)."""
    data, truth, _ = synthetic_scrna(n_genes=300, n_cells=800, n_clusters=5,
                                     seed=7)
    labels = np.array([f"c{t}" for t in truth])
    labels[np.nonzero(truth == 0)[0][:30]] = "s0"
    labels[np.nonzero(truth == 1)[0][:40]] = "s1"
    m = sp.csr_matrix(data)
    # 200 stored entries set to an explicit 0
    m.data[np.random.default_rng(1).choice(m.nnz, 200, replace=False)] = 0.0
    if negative:
        m.data[11] = -0.25
    assert (m.data == 0).sum() >= 199
    return m, labels


@pytest.mark.parametrize("case", ["explicit_zeros", "negative"])
def test_run_wilcox_on_csr_matches_the_reference(case):
    m, labels = _de_csr(negative=case == "negative")
    names, idx_of = _groups(labels)
    pi, pj = engine._all_pairs(len(names))
    lp_r, u_r = ref_engine._run_wilcox(m, idx_of, pi, pj)
    ladder = {}
    lp, u = engine._run_wilcox(DeviceCSR.from_scipy(m, CPU), idx_of, pi, pj,
                               ladder=ladder)
    assert ladder["route"] == ("csr-chunked" if case == "negative"
                               else "csr-compacted")
    np.testing.assert_array_equal(u.numpy(), u_r)
    np.testing.assert_array_equal(np.isnan(lp.numpy()), np.isnan(lp_r))
    np.testing.assert_allclose(lp.numpy(), lp_r, rtol=LOGP_RTOL,
                               atol=LOGP_ATOL)
    # the port's dense route on the same values gives the same statistics
    lp_d, u_d = engine._run_wilcox(torch.from_numpy(m.toarray()), idx_of,
                                   pi, pj)
    np.testing.assert_array_equal(u_d.numpy(), u.numpy())
    np.testing.assert_array_equal(lp_d.numpy(), lp.numpy())


def _ref_config(method, log_counts=True):
    if method == "edger":
        return RefConfig(method="edger", q_val_thrs=0.01,
                         log_fc_thrs=math.log(2.0), mean_scaling_factor=2.0,
                         compat=RefCompat(edger_log_counts=log_counts))
    if method == "wilcoxon":
        return RefConfig(method="wilcoxon", q_val_thrs=0.01,
                         log_fc_thrs=math.log(2.0))
    return RefConfig(q_val_thrs=0.1)


def _verify_csr():
    """The verify recipe (synthetic_scrna(300, 800, 5, seed 7), its
    consensus of a supervised and an unsupervised noisy labeling) as
    COO, so the entry point canonicalizes it."""
    import scconsensus_tpu as ref_pkg

    data, truth, _ = synthetic_scrna(n_genes=300, n_cells=800, n_clusters=5,
                                     seed=7)
    sup = noisy_labeling(truth, 0.05, n_out_clusters=3, seed=1, prefix="T")
    uns = noisy_labeling(truth, 0.10, seed=2, prefix="L")
    return sp.coo_matrix(data), np.asarray(
        ref_pkg.plot_contingency_table(sup, uns))


@pytest.fixture(scope="module")
def de_runs():
    """Per case: the reference and the port on the same COO input, and
    the port on the dense matrix."""
    m, labels = _verify_csr()
    out = {}
    for case, (method, log_counts) in {
            "wilcox": ("wilcox", True), "wilcoxon": ("wilcoxon", True),
            "edger-compat": ("edger", True),
            "edger-countscale": ("edger", False)}.items():
        ref_cfg = _ref_config(method, log_counts)
        cfg = config_from_reference(ref_cfg.to_json())
        out[case] = (
            ref_engine.pairwise_de(m, labels, ref_cfg, mesh=None),
            engine.pairwise_de(m, labels, cfg, device="cpu"),
            engine.pairwise_de(m.toarray(), labels, cfg, device="cpu"),
        )
    return out


CASES = ["wilcox", "wilcoxon", "edger-compat", "edger-countscale"]


@pytest.mark.parametrize("case", CASES)
def test_pairwise_de_on_csr_matches_the_reference(de_runs, case):
    ref, got, _ = de_runs[case]
    assert got.cluster_names == list(ref.cluster_names)
    np.testing.assert_array_equal(got.de_mask.numpy(),
                                  np.asarray(ref.de_mask))
    np.testing.assert_array_equal(got.tested.numpy(), np.asarray(ref.tested))
    np.testing.assert_array_equal(engine.de_gene_union(got, 30),
                                  ref_engine.de_gene_union(ref, 30))
    want, have = np.asarray(ref.log_p), got.log_p.numpy()
    np.testing.assert_array_equal(np.isnan(have), np.isnan(want))
    fin = np.isfinite(want) & np.isfinite(have)
    err = np.abs(have[fin] - want[fin])
    if case == "edger-compat":
        # tests/test_torch_edger.py's bound (1.1e-3 measured)
        assert err.max() <= 2e-3
    elif case == "edger-countscale":
        # tests/test_torch_edger.py's bounds: 0.1, where the JAX package's
        # own sensitivity to a 1e-6 input change is 0.089, and 0.05 at the
        # 99.9th percentile. A pseudo-count sum at a half-integer rounds to
        # the other count under another float32 summation order (here:
        # torch's thread count) and moves its log p by a count's step, so
        # 1 in 1,000 entries may pass 0.1 (chip_smoke.py's rule; one of
        # 7,904 at 0.121 measured with two torch threads, none with 1, 4
        # or 8)
        assert (err > 0.1).sum() <= max(1, 1e-3 * err.size), err.max()
        assert np.quantile(err, 0.999) <= 0.05
    else:
        np.testing.assert_allclose(have[fin], want[fin], rtol=LOGP_RTOL,
                                   atol=LOGP_ATOL)
    # logFC: the aggregates' float32 sums in another order than scipy's
    # (and, for edgeR, the library sizes'): tests/test_torch_edger.py's
    np.testing.assert_allclose(got.log_fc.numpy(), np.asarray(ref.log_fc),
                               rtol=1e-5, atol=2e-6)
    assert got.de_mask.any()


@pytest.mark.parametrize("case", CASES)
def test_pairwise_de_on_csr_equals_the_dense_input(de_runs, case):
    _, got, dense = de_runs[case]
    np.testing.assert_array_equal(got.de_mask.numpy(),
                                  dense.de_mask.numpy())
    np.testing.assert_array_equal(engine.de_gene_union(got, 30),
                                  engine.de_gene_union(dense, 30))
    if case in ("wilcox", "wilcoxon"):
        # the compacted windows hold the same values: the same U exactly
        np.testing.assert_array_equal(got.u.numpy(), dense.u.numpy())
        assert got.ladder["route"] == "csr-compacted"
        assert dense.ladder["route"] == "dense-device"
        assert [b["window"] for b in got.ladder["buckets"]] == \
            [b["window"] for b in dense.ladder["buckets"]]
    else:
        assert got.ladder is None
    # edgeR's library sizes and pass A sums, the gates' aggregates: float32
    # sums in another order (chunked); log p within the CPU tests' bounds
    a, b = got.log_p.numpy(), dense.log_p.numpy()
    fin = np.isfinite(a) & np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    assert np.abs(a[fin] - b[fin]).max() <= (
        0.1 if case == "edger-countscale" else 2e-3)


# --- the 1M runner's sparse generator --------------------------------------

def _runner():
    spec = importlib.util.spec_from_file_location(
        "run_sparse_1m", os.path.join(REPO, "tools", "run_sparse_1m.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gen_sparse_scrna_equals_the_runner():
    runner = _runner()
    want, cid_w = runner.gen_sparse_scrna(3000, 120, 5, seed=7)
    got, cid = synthetic.gen_sparse_scrna(3000, 120, 5, seed=7)
    np.testing.assert_array_equal(cid, cid_w)
    for f in ("indptr", "indices", "data"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for args in ((0.05, 5, 1, "S"), (0.10, 5, 2, "U")):
        np.testing.assert_array_equal(synthetic.noisy_flip(cid, *args),
                                      runner.noisy(cid, *args))


def test_gen_sparse_scrna_device_draws_the_recipe():
    want, cid_w = synthetic.gen_sparse_scrna(20000, 100, 4, seed=3)
    got, cid = synthetic.gen_sparse_scrna_device(20000, 100, 4, seed=3,
                                                 device="cpu")
    # the same planted clusters; other Bernoulli and Poisson draws
    np.testing.assert_array_equal(cid, cid_w)
    assert sp.isspmatrix_csr(got) and got.has_canonical_format
    assert got.shape == want.shape and got.data.dtype == np.float32
    # per-gene stored counts: binomial around the same rates
    a, b = np.diff(got.indptr), np.diff(want.indptr)
    assert np.abs(a - b).max() <= 6 * np.sqrt(np.maximum(b, 1)).max()
    # values log1p(k + 1) for a Poisson count k
    k = np.expm1(got.data.astype(np.float64)) - 1.0
    np.testing.assert_allclose(k, np.round(k), atol=1e-4)
    assert abs(got.data.mean() - want.data.mean()) < 0.02
