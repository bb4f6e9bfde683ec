"""The port's input contract against the JAX package's, on the CPU: each
reject check raises ``InputContractError`` with the reference's check name
on numpy, tensor and CSR input, the repair records are the reference's,
and ``refine`` raises before its ``de`` stage runs."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from scconsensus_tpu.config import ReclusterConfig as RefConfig
from scconsensus_tpu.robust import contract as ref_contract
from scconsensus_tpu.utils.synthetic import synthetic_scrna
import scconsensus_tpu_torch as port
from scconsensus_tpu_torch.carry import config_from_reference
from scconsensus_tpu_torch.io.sparsemat import DeviceCSR
from scconsensus_tpu_torch.models import pipeline
from scconsensus_tpu_torch.robust import contract
from scconsensus_tpu_torch.robust.contract import InputContractError

CPU = torch.device("cpu")


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
    """200 genes × 400 cells × 4 clusters (the measurement behind C7)."""
    data, truth, _ = synthetic_scrna(n_genes=200, n_cells=400, n_clusters=4,
                                     seed=7)
    return data, np.array([f"c{v}" for v in truth])


def _as(kind, data):
    if kind == "tensor":
        return torch.from_numpy(data)
    if kind == "csr":
        return sp.csr_matrix(data)
    if kind == "device_csr":
        return DeviceCSR.from_scipy(sp.csr_matrix(data), CPU)
    return data


def _bad(check, data, labels):
    """Inputs that break one reject check."""
    data = data.copy()
    labels = labels.copy()
    if check == "shape":
        labels = labels[:-1]
    elif check == "nan_labels":
        labels = np.arange(labels.size, dtype=np.float64) % 4
        labels[::8] = np.nan                           # 50 of 400
    elif check == "nonfinite_nan":
        data[3, 5] = np.nan
    elif check == "nonfinite_inf":
        data[7, 11] = -np.inf
    elif check == "degenerate_clusters":
        labels = np.where(labels == "c0", "c0", "grey")
    return data, labels


KINDS = ["numpy", "tensor", "csr", "device_csr"]
CHECKS = ["shape", "nan_labels", "nonfinite_nan", "nonfinite_inf",
          "degenerate_clusters"]


def _ref_check(data, labels):
    with pytest.raises(ref_contract.InputContractError) as ei:
        ref_contract.preflight(data, labels, RefConfig())
    return ei.value.check


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("check", CHECKS)
def test_reject_checks_raise_the_reference_check_name(case, check, kind):
    data, labels = _bad(check, *case)
    # the reference reads numpy and scipy; a tensor or DeviceCSR of the
    # same values must raise the same check
    want = _ref_check(sp.csr_matrix(data) if "csr" in kind else data,
                      labels)
    with pytest.raises(InputContractError) as ei:
        contract.preflight(_as(kind, data), labels, port.ReclusterConfig())
    assert ei.value.check == want
    assert str(ei.value).startswith(f"input contract [{want}]")
    assert isinstance(ei.value, ValueError)


def test_checks_registry_equals_the_reference():
    assert contract.CHECKS == ref_contract.CHECKS


@pytest.mark.parametrize("kind", KINDS)
def test_repair_records_equal_the_reference(case, kind):
    data, _ = case
    # integer ids with a gap, and one cluster at the size floor
    labels = np.repeat(np.array([0, 1, 2, 5, 9]), [100, 100, 100, 90, 10])
    want = ref_contract.preflight(data, labels, RefConfig())
    got = contract.preflight(_as(kind, data), labels,
                             port.ReclusterConfig())
    assert [r["check"] for r in got] == ["noncontiguous_ids",
                                         "small_clusters"]
    assert got == want


@pytest.mark.parametrize("kind", KINDS)
def test_a_huge_finite_matrix_is_accepted(case, kind):
    data, labels = case
    data = data.copy()
    data[0, :] = 3e38       # a float32 sum would overflow to inf here
    assert contract.preflight(_as(kind, data), labels,
                              port.ReclusterConfig()) == \
        ref_contract.preflight(data, labels, RefConfig())


@pytest.mark.parametrize("kind", ["numpy", "csr"])
@pytest.mark.parametrize("check", ["nonfinite_nan", "nan_labels"])
def test_refine_raises_before_the_de_stage(case, check, kind, monkeypatch):
    # C7: one NaN in the matrix, and 50 of 400 labels NaN
    data, labels = _bad(check, *case)
    data = _as(kind, data)

    def no_de(*a, **kw):
        raise AssertionError("the de stage ran")

    monkeypatch.setattr(pipeline, "pairwise_de", no_de)
    want = "nonfinite_matrix" if check == "nonfinite_nan" else "nan_labels"
    with pytest.raises(InputContractError) as ei:
        port.refine(data, labels, port.ReclusterConfig(), device="cpu")
    assert ei.value.check == want
    # the reference refuses the same call with the same check
    from scconsensus_tpu.models.pipeline import refine as ref_refine

    with pytest.raises(ref_contract.InputContractError) as ri:
        ref_refine(data, labels, RefConfig(), mesh=None)
    assert ri.value.check == want


def test_refine_labels_length_is_the_shape_check(case):
    data, labels = case
    cfg = config_from_reference(RefConfig().to_json())
    with pytest.raises(InputContractError) as ei:
        port.refine(data, labels[:-3], cfg, device="cpu")
    assert ei.value.check == "shape"
