"""The port's transfer watch (``obs.device.TransferWatch``, the
reference's ``scconsensus_tpu/obs/device.py:321-411``) over the residency
auditor's crossing hook: bytes by direction, oversized host fetches
flagged with their span, the report's keys, and ``SCC_OBS_TRANSFERS`` on
``refine()``. The CPU stands for the device side, as in
``test_torch_obs_residency.py``."""

import numpy as np
import pytest
import torch

import scconsensus_tpu_torch as port
from scconsensus_tpu.obs.device import TransferWatch as RefWatch
from scconsensus_tpu_torch import ReclusterConfig
from scconsensus_tpu_torch.obs.device import TransferWatch
from scconsensus_tpu_torch.obs.trace import Tracer
from scconsensus_tpu_torch.utils.synthetic import (
    noisy_labeling,
    synthetic_scrna,
)

CPU = ("cpu",)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_counts_explicit_copies_by_direction():
    host = np.ones((64, 4), np.float32)
    with TransferWatch(device_types=CPU) as w:
        t = torch.as_tensor(host)
        t.numpy()
        t.sum().item()
        t[:2].tolist()
    rep = w.report()
    assert (rep["to_device_calls"], rep["to_device_bytes"]) == (1, 1024)
    assert (rep["to_host_calls"], rep["to_host_bytes"]) == (3, 1024 + 4 + 32)
    assert rep["flags"] == []


def test_flags_an_oversized_fetch_with_its_span():
    tr = Tracer(sync="off")
    x = torch.ones(1024)
    with TransferWatch(flag_host_bytes=1000, device_types=CPU) as w:
        with tr.span("embed", kind="stage"):
            x.numpy()
        x[:8].numpy()
    assert w.report()["flags"] == [{"bytes": 4096, "span": "embed"}]


def test_report_keys_are_the_references():
    assert set(TransferWatch().report()) == set(RefWatch().report())


def test_nothing_is_watched_after_exit():
    with TransferWatch(device_types=CPU) as w:
        pass
    torch.ones(4).numpy()
    assert w.to_host_calls == 0


def test_refine_env_flag_reports_clean_transfers(monkeypatch):
    """SCC_OBS_TRANSFERS=1 end-to-end: the report rides the result
    metrics, with no oversized host fetch at this scale."""
    monkeypatch.setenv("SCC_OBS_TRANSFERS", "1")
    data, truth, _ = synthetic_scrna(n_genes=60, n_cells=150, n_clusters=2,
                                     n_markers_per_cluster=6, seed=5)
    res = port.refine(data, noisy_labeling(truth, 0.05, seed=1),
                      ReclusterConfig(), device="cpu")
    rep = res.metrics["transfers"]
    assert rep["flags"] == [] and rep["flag_host_bytes"] > 0
    assert rep["to_host_calls"] > 0 and rep["to_device_calls"] > 0
