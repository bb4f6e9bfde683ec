"""The mesh-against-serial equivalence contract.

A copy of ``scconsensus_tpu/parallel/validate.py``, pinned to it in
``tests/test_torch_parallel.py``: test statistics within float tolerance
(log p within 1e-4, silhouettes within 1e-4), every discrete decision (DE
mask, union, labels) exact. The port's result fields may be tensors.
"""

from __future__ import annotations

import numpy as np

__all__ = ["assert_mesh_equals_serial"]


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def assert_mesh_equals_serial(mesh_res, serial_res) -> None:
    """Assert a mesh ``refine()`` result matches the serial run: test
    statistics to float tolerance, every discrete decision exactly."""
    np.testing.assert_allclose(
        _host(mesh_res.de.log_p), _host(serial_res.de.log_p),
        rtol=1e-4, atol=1e-4
    )
    assert np.array_equal(_host(mesh_res.de.de_mask),
                          _host(serial_res.de.de_mask))
    assert np.array_equal(
        mesh_res.de_gene_union_idx, serial_res.de_gene_union_idx
    )
    for key in mesh_res.dynamic_labels:
        assert np.array_equal(
            mesh_res.dynamic_labels[key], serial_res.dynamic_labels[key]
        )
    # the silhouette rode the ring engine on the mesh run
    for a, b in zip(mesh_res.deep_split_info, serial_res.deep_split_info):
        if "silhouette" in a:
            assert abs(a["silhouette"] - b["silhouette"]) < 1e-4
