"""State carried across from the reference package.

The system has no weights. For the two packages to compute the same thing
from the same input, two things must cross, both as plain data (the port
imports nothing of the reference):

  * the configuration, as the string ``ReclusterConfig.to_json()`` returns
    in the reference (``scconsensus_tpu/config.py:664``);
  * the random projection of the PCA embed: the reference draws it from
    ``jax.random.PRNGKey(seed)`` (``scconsensus_tpu/ops/pca.py:36``),
    which torch cannot reproduce, so the caller hands the draw over as a
    numpy array and the port's ``pca_scores(omega=...)`` uses it.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from scconsensus_tpu_torch.config import CompatFlags, ReclusterConfig

__all__ = ["config_from_reference", "omega_from_reference"]


def config_from_reference(cfg_json: str) -> ReclusterConfig:
    """The port's config from the reference's ``to_json()`` string (the
    inverse of ``ReclusterConfig.to_json``)."""
    d = json.loads(cfg_json)
    unknown = sorted(set(d) - {f.name for f in
                               dataclasses.fields(ReclusterConfig)})
    if unknown:
        raise ValueError(f"unknown ReclusterConfig fields: {unknown}")
    d["compat"] = CompatFlags(**d.get("compat", {}))
    if d.get("min_diff_pct") is None:
        d["min_diff_pct"] = -float("inf")
    if "deep_split_values" in d:
        d["deep_split_values"] = tuple(int(v)
                                       for v in d["deep_split_values"])
    return ReclusterConfig(**d)


def omega_from_reference(omega: np.ndarray) -> torch.Tensor:
    """The reference's (F, k) PCA projection draw as a float32 CPU tensor;
    ``pca_scores`` moves it to the device of the data."""
    omega = np.asarray(omega)
    if omega.ndim != 2:
        raise ValueError(f"omega must be (F, k), got shape {omega.shape}")
    return torch.from_numpy(np.array(omega, dtype=np.float32, order="C"))
