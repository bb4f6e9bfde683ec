"""Config helpers, the artifact store, tracing and synthetic data.

The reference's exports (``scconsensus_tpu/utils/__init__.py``), resolved
on first access: most of the port's modules import a submodule of this
package, and an eager import here would pull the artifact store and its
dependencies into each of them.
"""

import importlib

_EXPORTS = {
    "synthetic_scrna": "scconsensus_tpu_torch.utils.synthetic",
    "planted_clusters": "scconsensus_tpu_torch.utils.synthetic",
    "get_logger": "scconsensus_tpu_torch.utils.logging",
    "StageTimer": "scconsensus_tpu_torch.utils.logging",
    "ArtifactStore": "scconsensus_tpu_torch.utils.artifacts",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(name)
