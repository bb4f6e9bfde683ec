"""scconsensus_tpu_torch — the PyTorch / CUDA port of scconsensus_tpu.

Consensus clustering and DE-based refinement for single-cell RNA-seq on an
NVIDIA Hopper card. The JAX package ``scconsensus_tpu`` is the reference;
this package imports nothing of it (nor JAX) and is held against it by the
``tests/test_torch_*.py`` parity tests.

Entry points run on ``cuda`` by default and on the CPU only when called
with ``device="cpu"``; with no card and no CPU request they raise. So far
the port covers ``refine()`` end to end with every DE method of the
reference, at any cell count, on a dense matrix or a ``scipy.sparse``
one (kept sparse on the device; ``load_mtx``, ``load_npz`` and
``load_h5ad`` return CSR): past ``approx_threshold`` through the pooled,
landmark or kNN tree and the pooled silhouette estimator, under the
reference's guard rails (the ``quality`` section, the fault plan and the
typed retry, mid-stage Wilcoxon resume, ``SCC_INTEGRITY``) and with its
heatmaps. The serving path beside it: ``export_consensus_model`` freezes
a finished run, ``load_consensus_model`` loads it with its checksum
verified, and ``ConsensusServer`` serves ``classify(new_cells)`` through
the guarded micro-batching driver. Out of core: ``refine()`` of a
disk-resident ``ChunkedCSRStore`` (or ``streaming_refine`` itself) runs
the whole pipeline chunk at a time under the host-memory budget of a
``HostBudgetAccountant``, resumable and checksummed. Each run's
``result.metrics`` carries the reference's run-record views (stages,
spans, schema), and ``obs.export.build_run_record`` /
``validate_run_record`` build and check the reference's run record;
``SCC_TRACE_DIR`` and ``SCC_OBS_KERNELS`` export it and a
``torch.profiler`` kernel capture.
"""

__version__ = "0.1.0"

from scconsensus_tpu_torch.config import CompatFlags, ReclusterConfig
from scconsensus_tpu_torch.consensus.contingency import (
    contingency_table,
    plot_contingency_table,
)
from scconsensus_tpu_torch.io.loaders import (
    load_h5ad,
    load_mtx,
    load_npz,
    log_normalize,
)
from scconsensus_tpu_torch.models.pipeline import (
    ReclusterResult,
    recluster_de_consensus,
    recluster_de_consensus_fast,
    refine,
)
from scconsensus_tpu_torch.ops.knn_linkage import knn_ward_linkage
from scconsensus_tpu_torch.ops.pooling import (
    landmark_ward_linkage,
    pooled_ward_linkage,
)
from scconsensus_tpu_torch.ops.silhouette import (
    mean_cluster_silhouette,
    pooled_multi_cut_silhouette,
)
from scconsensus_tpu_torch.serve.driver import ConsensusServer
from scconsensus_tpu_torch.serve.model import (
    export_consensus_model,
    load_consensus_model,
)
from scconsensus_tpu_torch.stream.budget import (
    HostBudgetAccountant,
    HostBudgetExceeded,
)
from scconsensus_tpu_torch.stream.runner import streaming_refine
from scconsensus_tpu_torch.stream.store import ChunkedCSRStore

# the reference's public surface (scconsensus_tpu/__init__.py:44-53); the
# port's other entry points above are importable by name too
__all__ = [
    "contingency_table",
    "plot_contingency_table",
    "recluster_de_consensus",
    "recluster_de_consensus_fast",
    "ReclusterConfig",
    "CompatFlags",
    "ReclusterResult",
    "__version__",
]
