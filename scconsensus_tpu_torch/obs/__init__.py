"""Observability for the port: tracing, the run record and its instruments.

The port's form of ``scconsensus_tpu/obs/__init__.py``, with the
reference's ``__all__``.

  * ``obs.trace`` — the span tracer every stage runs in;
  * ``obs.export`` — the ``scc-run-record`` schema, its validator and the
    Chrome trace export;
  * ``obs.quality`` — the DE funnel, cluster structure and numeric
    sentinels;
  * ``obs.residency`` — the host↔device residency auditor
    (``SCC_OBS_RESIDENCY``) and its declared boundaries;
  * ``obs.device`` — memory gauges and the transfer watch
    (``SCC_OBS_TRANSFERS``);
  * ``obs.cost`` — FLOPs, bytes and transcendentals on spans
    (``SCC_OBS_COST``);
  * ``obs.kernels`` — the ``torch.profiler`` capture joined to spans
    (``SCC_OBS_KERNELS``);
  * ``obs.profile`` — the unified per-stage profile and the residency
    burn-down;
  * ``obs.hostprof`` — the sampling host profiler, GC pauses and the
    memory timeline (``SCC_HOSTPROF``);
  * ``obs.live`` — the flight recorder (``SCC_OBS_HEARTBEAT``,
    ``SCC_OBS_STALL_S``);
  * ``obs.ledger`` — the evidence ledger (``SCC_EVIDENCE_DIR``);
  * ``obs.compilelog`` — the compile log: the native libraries' builds
    and cache hits by stage, the run record's ``compile`` section
    (``SCC_COMPILELOG``);
  * ``obs.graphs`` — graph passports: the aten-operator census of each
    instrumented stage program's first call (transfer ops, host syncs
    with their lines, buffer bytes), keyed by torch's environment
    fingerprint, the run record's ``graphs`` section (``SCC_GRAPHS``);
  * ``obs.regress`` — the perf gate over ledger history (noise-banded
    stage, transfer, serving, streaming, SLO, traffic and ratchet
    verdicts) and the numeric-drift sentinel;
  * ``obs.attr`` — perf-diff attribution: which cause moved a stage
    between two records.
"""

from scconsensus_tpu_torch.obs.trace import (
    Span,
    Tracer,
    current_tracer,
    last_tracer,
    span,
)
from scconsensus_tpu_torch.obs.cost import attach_cost, stage_cost_summary
from scconsensus_tpu_torch.obs.live import (
    LiveRecorder,
    active_recorder,
    flush_active,
)
from scconsensus_tpu_torch.obs.metrics import MetricSet
from scconsensus_tpu_torch.obs import quality  # noqa: F401
from scconsensus_tpu_torch.obs import hostprof, kernels, residency  # noqa
from scconsensus_tpu_torch.obs import compilelog, graphs  # noqa: F401
from scconsensus_tpu_torch.obs.export import (
    SCHEMA_NAME,
    SCHEMA_VERSION,
    build_run_record,
    chrome_trace,
    validate_run_record,
    write_chrome_trace,
    write_json_atomic,
)

__all__ = [
    "quality",
    "residency",
    "kernels",
    "hostprof",
    "compilelog",
    "graphs",
    "Span",
    "Tracer",
    "current_tracer",
    "last_tracer",
    "span",
    "LiveRecorder",
    "active_recorder",
    "flush_active",
    "MetricSet",
    "attach_cost",
    "stage_cost_summary",
    "SCHEMA_NAME",
    "SCHEMA_VERSION",
    "build_run_record",
    "chrome_trace",
    "validate_run_record",
    "write_chrome_trace",
    "write_json_atomic",
]
