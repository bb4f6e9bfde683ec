"""Online serving: label new cells against a frozen consensus model.

The port of ``scconsensus_tpu/serve/``: a frozen consensus-model artifact
(``serve.model``: DE-gene panel, PCA basis, landmark centroids and tree,
drift calibration, stored and verified through the ArtifactStore's
sha256 and quarantine), a one-device-call ``classify`` on the card, a
micro-batching driver (``serve.driver``) with bounded admission,
per-request deadlines, a circuit breaker over the device path whose host
path is flagged degraded, and drift quarantine, and the serving fleet
(``serve.fleet``: replica pool with hot-swap, wire front, reconsensus
loop, load generator and autoscaler). ``serve.metrics`` validates the
``serving`` section: every submitted request is accounted for by exactly
one outcome.

``model``, ``driver`` and ``fleet`` are loaded on first use of their
names.
"""

from scconsensus_tpu_torch.serve.errors import (  # noqa: F401
    DeadlineExceeded,
    ModelLoadError,
    QueueFull,
    RequestFailed,
    RequestInvalid,
    ServeError,
    ServerClosed,
)
from scconsensus_tpu_torch.serve.metrics import (  # noqa: F401
    OUTCOMES,
    ServingStats,
    validate_serving,
)

__all__ = [
    "ServeError",
    "ModelLoadError",
    "RequestInvalid",
    "QueueFull",
    "DeadlineExceeded",
    "ServerClosed",
    "RequestFailed",
    "OUTCOMES",
    "ServingStats",
    "validate_serving",
]


def __getattr__(name):
    if name in ("ConsensusServer", "ServeConfig", "ServeResponse",
                "CircuitBreaker"):
        from scconsensus_tpu_torch.serve import driver

        return getattr(driver, name)
    if name in ("ConsensusModel", "export_consensus_model",
                "load_consensus_model"):
        from scconsensus_tpu_torch.serve import model

        return getattr(model, name)
    if name in ("ReplicaPool", "WireFront", "run_reconsensus"):
        from scconsensus_tpu_torch.serve import fleet

        return getattr(fleet, name)
    raise AttributeError(name)
