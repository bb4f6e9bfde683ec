"""The serving fleet: wire front, multi-replica hot-swap, reconsensus loop.

The port of ``scconsensus_tpu/serve/fleet/``. What stands between the
``ConsensusServer`` driver and real traffic:

* ``fleet.pool``: :class:`ReplicaPool`, N ``ConsensusServer`` replicas on
  one device behind one shared admission layer, with least-depth
  routing, per-replica circuit breakers, model hot-swap by artifact
  fingerprint (v2 loaded through the readonly sha256 path, an atomic
  cutover, v1's in-flight batches drained: a request is never split
  across models) and routing keyed on the model fingerprint;
* ``fleet.wire``: :class:`WireFront`, a stdlib threaded HTTP front where
  every wire request resolves to exactly one typed outcome mapped to
  exactly one status code, plus ``/healthz``, ``/metrics`` (OpenMetrics)
  and ``/metrics.json``;
* ``fleet.reconsensus``: the drift-to-reconsensus loop (quarantined
  cells, classified against the frozen landmarks, the spill
  mini-refined, merged by the contingency heuristic, exported and
  hot-swapped back);
* ``fleet.loadgen``: the open-loop load generator, whose headline is
  sustained RPS at SLO;
* ``fleet.autoscale``: the burn-rate autoscaler, a pure table-testable
  policy actuating replica width, admission and degraded mode.

Every entry point that builds a replica or a model takes ``device``
(``cuda`` unless ``device="cpu"``; with no card it raises). This module
imports neither torch nor the modules below until a name is used, so
``obs.export`` can import ``validate_loadgen`` cheaply.
"""

__all__ = ["ReplicaPool", "WireFront", "Autoscaler", "AutoscalePolicy",
           "run_load", "run_reconsensus",
           "reconsensus_update", "read_quarantine_batch"]


def __getattr__(name):
    if name == "ReplicaPool":
        from scconsensus_tpu_torch.serve.fleet.pool import ReplicaPool

        return ReplicaPool
    if name == "WireFront":
        from scconsensus_tpu_torch.serve.fleet.wire import WireFront

        return WireFront
    if name in ("Autoscaler", "AutoscalePolicy"):
        from scconsensus_tpu_torch.serve.fleet import autoscale

        return getattr(autoscale, name)
    if name == "run_load":
        from scconsensus_tpu_torch.serve.fleet.loadgen import run_load

        return run_load
    if name in ("run_reconsensus", "reconsensus_update",
                "read_quarantine_batch"):
        from scconsensus_tpu_torch.serve.fleet import reconsensus

        return getattr(reconsensus, name)
    raise AttributeError(name)
