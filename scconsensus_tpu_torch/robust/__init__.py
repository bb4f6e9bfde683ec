"""Robustness layer of the port: the input contract (``robust.contract``),
deterministic fault injection (``robust.faults``), the per-run robustness
log and its validated section (``robust.record``), the typed retry policy
with its error classifier (``robust.retry``) and the computation-integrity
sentinels (``robust.integrity``). ``refine()`` runs each stage under the
retry policy and the fault plan. The elastic mesh and the soak worker of
the reference are not ported yet (ROADMAP A7, A8)."""
