"""Robustness layer of the port: the input contract (``robust.contract``),
deterministic fault injection (``robust.faults``), the per-run robustness
log and its validated section (``robust.record``), the typed retry policy
with its error classifier (``robust.retry``) and the computation-integrity
sentinels (``robust.integrity``) and the elastic mesh supervisor
(``robust.elastic``). ``refine()`` runs each stage under the retry policy,
the fault plan and the supervisor's device-loss hook. The soak worker of
the reference is not ported yet (ROADMAP A8)."""
