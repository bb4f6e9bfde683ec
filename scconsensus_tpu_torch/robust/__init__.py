"""Robustness layer of the port: the input contract (``robust.contract``),
deterministic fault injection (``robust.faults``), the per-run robustness
log and its validated section (``robust.record``) and the typed retry
policy with its error classifier (``robust.retry``). Integrity checks,
the elastic mesh and the soak worker of the reference are not ported
yet, and ``refine()`` does not run under the fault plan or the retry
policy yet (ROADMAP A8)."""
