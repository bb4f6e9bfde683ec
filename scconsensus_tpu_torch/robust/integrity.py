"""Computation-integrity sentinels: the silent-corruption defense.

The port's copy of ``scconsensus_tpu/robust/integrity.py``. Three tiers
behind the registered ``SCC_INTEGRITY`` flag (``off | audit |
enforce``):

**(a) Algebraic invariant checks** at stage boundaries, each O(output)
and on the device until its one scalar residual crosses to the host:

  * ``wilcox_conservation``: midranks over the M pooled cells of a pair
    sum to M(M+1)/2, so U lies in [0, n1·n2] for every (pair, gene), the
    pooled tie term Σ(t³−t) in [0, M³−M], and log p ≤ 0;
  * ``bh_monotonic``: adjusted q ≥ raw p and q ≤ 1 over finite entries;
  * ``pca_orthonormal``: the randomized-subspace basis satisfies
    ‖V·Vᵀ − I‖∞ ≤ tol;
  * ``landmark_occupancy``: the per-landmark occupancies sum to the
    assigned-cell count and every assignment names a live landmark;
  * ``contingency_sums``: the contingency table's row and column sums
    equal the input cluster sizes, and its total equals N.

Violations ride the ambient span (``integrity_violations``) and the
run's integrity log; in **enforce** mode they raise
:class:`InvariantViolation`, which ``robust.retry`` classifies
``silent_corruption``: recompute the unit.

**(b) Sampled ghost replay.** A deterministic sample of units (one
ladder window per rung, one landmark block, one serving batch in 64) is
recomputed through an independent float64 host oracle (scipy midranks
and R's normal approximation for the rank test; float64 products and
argmins for the embed, the landmarks and the classify) and compared
within per-check bands. A mismatch raises :class:`GhostReplayMismatch`
(enforce) or is recorded (audit). The oracles, ``_sample_idx`` and
``want_replay`` are the reference's, so both packages replay the same
units.

**(c) Evidence.** The validated ``integrity`` section (checks planned,
run and passed, violations, ghost-replay counters, mismatches,
recomputes); :func:`validate_integrity` rejects a section that claims
``all_checks_passed`` with less.

On the card a check's scalar read would wait for the kernels queued
before it. Each device check therefore drains the card *before* its
self-timed region opens, so ``consumed_s`` (which the < 2 % guard reads)
holds the layer's own work and not the compute it waited for. The
streaming layer's blocks cross to the host before they are checked, so
their conservation check (``check_wilcox_host``) and chunk replay
(``replay_stream_chunk``) are pure numpy. Left out against the reference:
the heartbeat's ``live_summary`` (with the live recorder).
"""

from __future__ import annotations

import logging
import math
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from scconsensus_tpu_torch.config import env_flag

__all__ = [
    "MODES",
    "IntegrityError",
    "InvariantViolation",
    "GhostReplayMismatch",
    "mode",
    "enabled",
    "enforcing",
    "begin_run",
    "current",
    "section",
    "live_summary",
    "validate_integrity",
    "TOLERANCES",
]

MODES = ("off", "audit", "enforce")

# Per-check tolerance bands, scaled by SCC_INTEGRITY_TOL_SCALE: counts
# are exact below 2^24, but log-space p-values and projected scores round
TOLERANCES: Dict[str, float] = {
    # invariant residuals (absolute)
    "wilcox_conservation": 0.51,   # U/ties bound slack: f32 half-ranks
    "bh_monotonic": 1e-3,          # log-space slack for q >= p, q <= 1
    "pca_orthonormal": 1e-3,       # max |V.Vt - I| after QR in f32
    "landmark_occupancy": 0.0,     # integer conservation is exact
    "contingency_sums": 0.0,       # integer conservation is exact
    # ghost-replay comparison bands (absolute, on the named quantity)
    "replay_wilcox_logp": 5e-2,    # f32 log-p vs float64 oracle
    "replay_wilcox_u": 0.51,       # U is half-integer-exact in f64
    "replay_landmark_d2": 1e-3,    # relative distance-tie slack
    "replay_classify_d2": 1e-3,
    "replay_pca": 1e-2,            # relative, on sampled score rows
}

_LOG = logging.getLogger("scconsensus_tpu_torch")


class IntegrityError(RuntimeError):
    """Base of every typed integrity failure, classified
    ``silent_corruption`` by ``robust.retry``; the recovery is
    recompute-the-unit."""

    def __init__(self, msg: str, check: str = "", site: str = "",
                 magnitude: float = 0.0, tol: float = 0.0):
        super().__init__(msg)
        self.check = check
        self.site = site
        self.magnitude = float(magnitude)
        self.tol = float(tol)


class InvariantViolation(IntegrityError):
    """An algebraic invariant failed at a stage boundary (enforce mode):
    the computation produced output no correct run can produce."""


class GhostReplayMismatch(IntegrityError):
    """A sampled unit, recomputed through the float64 host oracle,
    disagreed with the device result beyond the check's band."""


def mode() -> str:
    m = str(env_flag("SCC_INTEGRITY") or "off").lower()
    return m if m in MODES else "off"


def enabled() -> bool:
    return mode() != "off"


def enforcing() -> bool:
    return mode() == "enforce"


def tol(check: str) -> float:
    return TOLERANCES.get(check, 0.0) * float(
        env_flag("SCC_INTEGRITY_TOL_SCALE")
    )


# capped like robust.record's lists (counts stay exact)
_LIST_CAP = 64


class IntegrityLog:
    """Per-run integrity trail (thread-safe: the serving driver's worker
    thread writes it while the caller reads)."""

    def __init__(self) -> None:
        self.mode = mode()
        # check name -> [planned, run, passed]
        self.checks: Dict[str, List[int]] = {}
        self.violations: List[Dict[str, Any]] = []
        self.replays_planned = 0
        self.replays_run = 0
        self.replays_passed = 0
        self.mismatches: List[Dict[str, Any]] = []
        self.recomputes = 0
        self.consumed_s = 0.0
        self.last_replay_unix: Optional[float] = None
        self._replayed_units: set = set()
        # thread id -> the (kind, key) most recently armed by want_replay
        # on that thread, so a mismatch re-arms exactly the unit it caught
        self._armed_by_thread: Dict[int, Any] = {}
        self._site_streak: Dict[str, int] = {}
        self._n_dropped = 0
        self._lock = threading.Lock()

    # -- counters ----------------------------------------------------------
    def _bucket(self, check: str) -> List[int]:
        return self.checks.setdefault(check, [0, 0, 0])

    def plan(self, check: str, n: int = 1) -> None:
        with self._lock:
            self._bucket(check)[0] += int(n)

    def note_check(self, check: str, site: str, ok: bool,
                   magnitude: float, tolerance: float) -> None:
        with self._lock:
            b = self._bucket(check)
            b[1] += 1
            if ok:
                b[2] += 1
                self._site_streak.pop(site, None)
            else:
                self._site_streak[site] = \
                    self._site_streak.get(site, 0) + 1
                item = {"check": check, "site": site,
                        "magnitude": round(float(magnitude), 6),
                        "tol": round(float(tolerance), 6)}
                if len(self.violations) < _LIST_CAP:
                    self.violations.append(item)
                else:
                    self._n_dropped += 1

    def note_mismatch(self, check: str, site: str, unit: str,
                      magnitude: float, tolerance: float) -> None:
        with self._lock:
            self.replays_run += 1
            self._site_streak[site] = self._site_streak.get(site, 0) + 1
            # re-arm the unit this thread just replayed: the recompute
            # must be verified by the same replay
            armed = self._armed_by_thread.pop(
                threading.get_ident(), None)
            if armed is not None:
                self._replayed_units.discard(armed)
            item = {"check": check, "site": site, "unit": unit,
                    "magnitude": round(float(magnitude), 6),
                    "tol": round(float(tolerance), 6)}
            if len(self.mismatches) < _LIST_CAP:
                self.mismatches.append(item)
            else:
                self._n_dropped += 1
            self.last_replay_unix = time.time()

    def note_replay_ok(self, site: str) -> None:
        with self._lock:
            self.replays_run += 1
            self.replays_passed += 1
            self._site_streak.pop(site, None)
            self._armed_by_thread.pop(threading.get_ident(), None)
            self.last_replay_unix = time.time()

    def note_recompute(self) -> None:
        """A silent_corruption retry recovered: the corrupted unit was
        recomputed (robust.retry and the ladder recovery call this)."""
        with self._lock:
            self.recomputes += 1

    def site_streak(self, site: str) -> int:
        with self._lock:
            return self._site_streak.get(site, 0)

    def reset_streak(self, site: str) -> None:
        with self._lock:
            self._site_streak.pop(site, None)

    def want_replay(self, kind: str, key) -> bool:
        """Deterministic unit sampling: the first unit of each (kind, key)
        per run is the sample (one ladder window per rung, key = the
        window width; one landmark block; one serving batch per 64). Also
        counts the plan. A mismatch re-arms the unit."""
        with self._lock:
            k = (kind, key)
            if k in self._replayed_units:
                return False
            self._replayed_units.add(k)
            self._armed_by_thread[threading.get_ident()] = k
            self.replays_planned += 1
            return True

    def add_consumed(self, dt: float) -> None:
        with self._lock:
            self.consumed_s += max(float(dt), 0.0)

    # -- section -----------------------------------------------------------
    def section(self) -> Optional[Dict[str, Any]]:
        """The ``integrity`` section, or None when the layer never engaged
        (absence is the off-mode signal)."""
        with self._lock:
            if not (self.checks or self.replays_planned
                    or self.mismatches or self.recomputes):
                return None
            planned = sum(b[0] for b in self.checks.values())
            run = sum(b[1] for b in self.checks.values())
            passed = sum(b[2] for b in self.checks.values())
            out: Dict[str, Any] = {
                "mode": self.mode,
                "checks": {"planned": planned, "run": run,
                           "passed": passed},
                "per_check": {
                    name: {"planned": b[0], "run": b[1], "passed": b[2]}
                    for name, b in sorted(self.checks.items())
                },
                "violations": [dict(v) for v in self.violations],
                "ghost": {
                    "planned": self.replays_planned,
                    "run": self.replays_run,
                    "passed": self.replays_passed,
                    "mismatches": [dict(m) for m in self.mismatches],
                    "recomputes": self.recomputes,
                },
                # computed, never asserted
                "all_checks_passed": bool(
                    run == planned and passed == run
                    and not self.violations
                    and self.replays_run == self.replays_planned
                    and self.replays_passed == self.replays_run
                ),
                "consumed_s": round(self.consumed_s, 4),
            }
            if self._n_dropped:
                out["events_dropped"] = self._n_dropped
            return out

    def live_summary(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            if not (self.checks or self.replays_planned
                    or self.mismatches):
                return None
            planned = sum(b[0] for b in self.checks.values())
            run = sum(b[1] for b in self.checks.values())
            passed = sum(b[2] for b in self.checks.values())
            out: Dict[str, Any] = {
                "mode": self.mode,
                "checks_planned": planned,
                "checks_run": run,
                "checks_passed": passed,
                "violations": len(self.violations),
                "replays_run": self.replays_run,
                "replays_planned": self.replays_planned,
                "mismatches": len(self.mismatches),
                "recomputes": self.recomputes,
            }
            if self.last_replay_unix is not None:
                # ghost-replay lag: how stale the newest oracle
                # comparison is
                out["replay_age_s"] = round(
                    max(time.time() - self.last_replay_unix, 0.0), 1
                )
            return out


_RUN: Optional[IntegrityLog] = None


def begin_run() -> IntegrityLog:
    """Fresh integrity log for a new run (refine() entry)."""
    global _RUN
    _RUN = IntegrityLog()
    return _RUN


def current() -> IntegrityLog:
    global _RUN
    if _RUN is None:
        _RUN = IntegrityLog()
    return _RUN


def section() -> Optional[Dict[str, Any]]:
    return _RUN.section() if _RUN is not None else None


def live_summary() -> Optional[Dict[str, Any]]:
    """Compact counters for one heartbeat tick (None = nothing to say)."""
    return _RUN.live_summary() if _RUN is not None else None


class timed:
    """``with timed():`` adds the block's thread-CPU time to the layer's
    self-measured overhead (the < 2 % audit guard reads it). Thread CPU,
    as in the reference; the device checks drain the card before they
    enter, so a wait for earlier kernels is not billed here. The block's
    host↔device copies are the residency auditor's declared
    ``integrity_check`` crossings (the reference's
    ``scconsensus_tpu/robust/integrity.py:514-902``)."""

    def __enter__(self):
        from scconsensus_tpu_torch.obs import residency

        self._bound = residency.boundary("integrity_check")
        self._bound.__enter__()
        self._t0 = time.thread_time()
        return self

    def __exit__(self, *exc):
        current().add_consumed(time.thread_time() - self._t0)
        self._bound.__exit__(*exc)
        return False


def _drain(*xs) -> None:
    """Block until the kernels that produced ``xs`` have retired (a no-op
    for host arrays and CPU tensors)."""
    for x in xs:
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)
            return


def _span_violation(check: str, site: str) -> None:
    """Bump the ambient span's counter so the trace shows where integrity
    tripped."""
    try:
        from scconsensus_tpu_torch.obs import trace as obs_trace

        sp = obs_trace.current_span()
        if sp is not None:
            sp.metrics.counter("integrity_violations").add(1)
            sp.attrs.setdefault("integrity_trips", []).append(
                f"{check}@{site}"
            )
    except Exception:
        pass


def _settle(check: str, site: str, residual: float,
            kind: str = "invariant", unit: str = "") -> None:
    """Record one check outcome; in enforce mode a violation raises the
    typed error (classified silent_corruption: recompute the unit)."""
    band = tol(check)
    ok = float(residual) <= band
    log = current()
    if kind == "replay":
        if ok:
            log.note_replay_ok(site)
            return
        log.note_mismatch(check, site, unit, residual, band)
    else:
        log.note_check(check, site, ok, residual, band)
        if ok:
            return
    _span_violation(check, site)
    _LOG.warning(
        "integrity: %s %s at %s (unit %r): residual %.6g > tol %.6g",
        check, "ghost-replay MISMATCH" if kind == "replay"
        else "invariant VIOLATED", site, unit or site, residual, band,
    )
    if enforcing():
        cls = GhostReplayMismatch if kind == "replay" \
            else InvariantViolation
        raise cls(
            f"silent corruption: {check} at {site}"
            + (f" (unit {unit})" if unit else "")
            + f": residual {residual:.6g} exceeds the tolerance band "
            f"{band:.6g} — the computation produced an answer the "
            "algorithm cannot produce",
            check=check, site=site, magnitude=residual, tol=band,
        )


def should_evict(site: str) -> bool:
    """True when ``site`` accumulated SCC_INTEGRITY_EVICT_THRESHOLD
    consecutive silent-corruption detections: the retry policy escalates
    to its device-loss hook (the elastic supervisor's mesh shrink)
    instead of another recompute on the same mesh, so a device that
    computes wrong is evicted like one that died."""
    thr = max(int(env_flag("SCC_INTEGRITY_EVICT_THRESHOLD")), 1)
    return current().site_streak(site) >= thr


# --------------------------------------------------------------------------
# (a) invariant checks: device reductions, one scalar crosses
# --------------------------------------------------------------------------

def _nan_max(x: torch.Tensor) -> torch.Tensor:
    """Max with NaN entries dropped (−inf); ±inf clamp to the finite
    range as ``jnp.nan_to_num`` does."""
    return torch.max(torch.nan_to_num(x, nan=-math.inf))


def check_wilcox_bucket(site: str, log_p, u, ties, n1, n2) -> None:
    """Rank-sum conservation for one ladder bucket: ``log_p/u/ties`` are
    the (Gb, P) device outputs, ``n1/n2`` host (P,) group sizes. The
    residual is the worst bound violation over the bucket, each bound
    with max(band, 4e-6·bound) of slack for float32 rounding at M³."""
    if not enabled():
        return
    _drain(log_p, u, ties)
    with timed():
        current().plan("wilcox_conservation")
        dev = log_p.device
        t1 = torch.as_tensor(np.asarray(n1, np.float32), device=dev)
        t2 = torch.as_tensor(np.asarray(n2, np.float32), device=dev)
        m = t1 + t2
        umax = t1 * t2
        tmax = m * m * m - m
        band = max(tol("wilcox_conservation"), 1e-12)
        slack_u = torch.clamp(4e-6 * umax, min=band)[None, :]
        slack_t = torch.clamp(4e-6 * tmax, min=band)[None, :]
        # NaN entries (degenerate or untested) drop out: legitimate NaN
        # is the numeric sentinels' territory
        r_u = torch.maximum(-u, u - umax[None, :]) / slack_u
        r_t = torch.maximum(-ties, ties - tmax[None, :]) / slack_t
        r_p = log_p / float(np.float32(max(1e-3, band)))
        resid = torch.maximum(
            _nan_max(r_u), torch.maximum(_nan_max(r_t), _nan_max(r_p)))
        residual = float(resid) * band
    _settle("wilcox_conservation", site, residual)


def check_wilcox_host(site: str, lp: np.ndarray, u: np.ndarray,
                      n1, n2) -> None:
    """Host twin of :func:`check_wilcox_bucket` for blocks that already
    crossed (the streaming runner's per-chunk (P, Gb) fetch): U in
    [0, n1·n2] and log p <= 0, pure numpy, no device traffic."""
    if not enabled():
        return
    with timed():
        current().plan("wilcox_conservation")
        n1 = np.asarray(n1, np.float64)
        n2 = np.asarray(n2, np.float64)
        band = max(tol("wilcox_conservation"), 1e-12)
        umax = (n1 * n2)[:, None]
        slack_u = np.maximum(band, 4e-6 * umax)
        uu = np.asarray(u, np.float64)
        r_u = np.maximum(-uu, uu - umax) / slack_u
        lpp = np.asarray(lp, np.float64) / max(1e-3, band)
        resid = max(
            float(np.nanmax(r_u, initial=-np.inf)),
            float(np.nanmax(lpp, initial=-np.inf)),
        ) * band
        if not np.isfinite(resid):
            resid = 0.0
    _settle("wilcox_conservation", site, resid)


def check_bh(site: str, log_p, log_q) -> None:
    """BH monotonicity over finite entries: q ≥ p and q ≤ 1, one
    reduction over the (P, G) log arrays."""
    if not enabled():
        return
    _drain(log_p, log_q)
    with timed():
        current().plan("bh_monotonic")
        both = torch.isfinite(log_p) & torch.isfinite(log_q)
        ninf = torch.full_like(log_q, -math.inf)
        # r1: q must not undercut p (log_p - log_q <= 0); r2: log_q <= 0
        r1 = torch.where(both, log_p - log_q, ninf)
        r2 = torch.where(torch.isfinite(log_q), log_q, ninf)
        residual = float(torch.maximum(torch.max(r1), torch.max(r2)))
    if not np.isfinite(residual):
        residual = 0.0  # nothing finite to check
    _settle("bh_monotonic", site, residual)


def check_pca_basis(site: str, residual) -> None:
    """Orthonormality residual ‖V·Vᵀ − I‖∞ of the randomized-subspace
    basis (``ops.pca.pca_scores_audited``), one scalar."""
    if not enabled():
        return
    _drain(residual)
    with timed():
        current().plan("pca_orthonormal")
        r = float(residual)
    _settle("pca_orthonormal", site, r)


def check_landmark_occupancy(site: str, assign: np.ndarray,
                             k: int, n_cells: int) -> None:
    """Landmark occupancy conservation over the host assignment: exact,
    zero tolerance."""
    if not enabled():
        return
    with timed():
        current().plan("landmark_occupancy")
        a = np.asarray(assign)
        # out-of-range indices are counted first and kept out of the
        # bincount, which raises on negatives
        bad_idx = int((a < 0).sum() + (a >= int(k)).sum())
        good = a[(a >= 0) & (a < int(k))]
        occ = np.bincount(good, minlength=int(k)) if good.size else \
            np.zeros(int(k), np.int64)
        residual = float(abs(int(occ.sum()) - int(n_cells)) + bad_idx)
    _settle("landmark_occupancy", site, residual)


def check_contingency(site: str, mat: np.ndarray, ridx: np.ndarray,
                      cidx: np.ndarray) -> None:
    """Contingency-table conservation against the unique-inverse index
    vectors the table was built from."""
    if not enabled():
        return
    with timed():
        current().plan("contingency_sums")
        m = np.asarray(mat, np.int64)
        want_rows = np.bincount(np.asarray(ridx), minlength=m.shape[0])
        want_cols = np.bincount(np.asarray(cidx), minlength=m.shape[1])
        residual = float(
            np.abs(m.sum(axis=1) - want_rows).sum()
            + np.abs(m.sum(axis=0) - want_cols).sum()
            + abs(int(m.sum()) - int(np.asarray(ridx).size))
        )
    _settle("contingency_sums", site, residual)


# --------------------------------------------------------------------------
# (b) ghost replay: the independent float64 host oracle
# --------------------------------------------------------------------------

def _midranks64(x: np.ndarray) -> Tuple[np.ndarray, float]:
    """Float64 midranks + pooled tie term Σ(t³−t) — the r6 host
    contraction forms' reference arithmetic, scipy-ranked."""
    from scipy.stats import rankdata

    r = rankdata(x.astype(np.float64), method="average")
    _, counts = np.unique(x.astype(np.float64), return_counts=True)
    t = counts.astype(np.float64)
    return r, float(np.sum(t * t * t - t))


def wilcox_oracle_pair(vals: np.ndarray, cids: np.ndarray,
                       n1: int, n2: int, i: int, j: int,
                       pad_zeros: bool = True) -> Tuple[float, float]:
    """R's normal-approximation rank-sum for ONE (gene, pair) in pure
    float64 — the independent reference path the device ladder is
    replayed against. With ``pad_zeros`` (compacted windows) ``vals``
    holds only the gene's stored POSITIVE entries and absent cells are
    implicit zeros, padded here to the full group sizes ``n1``/``n2``;
    without it (full dense rows) every cell is explicit and values pass
    through as-is. Returns (log_p, U); degenerate slices return
    (nan, U) exactly like the kernel."""
    from scipy.stats import norm

    v = np.asarray(vals, np.float64)
    c = np.asarray(cids)
    if pad_zeros:
        g1 = v[(c == i) & (v > 0)]
        g2 = v[(c == j) & (v > 0)]
        g1 = np.concatenate([g1, np.zeros(max(int(n1) - g1.size, 0))])
        g2 = np.concatenate([g2, np.zeros(max(int(n2) - g2.size, 0))])
    else:
        g1 = v[c == i]
        g2 = v[c == j]
    pooled = np.concatenate([g1, g2])
    ranks, tie_sum = _midranks64(pooled)
    rs1 = float(ranks[: g1.size].sum())
    u = rs1 - n1 * (n1 + 1.0) / 2.0
    z = u - n1 * n2 / 2.0
    z = z - math.copysign(0.5, z) if z != 0.0 else 0.0
    m = float(n1 + n2)
    sigma2 = (n1 * n2 / 12.0) * (
        (m + 1.0) - tie_sum / max(m * (m - 1.0), 1.0)
    )
    if n1 < 1 or n2 < 1 or sigma2 <= 0.0:
        return float("nan"), u
    log_p = min(math.log(2.0) + float(norm.logcdf(-abs(z / math.sqrt(sigma2)))),
                0.0)
    return log_p, u


def _sample_idx(n: int, k: int) -> np.ndarray:
    """Deterministic spread sample of ``k`` indices over [0, n)."""
    if n <= k:
        return np.arange(n)
    return np.unique(np.linspace(0, n - 1, k).astype(np.int64))


def _host_rows(x, rows: np.ndarray) -> np.ndarray:
    """``x[rows]`` on the host: a tensor gathers on its device and crosses
    as the sampled rows only."""
    if isinstance(x, torch.Tensor):
        return x[torch.as_tensor(rows, device=x.device)].cpu().numpy()
    return np.asarray(x)[rows]


def replay_wilcox_window(
    site: str, unit: str,
    vals,                        # (Rows, W) window values, host or device
    cids,                        # (W,) or (Rows, W) cluster ids
    n_of: np.ndarray,            # (K,) full group sizes
    pair_i: np.ndarray, pair_j: np.ndarray,
    out_lp, out_u,               # (Rows, P) device kernel outputs
    n_rows: int,
    full_rows: bool = False,     # True: vals rows hold ALL cells (dense)
    n_genes_sample: int = 3, n_pairs_sample: int = 3,
) -> None:
    """Ghost-replay one sampled ladder window: recompute a seeded
    (genes × pairs) sample through :func:`wilcox_oracle_pair` and compare
    log p and U within the bands. Only the sampled rows (inputs and
    outputs) cross to the host."""
    if not enabled():
        return
    _drain(out_lp, out_u, vals)
    with timed():
        g_sel = _sample_idx(int(n_rows), n_genes_sample)
        ok_pairs = np.nonzero(
            (np.asarray(n_of)[pair_i] >= 1)
            & (np.asarray(n_of)[pair_j] >= 1)
        )[0]
        if not g_sel.size or not ok_pairs.size:
            current().note_replay_ok(site)
            return
        p_sel = ok_pairs[_sample_idx(int(ok_pairs.size), n_pairs_sample)]
        lp_dev = _host_rows(out_lp, g_sel)[:, p_sel]
        u_dev = _host_rows(out_u, g_sel)[:, p_sel]
        vals = _host_rows(vals, g_sel)
        if isinstance(cids, torch.Tensor):
            cids = (_host_rows(cids, g_sel) if cids.dim() == 2
                    else cids.cpu().numpy())
        elif np.asarray(cids).ndim == 2:
            cids = np.asarray(cids)[g_sel]
        cids = np.asarray(cids)
        # one dimensionless residual: each delta normalized by its own
        # band, the worst carried, re-scaled onto the logp band
        worst_norm = 0.0
        tol_p = max(tol("replay_wilcox_logp"), 1e-12)
        tol_u = max(tol("replay_wilcox_u"), 1e-12)
        for gi in range(vals.shape[0]):
            row = np.asarray(vals[gi], np.float64)
            crow = cids[gi] if cids.ndim == 2 else cids
            for pi, p in enumerate(p_sel):
                i, j = int(pair_i[p]), int(pair_j[p])
                n1, n2 = int(n_of[i]), int(n_of[j])
                if full_rows:
                    sel = (crow == i) | (crow == j)
                    lp_ref, u_ref = wilcox_oracle_pair(
                        row[sel], crow[sel], n1, n2, i, j,
                        pad_zeros=False,
                    )
                else:
                    lp_ref, u_ref = wilcox_oracle_pair(
                        row, crow, n1, n2, i, j
                    )
                lp_d, u_d = float(lp_dev[gi, pi]), float(u_dev[gi, pi])
                if np.isnan(lp_ref) != np.isnan(lp_d):
                    worst_norm = max(worst_norm, float("inf"))
                    continue
                if not np.isnan(lp_ref):
                    # absolute band near 0, relative (2 %) for the huge
                    # negative log p where f32 logcdf rounding grows
                    band = max(tol_p, 0.02 * abs(lp_ref))
                    worst_norm = max(worst_norm,
                                     abs(lp_ref - lp_d) / band)
                worst_norm = max(worst_norm, abs(u_ref - u_d) / tol_u)
        worst = worst_norm * tol("replay_wilcox_logp")
    _settle("replay_wilcox_logp", site, worst, kind="replay", unit=unit)


def replay_stream_chunk(site: str, unit: str, block, cids: np.ndarray,
                        n_of: np.ndarray, pair_i: np.ndarray,
                        pair_j: np.ndarray, lp: np.ndarray,
                        u: np.ndarray, n_genes_sample: int = 3,
                        n_pairs_sample: int = 3) -> None:
    """Ghost-replay one streaming chunk: a seeded (genes × pairs) sample
    of the chunk's (P, Gb) host outputs recomputed through the float64
    oracle from the CSR slab's own rows, entirely on the host (the block
    and its outputs already crossed), so the replay adds no device
    traffic."""
    if not enabled():
        return
    with timed():
        gb = int(block.shape[0])
        g_sel = _sample_idx(gb, n_genes_sample)
        ok_pairs = np.nonzero(
            (np.asarray(n_of)[pair_i] >= 1)
            & (np.asarray(n_of)[pair_j] >= 1)
        )[0]
        if not g_sel.size or not ok_pairs.size:
            current().note_replay_ok(site)
            return
        p_sel = ok_pairs[_sample_idx(int(ok_pairs.size), n_pairs_sample)]
        rows = np.asarray(block[g_sel].toarray(), np.float64)
        worst_norm = 0.0
        tol_p = max(tol("replay_wilcox_logp"), 1e-12)
        tol_u = max(tol("replay_wilcox_u"), 1e-12)
        lp = np.asarray(lp)
        u = np.asarray(u)
        cids = np.asarray(cids)
        for gi, g in enumerate(g_sel):
            for p in p_sel:
                i, j = int(pair_i[p]), int(pair_j[p])
                n1, n2 = int(n_of[i]), int(n_of[j])
                sel = (cids == i) | (cids == j)
                lp_ref, u_ref = wilcox_oracle_pair(
                    rows[gi][sel], cids[sel], n1, n2, i, j,
                    pad_zeros=False,
                )
                lp_d, u_d = float(lp[p, g]), float(u[p, g])
                if np.isnan(lp_ref) != np.isnan(lp_d):
                    worst_norm = max(worst_norm, float("inf"))
                    continue
                if not np.isnan(lp_ref):
                    band = max(tol_p, 0.02 * abs(lp_ref))
                    worst_norm = max(worst_norm,
                                     abs(lp_ref - lp_d) / band)
                worst_norm = max(worst_norm, abs(u_ref - u_d) / tol_u)
        worst = worst_norm * tol("replay_wilcox_logp")
    _settle("replay_wilcox_logp", site, worst, kind="replay", unit=unit)


def replay_landmark_block(site: str, x_rows, cent: np.ndarray,
                          assign_rows: np.ndarray, unit: str = "block0",
                          ) -> None:
    """Ghost-replay one landmark-assignment block: float64 nearest-
    landmark argmin against the device assignment, tie-tolerant (a device
    pick is wrong only if the oracle's choice is strictly closer beyond
    the relative band)."""
    if not enabled():
        return
    _drain(x_rows)
    with timed():
        if isinstance(x_rows, torch.Tensor):
            x_rows = x_rows.cpu().numpy()
        x = np.asarray(x_rows, np.float64)
        c = np.asarray(cent, np.float64)
        a = np.asarray(assign_rows)
        d2 = (
            np.sum(x * x, axis=1, keepdims=True)
            - 2.0 * x @ c.T
            + np.sum(c * c, axis=1)[None, :]
        )
        best = np.min(d2, axis=1)
        chosen = d2[np.arange(a.size), np.clip(a, 0, c.shape[0] - 1)]
        scale = np.maximum(np.abs(best), 1e-9)
        bad_idx = (a < 0) | (a >= c.shape[0])
        worst = float(np.max(np.where(
            bad_idx, np.inf, (chosen - best) / scale
        ))) if a.size else 0.0
    _settle("replay_landmark_d2", site, worst, kind="replay", unit=unit)


def replay_pca_rows(site: str, x, mean, components, scores,
                    n_rows: int, unit: str = "rows",
                    n_sample: int = 4) -> None:
    """Ghost-replay sampled embedding rows: float64
    (x − mean) @ componentsᵀ against the device scores, relative band.
    The sampled rows and the small mean and basis are the only
    crossing."""
    if not enabled():
        return
    _drain(x, scores)
    with timed():
        sel = _sample_idx(int(n_rows), n_sample)
        if not sel.size:
            current().note_replay_ok(site)
            return
        xr = _host_rows(x, sel)
        sr = _host_rows(scores, sel)
        mu = (mean.cpu().numpy() if isinstance(mean, torch.Tensor)
              else np.asarray(mean))
        vt = (components.cpu().numpy()
              if isinstance(components, torch.Tensor)
              else np.asarray(components))
        xh = np.asarray(xr, np.float64)
        ref = (xh - np.asarray(mu, np.float64)[None, :]) \
            @ np.asarray(vt, np.float64).T
        got = np.asarray(sr, np.float64)
        scale = max(float(np.max(np.abs(ref))), 1e-6)
        worst = float(np.max(np.abs(ref - got))) / scale
    _settle("replay_pca", site, worst, kind="replay", unit=unit)


def replay_classify(site: str, x: np.ndarray, labels: np.ndarray,
                    model, unit: str = "batch") -> None:
    """Ghost-replay one serving batch: the frozen model's float64 host
    mirror (``classify_host``) against the device labels, tie-tolerant.
    A disagreement beyond the band means the device answered with labels
    its own model cannot produce."""
    if not enabled():
        return
    with timed():
        ref_lab, _ = model.classify_host(np.asarray(x))
        got = np.asarray(labels)
        if got.shape != ref_lab.shape:
            worst = float("inf")
        else:
            diff = got != ref_lab
            if not diff.any():
                worst = 0.0
            else:
                # a differing label is a true mismatch only when the
                # oracle's landmark is strictly closer than the device's
                # beyond the relative band
                xp = model._gather_panel(np.asarray(x)).astype(np.float64)
                proj = (xp - model.pca_mean.astype(np.float64)) @ \
                    model.pca_components.astype(np.float64).T
                c = model.centroids.astype(np.float64)
                d2 = (
                    np.sum(proj * proj, axis=1, keepdims=True)
                    - 2.0 * proj @ c.T
                    + np.sum(c * c, axis=1)[None, :]
                )
                best = np.min(d2, axis=1)
                lab_to_cent: Dict[int, np.ndarray] = {}
                clab = model.centroid_labels.astype(np.int64)
                worst = 0.0
                for r in np.nonzero(diff)[0]:
                    lr = int(got[r])
                    cands = lab_to_cent.setdefault(
                        lr, np.nonzero(clab == lr)[0]
                    )
                    chosen = float(np.min(d2[r, cands])) if cands.size \
                        else float("inf")
                    worst = max(
                        worst,
                        (chosen - float(best[r]))
                        / max(abs(float(best[r])), 1e-9),
                    )
    _settle("replay_classify_d2", site, worst, kind="replay", unit=unit)


# --------------------------------------------------------------------------
# schema validation (stdlib)
# --------------------------------------------------------------------------

def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"integrity section: {msg}")


def _nonneg(v: Any, name: str) -> int:
    _require(isinstance(v, int) and v >= 0,
             f"{name} must be an int >= 0, got {v!r}")
    return v


def validate_integrity(ig: Dict[str, Any]) -> None:
    """Structural validation of an ``integrity`` section. The load-bearing
    rule: a section claiming ``all_checks_passed`` must have run every
    check it planned, passed every check it ran and matched every ghost
    replay."""
    _require(isinstance(ig, dict), "must be an object")
    _require(ig.get("mode") in ("audit", "enforce"),
             f"mode must be 'audit' or 'enforce', got {ig.get('mode')!r}")
    ch = ig.get("checks")
    _require(isinstance(ch, dict), "checks must be an object")
    planned = _nonneg(ch.get("planned"), "checks.planned")
    run = _nonneg(ch.get("run"), "checks.run")
    passed = _nonneg(ch.get("passed"), "checks.passed")
    _require(run <= planned,
             f"checks.run ({run}) exceeds checks.planned ({planned})")
    _require(passed <= run,
             f"checks.passed ({passed}) exceeds checks.run ({run})")
    violations = ig.get("violations", [])
    _require(isinstance(violations, list), "violations must be a list")
    for i, v in enumerate(violations):
        _require(isinstance(v, dict) and bool(v.get("check"))
                 and bool(v.get("site")),
                 f"violations[{i}] needs check and site")
    per = ig.get("per_check", {})
    _require(isinstance(per, dict), "per_check must be an object")
    for name, b in per.items():
        _require(isinstance(b, dict), f"per_check[{name}] must be an "
                                      "object")
        p_, r_, s_ = (_nonneg(b.get(k), f"per_check[{name}].{k}")
                      for k in ("planned", "run", "passed"))
        _require(s_ <= r_ <= p_,
                 f"per_check[{name}] counters must satisfy "
                 "passed <= run <= planned")
    gh = ig.get("ghost")
    _require(isinstance(gh, dict), "ghost must be an object")
    g_planned = _nonneg(gh.get("planned"), "ghost.planned")
    g_run = _nonneg(gh.get("run"), "ghost.run")
    g_passed = _nonneg(gh.get("passed"), "ghost.passed")
    _require(g_run <= g_planned,
             f"ghost.run ({g_run}) exceeds ghost.planned ({g_planned})")
    _require(g_passed <= g_run,
             f"ghost.passed ({g_passed}) exceeds ghost.run ({g_run})")
    mms = gh.get("mismatches", [])
    _require(isinstance(mms, list), "ghost.mismatches must be a list")
    _require(len(mms) <= max(g_run - g_passed, 0),
             f"ghost.mismatches lists {len(mms)} entries but only "
             f"{max(g_run - g_passed, 0)} replays failed — a mismatch "
             "that never ran is fabricated evidence")
    recomputes = _nonneg(gh.get("recomputes", 0), "ghost.recomputes")
    if ig.get("all_checks_passed"):
        _require(
            run == planned,
            "all_checks_passed claimed with checks_run < checks_planned "
            f"({run} < {planned}) — a check that never ran proves "
            "nothing, and claiming otherwise is the exact failure this "
            "layer exists to catch",
        )
        _require(passed == run and not violations,
                 "all_checks_passed claimed with failed checks or "
                 "recorded violations — the claim contradicts its own "
                 "evidence")
        _require(g_run == g_planned and g_passed == g_run,
                 "all_checks_passed claimed with unmatched or unrun "
                 "ghost replays")
    if recomputes:
        _require(
            len(mms) >= 1 or g_run > g_passed or passed < run
            or bool(violations),
            "recomputes claimed with no recorded detection (no "
            "mismatch, no violation) — a recompute without a detection "
            "is a phantom corruption",
        )
