"""Wire front: a stdlib threaded HTTP server over the fleet.

The port of ``scconsensus_tpu/serve/fleet/wire.py``. Every wire request
resolves to exactly one typed outcome mapped to exactly one status code
(``serve.metrics.WireStats`` counts both sides; the run record's
``serving.wire`` subsection is validated):

    ==================  ======  =======================================
    outcome             status  meaning
    ==================  ======  =======================================
    ok                  200     labels returned (device path)
    degraded            200     labels returned, ``degraded: true``
                                (host fallback behind a tripped breaker)
    quarantined         409     drift gate refused confident labels;
                                ledgered for the reconsensus loop
    rejected_queue      429     bounded-admission backpressure;
                                ``Retry-After`` carries the EWMA hint
    rejected_invalid    422     malformed body / wrong gene dimension /
                                oversized / non-finite cells / unknown
                                model fingerprint
    rejected_closed     503     fleet closed or draining
    deadline_exceeded   504     queue wait or compute overran the
                                request deadline
    failed              500     fatal batch error (typed RequestFailed)
    ==================  ======  =======================================

``GET /healthz`` answers 200 while the backend accepts traffic and 503
once it is closed; ``GET /metrics`` returns the OpenMetrics text
exposition (per-outcome counters, per-stage fixed-bucket latency
histograms, queue and breaker gauges, per replica and fleet-aggregated
from one swap-lock snapshot, plus the wire counters and the live SLO);
``GET /metrics.json`` returns ``serve.metrics.live_summary`` (the fleet
panel included).

Every classify response (success or typed refusal) carries the request's
trace id in ``X-SCC-Trace-Id`` and in the JSON body: adopted from the
client's header or body (how a retried request keeps its id), or minted
here with ``SCC_OBS_TRACE`` on.

``POST /classify`` accepts two bodies:

* ``application/json``: ``{"cells": [[...], ...], "deadline_s"?: s,
  "model_fp"?: fp}`` (fp addresses a routed model in a multi-model
  fleet);
* ``application/x-npy``: a raw ``.npy`` float matrix (the bulk path: no
  JSON float inflation on big batches), with ``X-SCC-Deadline-S`` and
  ``X-SCC-Model-FP`` headers for the extras.

Responses are JSON either way; every served response carries
``model_fp``, the fingerprint of the model that answered (the hot-swap
purity check's evidence).

Fault site (``robust.faults``): ``wire_request`` fires on every classify
request before admission.
"""

from __future__ import annotations

import io
import json
import math
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

import numpy as np

from scconsensus_tpu_torch.config import env_flag
from scconsensus_tpu_torch.obs.trace import new_trace_id
from scconsensus_tpu_torch.robust import faults
from scconsensus_tpu_torch.serve import metrics as serve_metrics
from scconsensus_tpu_torch.serve import slo as serve_slo
from scconsensus_tpu_torch.serve.driver import ServeResponse
from scconsensus_tpu_torch.serve.errors import (
    DeadlineExceeded,
    QueueFull,
    RequestFailed,
    RequestInvalid,
    ServerClosed,
)

__all__ = ["OUTCOME_STATUS", "TRACE_HEADER", "WireFront"]

# The mapping: one outcome, one status code. One copy, owned by serve.slo
# so the exposition and the availability classification can never drift
# from the wire's table (re-exported here, where callers import it).
OUTCOME_STATUS: Dict[str, int] = serve_slo.OUTCOME_STATUS

# The trace-id header, both directions: a client (or a retrying client —
# the resubmit keeps its id) sends it; every response echoes the id that
# actually traced the request.
TRACE_HEADER = "X-SCC-Trace-Id"

# Adopted (client-supplied) ids must look like ids: bounded length,
# header-safe charset. The id is echoed into a response header and
# appended to the shared quarantine ledger / heartbeat ring, so an
# unvalidated value would let one client split responses (CRLF) or
# bloat cross-request evidence. Anything else is ignored and a fresh
# id is minted.
_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9_-]{1,64}$")


def _clean_trace_id(raw) -> Optional[str]:
    if not raw:
        return None
    raw = str(raw).strip()
    return raw if _TRACE_ID_RE.match(raw) else None

# Extra margin past the request deadline before the wire gives up on the
# handle: the backend resolves typed DeadlineExceeded itself; this only
# bounds a driver-bug hang so the socket never waits forever.
_RESULT_SLACK_S = 30.0


class WireFront:
    """Threaded HTTP front over a ``ReplicaPool`` or a bare
    ``ConsensusServer``. Use as a context manager or
    :meth:`start`/:meth:`stop`."""

    def __init__(self, backend, host: str = "127.0.0.1",
                 port: Optional[int] = None):
        self.backend = backend
        self.host = host
        self.port_requested = int(port if port is not None
                                  else env_flag("SCC_FLEET_WIRE_PORT"))
        self.wire_stats = serve_metrics.WireStats()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "WireFront":
        if self._httpd is not None:
            return self
        httpd = ThreadingHTTPServer((self.host, self.port_requested),
                                    _WireHandler)
        httpd.daemon_threads = True
        httpd.front = self  # type: ignore[attr-defined]
        self._httpd = httpd
        self._thread = threading.Thread(target=httpd.serve_forever,
                                        name="scc-wire", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)

    def __enter__(self) -> "WireFront":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("wire front is not started")
        return int(self._httpd.server_address[1])

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- record ------------------------------------------------------------
    def serving_section(self) -> Dict[str, Any]:
        """The backend's validated serving section with the wire-layer
        accounting attached (``serving.wire`` — submitted == Σ outcomes
        == Σ status codes, enforced by ``validate_serving``)."""
        sec = self.backend.serving_section()
        sec["wire"] = self.wire_stats.section()
        return sec

    def slo_section(self, snap: Optional[Dict[str, Any]] = None,
                    wire_expo: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
        """The validated ``slo`` run-record section, anchored at the
        wire: availability and burn windows over the WIRE outcome
        counters (the one stream every fleet request passes), end-to-end
        per-outcome latency histograms from the wire's observations,
        per-stage histograms from the backend's merged replicas, p99
        from the backend's merged raw sample rings. ``snap``/
        ``wire_expo`` let telemetry_text build counters, gauges, and
        SLO from the SAME instant."""
        we = wire_expo or self.wire_stats.expo_snapshot()
        b = self.backend
        stage_hist = None
        p99 = None
        if hasattr(b, "telemetry_snapshot"):
            snap = snap or b.telemetry_snapshot()
            merged = [ms for r in snap["replicas"] for ms in r["samples"]]
            for samples in snap.get("retired_samples") or []:
                # killed/swapped-out replicas' tails stay in the gated
                # p99 — retirement must lose zero latency evidence
                merged.extend(samples)
            p99 = serve_slo.p99_ms(merged)
            stage_hist = b.expo_scopes(snap)[-1]["stage_hist"]
        else:
            p99 = b.stats.latency_ms().get("p99")
            stage_hist = b.stats.expo_snapshot()["stage_hist"]
        return serve_slo.build_slo_section(
            we["counts"], p99, we["window_deltas"],
            latency_hist=we["latency_hist"],
            stage_hist=stage_hist,
            obs_overhead=serve_slo.obs_overhead(),
        )

    def telemetry_text(self) -> str:
        """The OpenMetrics exposition, assembled from ONE backend
        telemetry snapshot (taken under the pool's swap lock) and ONE
        wire snapshot, both shared with the SLO gauges — a scrape
        racing a hot-swap can never see a torn replica table, and a
        scrape's SLO gauges can never disagree with its own counters."""
        b = self.backend
        we = self.wire_stats.expo_snapshot()
        snap = None
        if hasattr(b, "telemetry_snapshot"):
            snap = b.telemetry_snapshot()
            scopes = b.expo_scopes(snap)
        else:
            e = b.stats.expo_snapshot()
            scope = {
                "labels": {"replica": "0",
                           "model": b.model.fingerprint()[:8]},
                "counts": e["counts"], "queue_depth": e["queue_depth"],
                "queue_cap": e["queue_cap"], "breaker": e["breaker"],
                "trips": e["trips"], "latency_hist": e["latency_hist"],
                "stage_hist": e["stage_hist"],
            }
            scopes = [scope, {**scope, "labels": {"replica": "fleet"}}]
        return serve_slo.render_openmetrics({
            "scopes": scopes,
            "wire": we,
            "slo": self.slo_section(snap=snap, wire_expo=we),
        })

    # -- backend adapter ---------------------------------------------------
    def _submit(self, cells: np.ndarray, deadline_s: Optional[float],
                model_fp: Optional[str],
                trace_id: Optional[str] = None):
        b = self.backend
        if hasattr(b, "hot_swap"):  # a ReplicaPool routes by fingerprint
            return b.submit(cells, deadline_s=deadline_s,
                            model_fp=model_fp, trace_id=trace_id)
        if model_fp and model_fp != b.model.fingerprint():
            raise RequestInvalid(
                f"this server holds model {b.model.fingerprint()!r}, "
                f"not {model_fp!r}"
            )
        return b.submit(cells, deadline_s=deadline_s, trace_id=trace_id)


def _parse_deadline(dl) -> Optional[float]:
    """A malformed deadline is a malformed REQUEST (422), not a driver
    failure (500) — parse errors must stay in the rejected_invalid
    bucket the status table promises."""
    if dl is None or dl == "":
        return None
    try:
        return float(dl)
    except (TypeError, ValueError):
        raise RequestInvalid(f"deadline_s is not a number: {dl!r}")


def _response_body(resp: ServeResponse) -> Dict[str, Any]:
    return {
        "req_id": resp.req_id,
        "outcome": resp.outcome,
        "labels": (None if resp.labels is None
                   else [int(v) for v in resp.labels]),
        "degraded": bool(resp.degraded),
        "quarantined": bool(resp.quarantined),
        "drift_fraction": round(float(resp.drift_fraction), 6),
        "latency_s": round(float(resp.latency_s), 6),
        "model_fp": resp.model_fp,
        "trace_id": resp.trace_id,
    }


class _WireHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"  # keep-alive: bulk clients reuse sockets
    # TCP_NODELAY: a reply goes out as two writes (headers, then body), and
    # with Nagle's algorithm the body waits for the client's delayed ACK of
    # the headers, about 40 ms on every keep-alive request (ROADMAP C23)
    disable_nagle_algorithm = True
    server: ThreadingHTTPServer

    # one request, one accounting entry — never stderr spam per hit
    def log_message(self, fmt: str, *args) -> None:  # noqa: A003
        pass

    @property
    def front(self) -> WireFront:
        return self.server.front  # type: ignore[attr-defined]

    def _send_json(self, status: int, body: Dict[str, Any],
                   headers: Optional[Dict[str, str]] = None) -> None:
        # a request answered before its body was read (an unknown path, a
        # wire_request fault) drains the body first: left in the socket,
        # it would be parsed as the next request on this keep-alive
        # connection, which would then get an uncounted 400
        left, self._unread = getattr(self, "_unread", 0), 0
        if left > 0:
            self.rfile.read(left)
        payload = json.dumps(body).encode()
        self.send_response(int(status))
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        try:
            self.wfile.write(payload)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client gone; the outcome is already accounted

    def _send_text(self, status: int, text: str, ctype: str) -> None:
        payload = text.encode("utf-8")
        self.send_response(int(status))
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        try:
            self.wfile.write(payload)
        except (BrokenPipeError, ConnectionResetError):
            pass

    # -- GET: health + metrics ---------------------------------------------
    def do_GET(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler API
        path = self.path.split("?")[0]
        if path == "/healthz":
            closed = bool(getattr(self.front.backend, "closed", False))
            live = serve_metrics.live_summary() or {}
            body = {"status": "unhealthy" if closed else "ok",
                    "breaker": live.get("breaker"),
                    "queue_depth": live.get("queue_depth")}
            self._send_json(503 if closed else 200, body)
        elif path == "/metrics":
            # OpenMetrics text exposition: per-replica and
            # fleet-aggregated series from ONE swap-lock snapshot; the
            # JSON live summary is /metrics.json
            try:
                text = self.front.telemetry_text()
            except Exception as e:  # noqa: BLE001 - scrape must answer
                self._send_json(500,
                                {"error": f"{type(e).__name__}: {e}"})
                return
            self._send_text(
                200, text,
                "application/openmetrics-text; version=1.0.0; "
                "charset=utf-8",
            )
        elif path == "/metrics.json":
            live = serve_metrics.live_summary()
            self._send_json(200, live if live is not None
                            else {"serving": "idle"})
        else:
            self._send_json(404, {"error": f"unknown path {path!r}"})

    # -- POST: classify ----------------------------------------------------
    def _finish_wire(self, outcome: str, status: int,
                     body: Dict[str, Any],
                     headers: Optional[Dict[str, str]] = None,
                     trace_id: Optional[str] = None,
                     t0: Optional[float] = None) -> None:
        if trace_id is None and env_flag("SCC_OBS_TRACE"):
            # refusal paths (including a body that never parsed) still
            # get a traceable typed response
            trace_id = new_trace_id()
        latency = (time.monotonic() - t0) if t0 is not None else None
        self.front.wire_stats.note(outcome, status, latency_s=latency,
                                   trace_id=trace_id)
        body.setdefault("outcome", outcome)
        if trace_id:
            # the response carries the id BOTH ways (header for bulk
            # clients that drop the body, body for everyone else)
            body.setdefault("trace_id", trace_id)
            headers = {**(headers or {}), TRACE_HEADER: trace_id}
        self._send_json(status, body, headers)

    def _parse_body(self) -> Tuple[np.ndarray, Optional[float],
                                   Optional[str], Optional[str]]:
        n = int(self.headers.get("Content-Length") or 0)
        if n <= 0:
            raise RequestInvalid("empty request body")
        raw = self.rfile.read(n)
        self._unread = 0
        ctype = (self.headers.get("Content-Type") or "").split(";")[0]
        if ctype == "application/x-npy":
            try:
                cells = np.load(io.BytesIO(raw), allow_pickle=False)
            except ValueError as e:
                raise RequestInvalid(f"unparseable npy payload: {e}")
            dl = self.headers.get("X-SCC-Deadline-S")
            fp = self.headers.get("X-SCC-Model-FP")
            return cells, _parse_deadline(dl), (fp or None), None
        try:
            doc = json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise RequestInvalid(f"unparseable JSON body: {e}")
        if not isinstance(doc, dict) or "cells" not in doc:
            raise RequestInvalid('body must be {"cells": [[...], ...]}')
        try:
            cells = np.asarray(doc["cells"], np.float32)
        except (TypeError, ValueError) as e:
            raise RequestInvalid(f"cells is not a numeric matrix: {e}")
        return cells, _parse_deadline(doc.get("deadline_s")), (
            doc.get("model_fp") or None
        ), (str(doc["trace_id"]) if doc.get("trace_id") else None)

    def do_POST(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler API
        try:
            self._unread = max(int(self.headers.get("Content-Length")
                                   or 0), 0)
        except ValueError:
            self._unread = 0
        path = self.path.split("?")[0]
        if path != "/classify":
            self._send_json(404, {"error": f"unknown path {path!r}"})
            return
        front = self.front
        t0 = time.monotonic()
        # adoption order: header, then JSON-body trace_id, then mint —
        # a client-supplied id wins either way (that is how a retry
        # keeps its id across attempts; the postmortem bundle shows
        # both under one trace). Minting waits until after the body
        # parse so a body-supplied id is never shadowed; _finish_wire
        # mints for the refusal paths, so even a malformed request
        # still gets a traceable response.
        trace_id = _clean_trace_id(self.headers.get(TRACE_HEADER))
        try:
            faults.fault_point("wire_request")
            cells, deadline_s, model_fp, body_trace = self._parse_body()
            if trace_id is None:
                trace_id = _clean_trace_id(body_trace)
            if trace_id is None and env_flag("SCC_OBS_TRACE"):
                trace_id = new_trace_id()
            handle = front._submit(cells, deadline_s, model_fp,
                                   trace_id=trace_id)
            wait = ((deadline_s
                     if deadline_s is not None
                     else getattr(front.backend, "config", None)
                     and front.backend.config.default_deadline_s) or 30.0)
            resp = handle.result(timeout=float(wait) + _RESULT_SLACK_S)
            self._finish_wire(resp.outcome, OUTCOME_STATUS[resp.outcome],
                              _response_body(resp),
                              trace_id=resp.trace_id or trace_id, t0=t0)
        except QueueFull as e:
            self._finish_wire(
                "rejected_queue", 429,
                {"error": str(e),
                 "retry_after_s": round(e.retry_after_s, 4)},
                headers={"Retry-After":
                         str(max(1, math.ceil(e.retry_after_s)))},
                trace_id=trace_id, t0=t0,
            )
        except RequestInvalid as e:
            self._finish_wire("rejected_invalid", 422, {"error": str(e)},
                              trace_id=trace_id, t0=t0)
        except ServerClosed as e:
            self._finish_wire("rejected_closed", 503, {"error": str(e)},
                              trace_id=trace_id, t0=t0)
        except DeadlineExceeded as e:
            self._finish_wire(
                "deadline_exceeded", 504,
                {"error": str(e), "late_by_s": round(e.late_by_s, 4)},
                trace_id=trace_id, t0=t0,
            )
        except RequestFailed as e:
            self._finish_wire("failed", 500,
                              {"error": str(e),
                               "error_class": e.error_class},
                              trace_id=trace_id, t0=t0)
        except Exception as e:  # noqa: BLE001
            # the last-ditch guard: even a wire/driver bug resolves as a
            # counted typed outcome — a socket that dies uncounted is the
            # dropped-request failure mode one layer up
            self._finish_wire("failed", 500,
                              {"error": f"{type(e).__name__}: {e}"},
                              trace_id=trace_id, t0=t0)
