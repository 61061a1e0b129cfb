"""Opt-in HTTP ops endpoints over the live metrics plane (counterpart of
``deepspeed_tpu/telemetry/obs_server.py``, the same host code).

A stdlib :class:`~http.server.ThreadingHTTPServer` on a daemon thread —
no new dependencies, off by default (``telemetry.ops_server``), bound to
loopback unless configured otherwise.  Endpoints:

* ``GET /metrics`` — Prometheus text exposition of the local registry;
  when a pod-level cross-rank snapshot has been folded, its aggregates
  follow under the ``dstpu_pod_`` prefix.
* ``GET /healthz`` — liveness contract: ``200``/``503`` with a JSON body
  listing every registered check (watchdog heartbeat age vs its arm
  threshold, last-step age, tier occupancy, …).
* ``GET /slo`` — the :class:`~deepspeed_tpu_torch.telemetry.slo.SLOMonitor`
  machine-readable verdict (``200`` when every rule is ``ok``, ``503``
  while any rule is burning).
* ``GET /goodput`` — the live cumulative
  :class:`~deepspeed_tpu_torch.telemetry.ledger.GoodputLedger` snapshot
  (category seconds, goodput fraction, conservation verdict).
* ``GET /collectives`` — the last cross-rank collective-health fold
  (skew p50/p99, straggler rank + per-rank scores, desync verdict) plus
  this rank's newest ring records.
* ``GET /recovery`` — the collective-recovery ladder state, served when
  a ``recovery_fn`` is set (the JAX package's ``comm/recovery.py``, not
  ported yet: until then the endpoint answers 404).
* ``POST /debug/dump`` (``GET`` accepted for curl ergonomics) — triggers
  a flight-recorder dump and returns its path.

The scrape path only *reads* metric values (one lock per metric), so a
scraper can never stall the training or serving hot path.  Every
request socket carries a read/write timeout (``request_timeout_s``,
default 10s): a scraper that connects and then stalls — mid-request or
mid-response — gets its handler thread back instead of pinning it
forever.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from deepspeed_tpu_torch.telemetry import metrics as _metrics
from deepspeed_tpu_torch.utils.logging import logger


class ObsServer:
    """Lifecycle + routing for the ops endpoints.  ``port=0`` binds an
    ephemeral port (read it back from :attr:`port` after :meth:`start`) —
    the test-friendly default."""

    def __init__(self, registry, host: str = "127.0.0.1", port: int = 0,
                 flight_recorder=None, slo_monitor=None,
                 prefix: str = "dstpu_", request_timeout_s: float = 10.0):
        self.registry = registry
        self.host = host
        self._requested_port = int(port)
        self.flight_recorder = flight_recorder
        self.slo_monitor = slo_monitor
        self.goodput_fn = None     # GoodputLedger.snapshot when wired
        self.collectives_fn = None  # hub.collective_status when wired
        self.recovery_fn = None    # RecoveryManager.status when wired
        self.request_timeout_s = float(request_timeout_s)
        self.prefix = prefix
        self._checks: Dict[str, Callable[[], Dict[str, Any]]] = {}
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- health checks ----------------------------------------------------- #
    def add_health_check(self, name: str,
                         fn: Callable[[], Dict[str, Any]]):
        """Register a liveness check.  ``fn`` returns a JSON-ready dict
        with at least ``{"ok": bool}``; a raising check reports unhealthy
        rather than breaking the endpoint."""
        self._checks[name] = fn

    def health(self) -> Dict[str, Any]:
        checks = {}
        for name, fn in sorted(self._checks.items()):
            try:
                res = dict(fn())
                res.setdefault("ok", False)
            except Exception as e:
                res = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            checks[name] = res
        return {"healthy": all(c["ok"] for c in checks.values()),
                "checks": checks}

    # -- endpoint bodies ---------------------------------------------------- #
    def metrics_text(self) -> str:
        snap = self.registry.snapshot()
        text = _metrics.render_prometheus(snap, prefix=self.prefix)
        pod = self.registry.pod_snapshot
        if pod:
            text += _metrics.render_prometheus(pod, prefix=self.prefix + "pod_",
                                               merged=True)
        return text

    def slo_verdict(self) -> Optional[Dict[str, Any]]:
        if self.slo_monitor is None:
            return None
        return self.slo_monitor.verdict()

    def goodput_snapshot(self) -> Optional[Dict[str, Any]]:
        if self.goodput_fn is None:
            return None
        return self.goodput_fn()

    def collectives_status(self) -> Optional[Dict[str, Any]]:
        if self.collectives_fn is None:
            return None
        return self.collectives_fn()

    def recovery_status(self) -> Optional[Dict[str, Any]]:
        if self.recovery_fn is None:
            return None
        return self.recovery_fn()

    def debug_dump(self) -> Dict[str, Any]:
        if self.flight_recorder is None:
            return {"ok": False, "error": "no flight recorder configured"}
        try:
            path = self.flight_recorder.dump(reason="ops_debug_dump")
            return {"ok": True, "path": path}
        except Exception as e:
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    # -- lifecycle ---------------------------------------------------------- #
    def start(self) -> "ObsServer":
        if self._httpd is not None:
            return self
        server = self

        class Handler(BaseHTTPRequestHandler):
            # per-request read/write deadline: BaseRequestHandler.setup()
            # applies it as the connection's socket timeout, so a stalled
            # scraper times out instead of pinning this handler thread
            timeout = server.request_timeout_s

            def log_message(self, fmt, *args):   # keep stdout clean
                ...

            def handle_timeout(self):
                self.close_connection = True

            def _reply(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                try:
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError, OSError):
                    # OSError covers socket.timeout: a reader that stopped
                    # draining mid-response forfeits the rest of the body
                    self.close_connection = True

            def _json(self, code: int, obj):
                self._reply(code, (json.dumps(obj, sort_keys=True) + "\n")
                            .encode(), "application/json")

            def _route(self):
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                try:
                    if path == "/metrics":
                        self._reply(200, server.metrics_text().encode(),
                                    "text/plain; version=0.0.4")
                    elif path == "/healthz":
                        h = server.health()
                        self._json(200 if h["healthy"] else 503, h)
                    elif path == "/slo":
                        v = server.slo_verdict()
                        if v is None:
                            self._json(404, {"error": "no SLO monitor"})
                        else:
                            self._json(200 if v["ok"] else 503, v)
                    elif path == "/goodput":
                        g = server.goodput_snapshot()
                        if g is None:
                            self._json(404, {"error": "no goodput ledger"})
                        else:
                            self._json(200, g)
                    elif path == "/collectives":
                        c = server.collectives_status()
                        if c is None:
                            self._json(404,
                                       {"error": "no collective monitor"})
                        else:
                            self._json(200, c)
                    elif path == "/recovery":
                        r = server.recovery_status()
                        if r is None:
                            self._json(404, {"error": "no recovery manager"})
                        else:
                            ok = r.get("ladder_state") in ("idle",
                                                           "recovered")
                            self._json(200 if ok else 503, r)
                    elif path == "/debug/dump":
                        d = server.debug_dump()
                        self._json(200 if d["ok"] else 500, d)
                    else:
                        self._json(404, {"error": f"no route {path}"})
                except Exception as e:   # endpoint bug must not kill thread
                    try:
                        self._json(500,
                                   {"error": f"{type(e).__name__}: {e}"})
                    except Exception:
                        pass

            do_GET = _route
            do_POST = _route

        self._httpd = ThreadingHTTPServer((self.host, self._requested_port),
                                          Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="ds-tpu-obs-server", daemon=True)
        self._thread.start()
        logger.info(f"obs server listening on http://{self.host}:{self.port}")
        return self

    @property
    def port(self) -> int:
        if self._httpd is not None:
            return self._httpd.server_address[1]
        return self._requested_port

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self):
        httpd, self._httpd = self._httpd, None
        thread, self._thread = self._thread, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=5.0)


def watchdog_health_check(watchdog) -> Callable[[], Dict[str, Any]]:
    """`/healthz` check: unhealthy once the heartbeat age exceeds the
    watchdog's arm threshold — a wedged collective becomes visible from
    outside the process before SIGTERM lands."""
    def _check():
        age = watchdog.heartbeat_age_s()
        threshold = watchdog.timeout_ns / 1e9
        return {"ok": (not watchdog.armed) or age < threshold,
                "armed": watchdog.armed,
                "heartbeat_age_s": round(age, 3),
                "threshold_s": threshold}
    return _check


def collective_desync_health_check(monitor) -> Callable[[], Dict[str, Any]]:
    """`/healthz` check: 503 once the cross-rank fold has detected a
    fingerprint desync — and it stays unhealthy (a desynced program is
    undefined behavior; the only recovery is a restart)."""
    def _check():
        return monitor.health_check()
    return _check
