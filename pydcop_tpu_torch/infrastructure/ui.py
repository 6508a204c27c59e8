"""The live metrics surface: ``MetricsHttpServer``.

Counterpart of the ``MetricsHttpServer`` half of
``pydcop_tpu/infrastructure/ui.py`` (the websocket ``UiServer`` belongs
to the agent runtime, which the port does not run yet): ``/metrics``
serves the live registry as Prometheus text (the formatter the
``telemetry --prom`` verb applies to snapshots), ``/metrics.json`` the
raw snapshot and ``/status`` the owner's status callback, for the
``watch`` verb.  Stdlib only: a host-only verb imports it without torch.
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Any, Callable, Dict, Optional

logger = logging.getLogger(__name__)

__all__ = ["MetricsHttpServer"]


class MetricsHttpServer:
    """Scrape endpoint: ``/metrics`` (Prometheus text 0.0.4, or
    OpenMetrics with exemplars on ``?format=openmetrics`` or an ``Accept:
    application/openmetrics-text``), ``/metrics.json`` (the registry
    snapshot) and ``/status`` (``status_cb()``).  ``port=0`` binds a free
    port, read back from ``.port``.  The built-in routes only read.

    ``routes`` mounts more endpoints on the same port (the serve front's
    submit, result, health and shutdown): a dict of ``(method,
    path_prefix)`` to ``callback(path, body_bytes)``, which answers
    ``(http_status, json_payload)`` or ``(http_status, json_payload,
    headers)``.  The longest matching prefix wins; the built-in GET routes
    come first.  A callback that raises answers 500 with its message; an
    unknown path answers 404, both with a JSON body.

    ``snapshot_cb`` points ``/metrics`` and ``/metrics.json`` at another
    snapshot source of ``MetricsRegistry.snapshot()``'s shape."""

    def __init__(
        self,
        port: int = 0,
        status_cb: Optional[Callable[[], Dict[str, Any]]] = None,
        host: str = "127.0.0.1",
        routes: Optional[Dict[Any, Callable]] = None,
        snapshot_cb: Optional[Callable[[], Dict[str, Any]]] = None,
    ) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.status_cb = status_cb
        self.snapshot_cb = snapshot_cb
        self.routes = dict(routes or {})
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, data: bytes, ctype: str,
                      headers: Optional[Dict[str, Any]] = None) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(str(k), str(v))
                self.end_headers()
                self.wfile.write(data)

            def _json(self, code: int, payload: Any,
                      headers: Optional[Dict[str, Any]] = None) -> None:
                data = json.dumps(payload, default=str).encode("utf-8")
                self._send(code, data, "application/json", headers)

            def _dispatch_route(self, method: str, path: str) -> bool:
                """Serve from ``outer.routes``; True when a route matched
                (whatever it answered)."""
                best = None
                for (m, prefix), cb in outer.routes.items():
                    if m != method:
                        continue
                    if path == prefix or path.startswith(prefix + "/"):
                        if best is None or len(prefix) > len(best[0]):
                            best = (prefix, cb)
                if best is None:
                    return False
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                headers: Dict[str, Any] = {}
                try:
                    answer = best[1](path, body)
                    if len(answer) == 3:
                        code, payload, headers = answer
                    else:
                        code, payload = answer
                except Exception as e:  # noqa: BLE001 (answer, keep serving)
                    logger.exception("route %s %s failed", method, path)
                    code, payload, headers = 500, {"error": str(e)}, {}
                self._json(code, payload, headers)
                return True

            def _not_found(self, path: str) -> None:
                self._json(404, {"error": f"no route {path}"})

            def do_POST(self) -> None:
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                if not self._dispatch_route("POST", path):
                    self._not_found(path)

            def do_GET(self) -> None:
                query = (
                    self.path.split("?", 1)[1] if "?" in self.path else ""
                )
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                try:
                    if path == "/metrics":
                        from ..telemetry.prom import (
                            OPENMETRICS_CONTENT_TYPE,
                            PROMETHEUS_CONTENT_TYPE,
                        )

                        om = (
                            "format=openmetrics" in query
                            or "application/openmetrics-text"
                            in (self.headers.get("Accept") or "")
                        )
                        body = outer._metrics_text(openmetrics=om)
                        ctype = (OPENMETRICS_CONTENT_TYPE if om
                                 else PROMETHEUS_CONTENT_TYPE)
                    elif path == "/metrics.json":
                        body = outer._metrics_json()
                        ctype = "application/json"
                    elif path in ("/status", "/"):
                        body = outer._status_json()
                        ctype = "application/json"
                    elif self._dispatch_route("GET", path):
                        return
                    else:
                        self._not_found(path)
                        return
                except Exception as e:  # noqa: BLE001 (a broken callback
                    # answers 500 and leaves the server thread alive)
                    logger.exception("metrics endpoint %s failed", path)
                    self._send(500, str(e).encode("utf-8", "replace"),
                               "text/plain")
                    return
                self._send(200, body.encode("utf-8"), ctype)

            def log_message(self, fmt, *args) -> None:  # the log has it
                logger.debug("metrics http: " + fmt, *args)

        class Server(ThreadingHTTPServer):
            # tenants connect in bursts: the stdlib backlog of 5 would
            # reset concurrent submitters
            request_queue_size = 128
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self.host = host
        self._lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name=f"metrics-http-{self.port}",
            daemon=True,
        )
        self._thread.start()
        logger.info("metrics endpoint on http://%s:%s/metrics", host,
                    self.port)

    def _snapshot(self) -> Dict[str, Any]:
        if self.snapshot_cb is not None:
            return self.snapshot_cb()
        from ..telemetry.metrics import metrics_registry

        return metrics_registry.snapshot()

    def _metrics_text(self, openmetrics: bool = False) -> str:
        from ..telemetry.prom import render_prometheus

        return render_prometheus(self._snapshot(), openmetrics=openmetrics)

    def _metrics_json(self) -> str:
        return json.dumps(self._snapshot(), indent=2, sort_keys=True)

    def _status_json(self) -> str:
        status = self.status_cb() if self.status_cb is not None else {}
        return json.dumps(status, default=str)

    def shutdown(self) -> None:
        """Stop serving and close the socket (once; later calls return)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._server.shutdown()
        self._server.server_close()
