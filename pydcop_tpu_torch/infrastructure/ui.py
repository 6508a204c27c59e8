"""The agent's websocket UI (``UiServer``) and the live metrics surface
(``MetricsHttpServer``).

The port's copy of ``pydcop_tpu/infrastructure/ui.py``.  ``UiServer`` is
a computation named ``_ui_<agent>`` running a per-agent WebSocket server
that answers agent and computation state queries and pushes the event
bus's cycle, value and message events to connected clients: a minimal
RFC-6455 server on the stdlib (handshake and unfragmented text frames).
``solve --mode thread --uiport P`` starts one on every agent (ports P,
P+1, ...).  ``MetricsHttpServer``: ``/metrics`` serves the live registry
as Prometheus text (the formatter the ``telemetry --prom`` verb applies
to snapshots), ``/metrics.json`` the raw snapshot and ``/status`` the
owner's status callback, for the ``watch`` verb.  Both only read host
state: a scrape or a UI client makes no CUDA call while the device
solve captures its graphs on its own thread.  Stdlib only: a host-only
verb imports it without torch.
"""

from __future__ import annotations

import base64
import hashlib
import json
import logging
import socket
import struct
import threading
from typing import Any, Callable, Dict, List, Optional

from .computations import MessagePassingComputation
from .events import event_bus

logger = logging.getLogger(__name__)

__all__ = ["UiServer", "MetricsHttpServer"]


_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def _ws_accept_key(key: str) -> str:
    digest = hashlib.sha1((key + _WS_MAGIC).encode("ascii")).digest()
    return base64.b64encode(digest).decode("ascii")


def _ws_encode_text(payload: str) -> bytes:
    data = payload.encode("utf-8")
    header = b"\x81"  # FIN + text opcode
    n = len(data)
    if n < 126:
        header += struct.pack("!B", n)
    elif n < 2 ** 16:
        header += struct.pack("!BH", 126, n)
    else:
        header += struct.pack("!BQ", 127, n)
    return header + data


def _ws_read_frame(conn: socket.socket) -> Optional[str]:
    """Read one text frame; None on close/error.  Client frames are masked."""
    try:
        head = conn.recv(2)
        if len(head) < 2:
            return None
        opcode = head[0] & 0x0F
        masked = head[1] & 0x80
        n = head[1] & 0x7F
        if n == 126:
            n = struct.unpack("!H", conn.recv(2))[0]
        elif n == 127:
            n = struct.unpack("!Q", conn.recv(8))[0]
        mask = conn.recv(4) if masked else b"\x00" * 4
        data = b""
        while len(data) < n:
            chunk = conn.recv(n - len(data))
            if not chunk:
                return None
            data += chunk
        if opcode == 0x8:  # close
            return None
        payload = bytes(b ^ mask[i % 4] for i, b in enumerate(data))
        return payload.decode("utf-8", errors="replace")
    except OSError:
        return None


class UiServer(MessagePassingComputation):
    """WebSocket event streamer + state query endpoint for one agent."""

    def __init__(self, agent, port: int) -> None:
        super().__init__(f"_ui_{agent.name}")
        self.agent = agent
        self.port = port
        self._clients: List[socket.socket] = []
        self._lock = threading.Lock()
        self._server: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------

    def on_start(self) -> None:
        self._bus_was_enabled = event_bus.enabled
        event_bus.enabled = True
        event_bus.subscribe("computations.cycle.*", self._on_bus_event)
        event_bus.subscribe("computations.value.*", self._on_bus_event)
        event_bus.subscribe("computations.message_snd.*", self._on_bus_event)
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(("127.0.0.1", self.port))
        # port 0 binds a free port: the bound one is read back here
        self.port = self._server.getsockname()[1]
        self._server.listen(4)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"ui-{self.agent.name}",
            daemon=True,
        )
        self._accept_thread.start()
        logger.info(
            "ui server for %s on ws://127.0.0.1:%s", self.agent.name,
            self.port,
        )

    def on_stop(self) -> None:
        event_bus.enabled = getattr(self, "_bus_was_enabled", False)
        event_bus.unsubscribe("computations.cycle.*", self._on_bus_event)
        event_bus.unsubscribe("computations.value.*", self._on_bus_event)
        event_bus.unsubscribe(
            "computations.message_snd.*", self._on_bus_event
        )
        with self._lock:
            for c in self._clients:
                try:
                    c.close()
                except OSError:
                    pass
            self._clients.clear()
        if self._server is not None:
            # close() alone leaves a thread blocked in accept() on Linux:
            # that thread, and through it the agent with every computation
            # it hosted, would live until the process exits
            try:
                self._server.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._server.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(5)

    # -- websocket plumbing -------------------------------------------

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            threading.Thread(
                target=self._client_loop, args=(conn,), daemon=True
            ).start()

    def _handshake(self, conn: socket.socket) -> bool:
        data = b""
        while b"\r\n\r\n" not in data:
            chunk = conn.recv(1024)
            if not chunk:
                return False
            data += chunk
        headers: Dict[str, str] = {}
        for line in data.decode("latin1").split("\r\n")[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        key = headers.get("sec-websocket-key")
        if key is None:
            return False
        resp = (
            "HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {_ws_accept_key(key)}\r\n\r\n"
        )
        conn.sendall(resp.encode("latin1"))
        return True

    def _client_loop(self, conn: socket.socket) -> None:
        if not self._handshake(conn):
            conn.close()
            return
        with self._lock:
            self._clients.append(conn)
        while True:
            text = _ws_read_frame(conn)
            if text is None:
                break
            try:
                req = json.loads(text)
            except json.JSONDecodeError:
                continue
            reply = self._answer(req)
            try:
                conn.sendall(_ws_encode_text(json.dumps(reply)))
            except OSError:
                break
        with self._lock:
            if conn in self._clients:
                self._clients.remove(conn)
        conn.close()

    # -- protocol ------------------------------------------------------

    def _answer(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """State queries (pyDCOP's ``ui.py`` commands)."""
        cmd = req.get("cmd")
        if cmd == "agent":
            return {
                "cmd": "agent",
                "agent": self.agent.name,
                "computations": [
                    c.name for c in self.agent.computations
                ],
                "is_running": self.agent.is_running,
            }
        if cmd == "computations":
            return {
                "cmd": "computations",
                "computations": [
                    {
                        "name": c.name,
                        "running": c.is_running,
                        "value": getattr(c, "current_value", None),
                    }
                    for c in self.agent.computations
                ],
            }
        return {"error": f"unknown command {cmd!r}"}

    def _on_bus_event(self, topic: str, evt: Any) -> None:
        if not self._clients:
            # every message of a run passes here once the bus is on:
            # nothing to lock or encode while no client is connected
            return
        with self._lock:
            clients = list(self._clients)
        msg = json.dumps({"topic": topic, "event": repr(evt)})
        for c in clients:
            try:
                c.sendall(_ws_encode_text(msg))
            except OSError:
                pass


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
