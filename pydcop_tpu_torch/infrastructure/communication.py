"""Communication layers and per-agent messaging queues (control plane).

The port's copy of ``pydcop_tpu/infrastructure/communication.py``: the
``CommunicationLayer`` protocol with its ignore/fail/retry error modes,
``InProcessCommunicationLayer`` (the address is the layer object,
delivery a function call), ``HttpCommunicationLayer`` (one JSON POST a
message, routing fields in the body, retries through
``retry.RetryPolicy``), message priorities, and ``Messaging`` (one
priority queue an agent, parking of messages for destinations not known
yet, per-computation counts).

It carries control traffic only: registration, deployment, metrics and
value read-backs.  Algorithm messages never exist on the host: a cycle
is a replay of the solve's CUDA graphs.  A stdlib ``http.server`` and
``urllib`` transport is enough for the dozens of management messages a
computation costs.
"""

from __future__ import annotations

import itertools
import json
import logging
import queue
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..telemetry.metrics import metrics_registry
from ..telemetry.tracing import tracer
from ..utils.simple_repr import from_repr, simple_repr
from .computations import Message
from .events import event_bus
from .retry import RetryPolicy

__all__ = [
    "MSG_DISCOVERY",
    "MSG_MGT",
    "MSG_VALUE",
    "MSG_ALGO",
    "UnreachableAgent",
    "UnknownComputation",
    "UnknownAgent",
    "CommunicationLayer",
    "InProcessCommunicationLayer",
    "HttpCommunicationLayer",
    "Messaging",
    "RetryPolicy",
    "find_local_ip",
]

logger = logging.getLogger("pydcop_tpu_torch.infrastructure.communication")

# Priorities, lower runs first (pyDCOP communication.py:495-497 and
# discovery.py:77).
MSG_DISCOVERY = 5
MSG_MGT = 10
MSG_VALUE = 15
MSG_ALGO = 20

# Telemetry handles, created once at import (creation never requires the
# registry to be enabled): per-call get-or-create would take the registry
# lock on the million-message delivery path.  Every write below is guarded
# by an enabled-flag check first — telemetry off costs one attribute read
# (see docs/observability.md for the measured numbers).
_m_sent = metrics_registry.counter(
    "comms.messages_sent", "messages posted through Messaging, by agent"
)
_m_recv = metrics_registry.counter(
    "comms.messages_received", "messages delivered to a queue, by agent"
)
_m_bytes_sent = metrics_registry.counter(
    "comms.payload_bytes_sent", "posted message payload bytes, by agent"
)
_m_bytes_recv = metrics_registry.counter(
    "comms.payload_bytes_received",
    "delivered message payload bytes, by agent",
)
_m_queue_depth = metrics_registry.gauge(
    "comms.queue_depth", "message-queue depth at last delivery, by agent"
)
_m_latency = metrics_registry.histogram(
    "comms.delivery_seconds",
    "enqueue-to-consume latency of delivered messages, by agent",
)
_m_http_sent = metrics_registry.counter(
    "comms.http_bytes_sent", "HTTP transport bytes posted to peers"
)
_m_http_recv = metrics_registry.counter(
    "comms.http_bytes_received", "HTTP transport bytes received from peers"
)
_m_send_failures = metrics_registry.counter(
    "comms.send_failures",
    "sends abandoned after exhausting retries, by agent and destination",
)
_m_retry_attempts = metrics_registry.counter(
    "comms.retry_attempts", "transport send retries performed, by agent"
)
_m_dead_letters = metrics_registry.counter(
    "comms.dead_letters",
    "parked messages dropped by TTL expiry or buffer cap, by agent",
)
_m_parked_depth = metrics_registry.gauge(
    "comms.parked_depth", "parked-message buffer depth, by agent"
)


class UnreachableAgent(Exception):
    pass


class UnknownComputation(Exception):
    pass


class UnknownAgent(Exception):
    pass


def find_local_ip() -> str:
    """Best-effort local IP (pyDCOP communication.py:297)."""
    import socket

    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("10.255.255.255", 1))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


class CommunicationLayer:
    """Transport protocol: delivers (sender_comp, dest_comp, msg, prio) to the
    agent at ``address``.  ``on_error``: 'ignore' | 'fail' | 'retry'
    (pyDCOP communication.py:68-79)."""

    def __init__(self, on_error: str = "ignore") -> None:
        if on_error not in ("ignore", "fail", "retry"):
            raise ValueError(f"invalid on_error mode {on_error!r}")
        self.on_error = on_error
        self.messaging: Optional["Messaging"] = None

    @property
    def address(self) -> Any:
        raise NotImplementedError

    def send_msg(
        self,
        src_agent: str,
        dest_agent: str,
        address: Any,
        sender_comp: str,
        dest_comp: str,
        msg: Message,
        prio: int,
    ) -> bool:
        raise NotImplementedError

    def shutdown(self) -> None:
        pass

    def deliver(
        self, src_agent: str, sender_comp: str, dest_comp: str,
        msg: Message, prio: int,
    ) -> None:
        """Hand an inbound message to the local Messaging instance.

        Raises UnknownComputation when this agent does not host the
        destination — pyDCOP's 404 answer (communication.py:447)."""
        if self.messaging is None:
            raise UnreachableAgent("communication layer has no messaging")
        if dest_comp not in self.messaging._local_computations:
            raise UnknownComputation(dest_comp)
        self.messaging.deliver_local(sender_comp, dest_comp, msg, prio)


class InProcessCommunicationLayer(CommunicationLayer):
    """Same-process transport: the address IS the layer object and sending is
    a direct function call into the target's queue (pyDCOP
    communication.py:207-276)."""

    @property
    def address(self) -> "InProcessCommunicationLayer":
        return self

    def send_msg(
        self, src_agent, dest_agent, address, sender_comp, dest_comp, msg,
        prio,
    ) -> bool:
        if not isinstance(address, InProcessCommunicationLayer):
            raise UnreachableAgent(
                f"in-process layer cannot reach address {address!r}"
            )
        address.deliver(src_agent, sender_comp, dest_comp, msg, prio)
        return True

    def __repr__(self) -> str:
        return f"InProcessCommunicationLayer({id(self):#x})"


class _HttpHandler:
    """Request handler factory bound to a communication layer (pyDCOP
    MPCHttpHandler:447)."""

    def __new__(cls, layer: "HttpCommunicationLayer"):
        from http.server import BaseHTTPRequestHandler

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self) -> None:
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
                if metrics_registry.enabled:
                    _m_http_recv.inc(length)
                try:
                    payload = json.loads(raw.decode("utf-8"))
                    msg = from_repr(payload["msg"])
                    cycle_id = payload.get("cycle_id")
                    if cycle_id is not None:
                        msg._cycle_id = cycle_id
                    trace_ctx = payload.get("trace")
                    if trace_ctx is not None:
                        # restore the sender's trace context so the
                        # delivery/consume flow points in THIS process
                        # carry the same flow_id as the remote send
                        msg._trace_ctx = tuple(trace_ctx)
                    layer.deliver(
                        payload.get("src_agent", "?"),
                        payload["sender_comp"],
                        payload["dest_comp"],
                        msg,
                        int(payload.get("prio", MSG_ALGO)),
                    )
                except UnknownComputation:
                    self.send_response(404)
                    self.end_headers()
                    return
                except Exception as e:  # malformed payload
                    logger.error("bad http message: %s", e)
                    self.send_response(400)
                    self.end_headers()
                    return
                self.send_response(204)
                self.end_headers()

            def log_message(self, fmt, *args) -> None:  # silence stderr
                logger.debug("http: " + fmt, *args)

        return Handler


class HttpCommunicationLayer(CommunicationLayer):
    """Multi-machine transport: an embedded ``http.server`` thread receives
    JSON-serialized messages; sending is one POST per message with routing
    fields in the body (pyDCOP communication.py:313-441).  Addresses are
    ``(host, port)`` tuples."""

    def __init__(
        self,
        address: Optional[Tuple[str, int]] = None,
        on_error: str = "ignore",
        retry_policy: Optional[RetryPolicy] = None,
    ) -> None:
        super().__init__(on_error)
        # applies in 'retry' mode only; the default keeps roughly the old
        # 3-attempt cadence but with exponential backoff + full jitter so
        # many senders retrying into one recovering peer do not stampede
        self.retry_policy = retry_policy or RetryPolicy(
            max_attempts=3, base_delay=0.2, max_delay=2.0
        )
        from http.server import ThreadingHTTPServer

        host, port = address or ("127.0.0.1", 9000)
        self._server = ThreadingHTTPServer(
            (host, port), _HttpHandler(self)
        )
        # advertise a routable address: a wildcard bind would make remote
        # peers POST to their own loopback (pyDCOP find_local_ip:297)
        public_host = find_local_ip() if host in ("", "0.0.0.0") else host
        self._address = (public_host, self._server.server_address[1])
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name=f"http-comm-{self._address[1]}",
            daemon=True,
        )
        self._thread.start()

    @property
    def address(self) -> Tuple[str, int]:
        return self._address

    def send_msg(
        self, src_agent, dest_agent, address, sender_comp, dest_comp, msg,
        prio,
    ) -> bool:
        import urllib.error
        import urllib.request

        host, port = address
        payload: Dict[str, Any] = {
            "src_agent": src_agent,
            "sender_comp": sender_comp,
            "dest_comp": dest_comp,
            "prio": prio,
            "msg": simple_repr(msg),
        }
        cycle_id = getattr(msg, "_cycle_id", None)
        if cycle_id is not None:
            payload["cycle_id"] = cycle_id
        trace_ctx = getattr(msg, "_trace_ctx", None)
        if trace_ctx is not None:
            payload["trace"] = list(trace_ctx)
        data = json.dumps(payload).encode("utf-8")
        if metrics_registry.enabled:
            _m_http_sent.inc(len(data))
        req = urllib.request.Request(
            f"http://{host}:{port}/pydcop",
            data=data,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        policy = self.retry_policy
        attempts = policy.max_attempts if self.on_error == "retry" else 1
        started = policy.start()
        attempt = 0
        last_error: Optional[Exception] = None
        while True:
            try:
                with urllib.request.urlopen(req, timeout=2.0):
                    return True
            except (urllib.error.URLError, OSError, TimeoutError) as e:
                if (
                    isinstance(e, urllib.error.HTTPError)
                    and e.code == 404
                ):
                    # receiver does not host dest_comp: the sender's
                    # Messaging parks the message for re-send on discovery
                    raise UnknownComputation(dest_comp) from e
                # any other HTTP error (5xx from a peer mid-restart) is as
                # transient as a transport error: same fail/retry/backoff
                if self.on_error == "fail":
                    raise UnreachableAgent(
                        f"cannot reach {dest_agent} at {address}: {e}"
                    ) from e
                last_error = e
                logger.warning(
                    "http send to %s failed (attempt %d/%d): %s",
                    address, attempt + 1, attempts, e,
                )
                if attempt + 1 >= attempts:
                    break
                if not policy.sleep_before_retry(attempt, started):
                    break  # deadline exhausted
                if metrics_registry.enabled:
                    _m_retry_attempts.inc(agent=src_agent)
                attempt += 1
        # exhausted: a False return is indistinguishable from success at
        # most call sites, so the giving-up itself must be loud (one ERROR
        # line) and countable (comms.send_failures)
        logger.error(
            "giving up on message %s -> %s for %s at %s after %d "
            "attempt(s): %s",
            sender_comp, dest_comp, dest_agent, address, attempt + 1,
            last_error,
        )
        if metrics_registry.enabled:
            _m_send_failures.inc(agent=src_agent, dest=dest_agent)
        return False

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    def __repr__(self) -> str:
        return f"HttpCommunicationLayer({self._address})"


class _Mailbox:
    """An agent's message queue: the lowest priority number first, FIFO
    among equals (the order of ``queue.PriorityQueue`` with a counter
    tie-break, which the JAX package uses), for one consumer, the owning
    agent's thread.

    A put appends to its priority's ``deque`` (atomic under the GIL) and
    takes a lock only to create a priority's lane or to wake a consumer
    that sleeps.  ``queue.PriorityQueue`` takes its mutex on every put:
    with eight agents acknowledging deploys into the orchestrator's one
    queue, the mutex's hand-offs between threads, each waiting for the
    GIL, were most of a 100,000-variable MaxSum deployment's time."""

    def __init__(self) -> None:
        self._lanes: Dict[int, deque] = {}
        self._order: List[deque] = []  # the lanes, lowest priority first
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._waiting = False

    def put(self, item: Tuple) -> None:
        lane = self._lanes.get(item[0])
        if lane is None:
            with self._lock:
                lane = self._lanes.get(item[0])
                if lane is None:
                    lane = deque()
                    self._lanes[item[0]] = lane
                    self._order = [
                        self._lanes[p] for p in sorted(self._lanes)
                    ]
        lane.append(item)
        # read after the append: a consumer that flagged itself waiting
        # before this append re-checks its lanes or gets woken here
        if self._waiting:
            self._wake.set()

    def _pop(self) -> Optional[Tuple]:
        for lane in self._order:
            if lane:
                return lane.popleft()
        return None

    def get(self, timeout: float) -> Tuple:
        """The next item; ``queue.Empty`` after ``timeout`` seconds."""
        item = self._pop()
        if item is not None:
            return item
        deadline = time.monotonic() + timeout
        while True:
            self._wake.clear()
            self._waiting = True
            try:
                item = self._pop()
                if item is not None:
                    return item
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._wake.wait(remaining):
                    item = self._pop()
                    if item is None:
                        raise queue.Empty
                    return item
            finally:
                self._waiting = False

    def qsize(self) -> int:
        return sum(len(lane) for lane in self._order)

    def empty(self) -> bool:
        return not any(self._order)


class Messaging:
    """Per-agent messaging: one priority queue feeding the agent thread;
    routing between local delivery and the communication layer; parking of
    messages whose destination is not known yet, resent on discovery
    (pyDCOP communication.py:500-726)."""

    #: default bounds on the parked-message buffer: parking exists to
    #: bridge the deploy/discovery window (milliseconds to seconds), so
    #: anything older than the TTL is a message to a destination that
    #: will never exist — unbounded growth was a slow leak on every
    #: long-lived agent
    PARKED_CAP = 10_000
    PARKED_TTL = 30.0

    def __init__(
        self,
        agent_name: str,
        comm: CommunicationLayer,
        delay: float = 0.0,
        parked_cap: int = PARKED_CAP,
        parked_ttl: Optional[float] = PARKED_TTL,
    ) -> None:
        self.agent_name = agent_name
        self.comm = comm
        comm.messaging = self
        self.delay = delay  # artificial delay for GUI observation (:582)
        self._queue = _Mailbox()
        self._local_computations: Dict[str, Any] = {}
        self._counter = itertools.count()  # FIFO tie-break, lock-free
        self._lock = threading.Lock()
        # computation name -> (agent name, address)
        self._routes: Dict[str, Tuple[str, Any]] = {}
        # (parked-at monotonic time, sender, dest, msg, prio), oldest first
        self._parked: List[Tuple[float, str, str, Message, int]] = []
        self._parked_cap = max(1, parked_cap)
        self._parked_ttl = parked_ttl
        self._dead_letters = 0
        self.count_ext_msg: Dict[str, int] = {}
        self.size_ext_msg: Dict[str, int] = {}
        # single-writer: only the owning agent thread pops messages
        self._consumed = 0

    @property
    def msg_queue_count(self) -> int:
        """Cumulative deliveries so far (consumed + currently queued).
        Derived, not maintained: an unsynchronized counter store in
        deliver_local could go backward under concurrent deliveries, and
        a lock there was the 1M-deployment convoy.  The consistent-read
        loop makes successive readings monotone: a snapshot where
        ``_consumed`` did not move around the qsize read measures total
        deliveries, which only grows."""
        for _ in range(100):
            c1 = self._consumed
            q = self._queue.qsize()
            if self._consumed == c1:
                return c1 + q
        return c1 + q  # consumer never idle: accept a near snapshot

    # -- topology ------------------------------------------------------

    def register_computation(self, name: str, computation: Any) -> None:
        self._local_computations[name] = computation

    def seal(self) -> None:
        """Refuse all further inbound delivery (crash simulation):
        ``CommunicationLayer.deliver`` checks ``_local_computations``, so
        clearing it makes every delivery answer ``UnknownComputation`` —
        the in-process analogue of a dead process's connection-refused /
        404.  Senders then re-park instead of dropping messages into a
        dead queue that counts them as delivered."""
        self._local_computations.clear()

    def unregister_computation(self, name: str) -> None:
        self._local_computations.pop(name, None)

    def register_route(
        self, computation: str, agent_name: str, address: Any
    ) -> None:
        """Record where a remote computation lives; flushes any parked
        messages for it (pyDCOP :710-726)."""
        with self._lock:
            self._routes[computation] = (agent_name, address)
            parked, self._parked = self._parked, []
        if parked and metrics_registry.enabled:
            _m_parked_depth.set(0, agent=self.agent_name)
        # re-post outside the lock: post_msg re-parks what still lacks a
        # route (and may recurse into this lock).  _replayed: the original
        # post already counted these messages in the telemetry sinks.
        # TTL is deliberately NOT applied here: a message that waited past
        # the TTL but whose route finally arrived is exactly the delivery
        # parking exists for (expiry happens lazily, on new parks).
        # _parked_at rides along so a re-park keeps the ORIGINAL park
        # time — otherwise every route registration would reset every
        # still-parked message's TTL clock and the bound would never bind.
        for parked_at, sender_comp, dest_comp, msg, prio in parked:
            self.post_msg(
                sender_comp, dest_comp, msg, prio, _replayed=True,
                _parked_at=parked_at,
            )

    def unregister_route(self, computation: str) -> None:
        with self._lock:
            self._routes.pop(computation, None)

    @property
    def local_computations(self) -> List[str]:
        return list(self._local_computations)

    # -- parked-message bounds ----------------------------------------

    @property
    def parked_count(self) -> int:
        with self._lock:
            return len(self._parked)

    @property
    def dead_letter_count(self) -> int:
        """Parked messages dropped by TTL expiry or the buffer cap."""
        with self._lock:
            return self._dead_letters

    def _park_locked(
        self,
        sender_comp: str,
        dest_comp: str,
        msg: Message,
        prio: int,
        parked_at: Optional[float] = None,
    ) -> List[Tuple[str, Tuple[float, str, str, Message, int]]]:
        """Park one message; returns the (reason, entry) pairs
        dead-lettered to make room — logged by the caller OUTSIDE the
        lock.  ``parked_at`` carries a replayed message's ORIGINAL park
        time so its TTL clock keeps running across re-parks; the list is
        therefore not timestamp-sorted and expiry/eviction scan it
        (bounded by the cap, and only on the no-route slow path).  Every
        caller already holds ``self._lock`` (the per-method analysis
        cannot see a caller-held guard, hence the disables)."""
        now = time.monotonic()
        dead: List[Tuple[str, Tuple[float, str, str, Message, int]]] = []
        if self._parked_ttl is not None:
            cutoff = now - self._parked_ttl
            keep = []
            for entry in self._parked:  # graftlint: disable=lock-unguarded-read
                (dead if entry[0] < cutoff else keep).append(entry)
            dead = [("ttl", e) for e in dead]
            self._parked = keep  # graftlint: disable=lock-unguarded-write
        if len(self._parked) >= self._parked_cap:  # graftlint: disable=lock-unguarded-read
            # evict the oldest: it has waited longest for a route that
            # never came, so it is the most likely to be undeliverable
            oldest = min(range(len(self._parked)), key=lambda i: self._parked[i][0])  # graftlint: disable=lock-unguarded-read
            dead.append(("cap", self._parked.pop(oldest)))  # graftlint: disable
        self._parked.append((parked_at if parked_at is not None else now, sender_comp, dest_comp, msg, prio))  # graftlint: disable=lock-unguarded-write
        self._dead_letters += len(dead)
        if metrics_registry.enabled:
            _m_parked_depth.set(len(self._parked), agent=self.agent_name)  # graftlint: disable=lock-unguarded-read
        return dead

    def _report_dead_letters(
        self,
        dead: List[Tuple[str, Tuple[float, str, str, Message, int]]],
    ) -> None:
        for reason, (_parked_at, sender_comp, dest_comp, msg, _prio) in dead:
            logger.error(
                "%s: dead-lettered parked message %s -> %s (%s, %s)",
                self.agent_name, sender_comp, dest_comp, msg.type,
                "no route within TTL" if reason == "ttl"
                else "parked buffer full",
            )
            if metrics_registry.enabled:
                _m_dead_letters.inc(agent=self.agent_name)

    # -- sending -------------------------------------------------------

    def post_msg(
        self,
        sender_comp: str,
        dest_comp: str,
        msg: Message,
        prio: Optional[int] = None,
        *,
        _replayed: bool = False,
        _parked_at: Optional[float] = None,
    ) -> None:
        prio = MSG_ALGO if prio is None else prio
        # the documented ``computations.message_snd.<name>`` topic
        # (events.py) is published HERE, at the transport layer, so every
        # message — computation traffic and management messages posted
        # straight to Messaging — is observed exactly once: a message that
        # parks (no route yet, or a 404 re-park) re-enters through
        # register_route's flush with ``_replayed=True`` and is not
        # counted again
        if not _replayed:
            if event_bus.enabled:
                event_bus.send(
                    f"computations.message_snd.{sender_comp}",
                    (dest_comp, msg.type),
                )
            if metrics_registry.enabled:
                _m_sent.inc(agent=self.agent_name)
                _m_bytes_sent.inc(
                    getattr(msg, "size", 0) or 0, agent=self.agent_name
                )
            if tracer.enabled:
                # stamp the envelope with a compact trace context —
                # (trace_id, flow_id, send wall-clock, parent span) — and
                # emit the flow START anchored to a comms.send micro-slice
                # on this (sending) thread.  The context rides the message
                # across parks, replays and the HTTP transport, so the
                # delivery/consume points pair up by flow_id even in a
                # different process; a re-park keeps the ORIGINAL context
                # (one logical message == one flow).
                ctx = getattr(msg, "_trace_ctx", None)
                if ctx is None:
                    ctx = (
                        tracer.trace_id,
                        tracer.new_flow_id(),
                        time.time(),
                        tracer.current_span(),
                    )
                    try:
                        msg._trace_ctx = ctx
                    except AttributeError:
                        pass  # slotted message type: flow still recorded
                tracer.flow_point(
                    "s", "comms.send", ctx[1], src=sender_comp,
                    dest=dest_comp, type=msg.type, agent=self.agent_name,
                )
        if dest_comp in self._local_computations:
            self.deliver_local(sender_comp, dest_comp, msg, prio)
            return
        # lock-free fast path for the route lookup (a dict read): during
        # a 1M-computation deployment every agent thread posts acks
        # through here, and taking the lock per message formed a lock
        # convoy that turned deployment super-linear (sampled: the lock
        # acquisition dominated all useful work)
        route = self._routes.get(dest_comp)  # graftlint: disable=lock-unguarded-read
        if route is None:
            dead = None
            with self._lock:
                # re-check under the lock register_route swaps the parked
                # list under, so a message can never fall between the
                # route write and the flush (pyDCOP :637-650)
                route = self._routes.get(dest_comp)
                if route is None:
                    logger.debug(
                        "%s: parking message %s -> %s", self.agent_name,
                        sender_comp, dest_comp,
                    )
                    dead = self._park_locked(
                        sender_comp, dest_comp, msg, prio,
                        parked_at=_parked_at,
                    )
            if dead is not None:
                self._report_dead_letters(dead)
                return
        dest_agent, address = route
        try:
            delivered = self.comm.send_msg(
                self.agent_name, dest_agent, address, sender_comp,
                dest_comp, msg, prio,
            )
        except UnknownComputation:
            # destination moved or not deployed yet (receiver answered the
            # pyDCOP's 404): drop the stale route and park for re-send
            # once discovery updates it (pyDCOP :637-650)
            logger.info(
                "%s: %s not (yet) at %s, parking message from %s",
                self.agent_name, dest_comp, dest_agent, sender_comp,
            )
            with self._lock:
                self._routes.pop(dest_comp, None)
                dead = self._park_locked(
                    sender_comp, dest_comp, msg, prio, parked_at=_parked_at
                )
            self._report_dead_letters(dead)
            return
        if delivered and prio > MSG_MGT:
            # metrics track algorithm/value traffic only; management
            # and discovery messages are overhead, not workload
            # (pyDCOP communication.py, pinned by pyDCOP's
            # test_do_not_count_mgt_messages).  Counted AFTER a successful
            # send so a 404 re-park + register_route replay cannot count
            # the same logical message twice (its replay is the one and
            # only successful send)
            with self._lock:
                self.count_ext_msg[sender_comp] = (
                    self.count_ext_msg.get(sender_comp, 0) + 1
                )
                self.size_ext_msg[sender_comp] = (
                    self.size_ext_msg.get(sender_comp, 0) + msg.size
                )

    # -- receiving -----------------------------------------------------

    def deliver_local(
        self, sender_comp: str, dest_comp: str, msg: Message, prio: int
    ) -> None:
        if self.delay:
            time.sleep(self.delay)
        # ``computations.message_rcv.<name>``: the receive-side twin of the
        # post_msg publication above, fired at delivery (covers remote
        # inbound via CommunicationLayer.deliver too).  All three sinks are
        # flag-gated: this is the million-message path where an
        # unconditional lock was the deployment convoy.
        if event_bus.enabled:
            event_bus.send(
                f"computations.message_rcv.{dest_comp}",
                (sender_comp, msg.type),
            )
        if metrics_registry.enabled:
            _m_recv.inc(agent=self.agent_name)
            _m_bytes_recv.inc(
                getattr(msg, "size", 0) or 0, agent=self.agent_name
            )
            _m_queue_depth.set(
                self._queue.qsize() + 1, agent=self.agent_name
            )
        if tracer.enabled:
            # transport arrival: a flow STEP on the delivering thread (the
            # sender's thread in-process; the http server thread remotely).
            # The consume point in next_msg emits the finish on the OWNING
            # agent's thread — the receiving agent's track in Perfetto.
            ctx = getattr(msg, "_trace_ctx", None)
            if ctx is not None:
                tracer.flow_point(
                    "t", "comms.recv", ctx[1], src=sender_comp,
                    dest=dest_comp, type=msg.type, agent=self.agent_name,
                )
            else:
                tracer.instant(
                    "comms.recv", cat="comms", src=sender_comp,
                    dest=dest_comp, type=msg.type,
                )
        # LOCK-FREE: itertools.count() is atomic under the GIL, and the
        # queue has its own (short-hold) mutex.  Serializing every
        # delivery through self._lock was the deployment bottleneck at
        # 1M computations — 9 threads funneling 2M+ control messages
        # into the orchestrator formed a lock convoy.
        self._queue.put(
            (
                prio, next(self._counter), time.perf_counter(),
                sender_comp, dest_comp, msg,
            )
        )

    def next_msg(
        self, timeout: float = 0.05
    ) -> Optional[Tuple[str, str, Message, float]]:
        """Pop the highest-priority pending message (the agent loop's 50ms
        poll, pyDCOP agents.py:785-795)."""
        try:
            prio, _, t, sender, dest, msg = self._queue.get(timeout=timeout)
        except queue.Empty:
            return None
        self._consumed += 1  # single consumer: the owning agent thread
        if metrics_registry.enabled:
            _m_latency.observe(
                time.perf_counter() - t, agent=self.agent_name
            )
        if tracer.enabled:
            ctx = getattr(msg, "_trace_ctx", None)
            if ctx is not None:
                # the paired delivery span on the RECEIVING agent's track:
                # next_msg runs on the owning agent thread, so the flow
                # FINISH lands where the message is actually consumed.
                # latency_ms spans send→consume on the wall clock (the
                # only clock that crosses processes).
                tracer.flow_point(
                    "f", "comms.delivery", ctx[1], src=sender,
                    dest=dest, type=msg.type, agent=self.agent_name,
                    latency_ms=round((time.time() - ctx[2]) * 1000.0, 3),
                )
        return sender, dest, msg, t

    def computation(self, name: str) -> Any:
        try:
            return self._local_computations[name]
        except KeyError:
            raise UnknownComputation(name) from None

    def shutdown(self) -> None:
        self.comm.shutdown()
