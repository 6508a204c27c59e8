"""Dapper-style span tracer exporting Chrome trace-event JSON.

The port's own copy of ``pydcop_tpu/telemetry/tracing.py``, unchanged:
durability records its checkpoint span through ``tracer``.

Answers "where did the wall-clock go?" across the host control plane and the
compiled JAX path: spans (context manager or decorator) nest via a
thread-local stack and are exported as complete events (``"ph": "X"``) in
the Chrome trace-event format, loadable in Perfetto / ``chrome://tracing``,
or streamed as JSONL.  Instant markers (``"ph": "i"``) record point events
(a message send, an agent stop).

Disabled by default like ``event_bus``: ``span()`` returns a shared no-op
object after one flag check, and hot call sites additionally guard with
``if tracer.enabled`` so the disabled path allocates nothing (the
acceptance bar: one attribute read per instrumented call — see
docs/observability.md for the measured numbers).

Timestamps are microseconds relative to the tracer's epoch (perf_counter at
construction/reset), which keeps them monotone and Perfetto-friendly; the
absolute wall-clock epoch rides in the exported file's ``metadata``.

graftwatch adds cross-agent causality: *flow events* (Chrome phases
``"s"``/``"t"``/``"f"``) tie a message's send, transport delivery and
consume points together by a process-unique ``flow_id``, so Perfetto draws
arrows between agent tracks.  Each flow event is anchored to a micro-slice
(a tiny ``"X"`` span at the same timestamp — Chrome binds flows to the
slice enclosing them), emitted by ``flow_point``.

Stdlib-only, same constraint as ``telemetry.metrics``.
"""

from __future__ import annotations

import functools
import itertools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = ["Span", "Tracer", "tracer", "traced"]


class _NoopSpan:
    """Returned by ``span()`` when tracing is off — a process-wide shared
    instance, so the disabled path performs no allocation."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **args: Any) -> None:
        pass


_NOOP_SPAN = _NoopSpan()


class Span:
    """One live span: records a complete ("X") trace event on exit."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_parent")

    def __init__(
        self, tracer: "Tracer", name: str, cat: str, args: Dict[str, Any]
    ):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0.0
        self._parent: Optional[str] = None

    def set(self, **args: Any) -> None:
        """Attach result arguments discovered mid-span (byte counts,
        cycle totals...)."""
        self.args.update(args)

    def __enter__(self) -> "Span":
        stack = self._tracer._stack()
        self._parent = stack[-1] if stack else None
        stack.append(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> bool:
        t1 = time.perf_counter()
        tr = self._tracer
        stack = tr._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        args = self.args
        if self._parent is not None:
            args = dict(args)
            args["parent"] = self._parent
        tr._record(
            {
                "name": self.name,
                "cat": self.cat,
                "ph": "X",
                "ts": (self._t0 - tr._epoch) * 1e6,
                "dur": (t1 - self._t0) * 1e6,
                "pid": tr._pid,
                "tid": threading.get_ident(),
                "args": args,
            }
        )
        return False


class Tracer:
    """Process-wide span recorder with Chrome-trace and JSONL export."""

    def __init__(self, enabled: bool = False) -> None:
        self.enabled = enabled
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._local = threading.local()
        self._epoch = time.perf_counter()
        self._epoch_wall = time.time()
        self._pid = os.getpid()
        #: run identity stamped into export metadata and message trace
        #: contexts; regenerated on reset so stitched files can be told
        #: apart across runs in one interpreter
        self.trace_id = os.urandom(8).hex()
        #: human name for this process's track in stitched timelines
        #: (agent name in process-mode children, "orchestrator" in the
        #: parent); exported as process_name metadata
        self.service: Optional[str] = None
        # flow ids must be unique ACROSS processes of one run: the pid
        # rides in the high bits, a lock-free counter in the low ones
        self._flow_counter = itertools.count(1)
        # optional live JSONL sink: every recorded event is also appended
        # to this stream the moment it completes (crash-safe traces)
        self._stream = None

    def __setattr__(self, name: str, value: Any) -> None:
        # re-enabling after a disable must not inherit a stale epoch pair:
        # perf_counter and the wall clock drift apart over a long-lived
        # interpreter (NTP steps), and a stitched multi-process timeline
        # aligns files by epoch_unix_s — so a fresh (event-less) enable
        # re-captures both clocks atomically.  Plain-attribute READS of
        # ``enabled`` stay a single dict lookup (the hot-path flag check).
        if name == "enabled" and value and not getattr(self, "enabled", False):
            # ``lock`` IS self._lock (fetched via getattr because __init__
            # assigns ``enabled`` before the lock exists) — the per-name
            # alias analysis cannot see that, hence the disables
            lock = getattr(self, "_lock", None)
            if lock is not None:
                with lock:
                    if not self._events:  # graftlint: disable=lock-unguarded-read
                        self._epoch = time.perf_counter()  # graftlint: disable=lock-unguarded-write
                        self._epoch_wall = time.time()  # graftlint: disable=lock-unguarded-write
        object.__setattr__(self, name, value)

    # -- recording -----------------------------------------------------

    def _stack(self) -> List[str]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _record(self, event: Dict[str, Any]) -> None:
        # serialize OUTSIDE the lock (the expensive part — holding the
        # lock across json.dumps would convoy every recording thread);
        # the racy _stream read is re-checked under the lock
        line = (
            json.dumps(event) + "\n"
            if self._stream is not None  # graftlint: disable=lock-unguarded-read
            else None
        )
        with self._lock:
            self._events.append(event)
            if self._stream is not None:
                if line is None:
                    line = json.dumps(event) + "\n"
                self._stream.write(line)
                # flush per event: the stream's whole point is that the
                # events explaining a crash are on disk when it happens
                self._stream.flush()

    def span(self, name: str, cat: str = "host", **args: Any):
        """Context manager timing a region.  When disabled, returns a shared
        no-op after a single flag check — but prefer guarding the whole call
        with ``if tracer.enabled`` on hot paths, since keyword arguments are
        packed before the check can run."""
        if not self.enabled:
            return _NOOP_SPAN
        return Span(self, name, cat, args)

    def complete(
        self,
        name: str,
        t_start: float,
        duration: float,
        cat: str = "host",
        **args: Any,
    ) -> None:
        """Record a finished span from explicit ``perf_counter`` timings —
        for call sites (solver windows, readbacks) that measure first and
        decide to record after, without holding a context manager open.
        Does not participate in the thread-local nesting stack; Perfetto
        still nests these by time on the recording thread."""
        if not self.enabled:
            return
        # benign racy epoch read (also in instant/flow_point below): the
        # epoch pair only changes while the trace is EMPTY (reset or a
        # fresh enable), so no recorded event can observe a torn pair;
        # taking the events lock here would convoy recording threads
        self._record(
            {
                "name": name,
                "cat": cat,
                "ph": "X",
                "ts": (t_start - self._epoch) * 1e6,  # graftlint: disable=lock-unguarded-read
                "dur": duration * 1e6,
                "pid": self._pid,
                "tid": threading.get_ident(),
                "args": args,
            }
        )

    def instant(self, name: str, cat: str = "host", **args: Any) -> None:
        """Record a point event (Chrome phase "i", thread scope)."""
        if not self.enabled:
            return
        self._record(
            {
                "name": name,
                "cat": cat,
                "ph": "i",
                "s": "t",
                "ts": (time.perf_counter() - self._epoch) * 1e6,  # graftlint: disable=lock-unguarded-read
                "pid": self._pid,
                "tid": threading.get_ident(),
                "args": args,
            }
        )

    def current_span(self) -> Optional[str]:
        stack = self._stack()
        return stack[-1] if stack else None

    # -- flows (cross-agent message causality) -------------------------

    def new_flow_id(self) -> int:
        """Process-unique flow id: pid in the high bits, a lock-free
        counter in the low 32 — unique across the processes of one
        multi-process run, so stitched traces never alias two flows."""
        return (self._pid << 32) | (next(self._flow_counter) & 0xFFFFFFFF)

    def flow_point(
        self,
        ph: str,
        slice_name: str,
        flow_id: int,
        cat: str = "comms",
        flow_name: str = "comms.msg",
        **args: Any,
    ) -> None:
        """One point of a message's journey: a micro-slice (``"X"``) named
        ``slice_name`` plus a flow event (``ph`` in ``"s"``/``"t"``/``"f"``)
        at the same timestamp — Chrome binds a flow event to the slice
        enclosing it, so the pair is what lets Perfetto draw the arrow.
        The slice's duration is the recording work itself (floored at 1 us
        so the flow timestamp always falls inside it).  All events of one
        flow share ``flow_name``; finish events bind to their enclosing
        slice (``"bp": "e"``)."""
        if not self.enabled:
            return
        t0 = time.perf_counter()
        tid = threading.get_ident()
        ts = (t0 - self._epoch) * 1e6  # graftlint: disable=lock-unguarded-read
        flow: Dict[str, Any] = {
            "name": flow_name,
            "cat": cat,
            "ph": ph,
            "id": flow_id,
            "ts": ts,
            "pid": self._pid,
            "tid": tid,
        }
        if ph == "f":
            flow["bp"] = "e"
        dur = max((time.perf_counter() - t0) * 1e6, 1.0)
        self._record(
            {
                "name": slice_name,
                "cat": cat,
                "ph": "X",
                "ts": ts,
                "dur": dur,
                "pid": self._pid,
                "tid": tid,
                "args": args,
            }
        )
        self._record(flow)

    # -- lifecycle / export --------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def reset(self) -> None:
        # the epoch pair is re-captured under the lock, atomically with
        # the clear: a concurrently recording thread must never compute a
        # ts from the new epoch while the wall anchor is still the old one
        # (a stitched timeline would inherit the stale epoch)
        with self._lock:
            self._events.clear()
            self._epoch = time.perf_counter()
            self._epoch_wall = time.time()
        self.trace_id = os.urandom(8).hex()

    def stream_to(self, path: Optional[str]) -> None:
        """Start (or with ``None`` stop) appending each completed event to a
        JSONL file as it is recorded."""
        with self._lock:
            if self._stream is not None:
                self._stream.close()
                self._stream = None
            if path is not None:
                self._stream = open(path, "a", encoding="utf-8")

    def _thread_metadata(self) -> List[Dict[str, Any]]:
        out = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": self._pid,
                "args": {
                    "name": self.service or f"pid{self._pid}",
                },
            }
        ]
        for t in threading.enumerate():
            if t.ident is None:
                continue
            out.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": self._pid,
                    "tid": t.ident,
                    "args": {"name": t.name},
                }
            )
        return out

    def chrome_trace(self) -> Dict[str, Any]:
        """The full trace as a Chrome trace-event JSON object."""
        return {
            "traceEvents": self._thread_metadata() + self.events(),
            "displayTimeUnit": "ms",
            "metadata": {
                "epoch_unix_s": self._epoch_wall,  # graftlint: disable=lock-unguarded-read
                "exporter": "pydcop_tpu.telemetry",
                "trace_id": self.trace_id,
                "service": self.service or f"pid{self._pid}",
                "pid": self._pid,
            },
        }

    def export_chrome(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.chrome_trace(), f)
            f.write("\n")

    def export_jsonl(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for e in self.events():
                f.write(json.dumps(e) + "\n")


#: Process-wide singleton, mirroring ``infrastructure.events.event_bus``.
tracer = Tracer()


def traced(
    name: Optional[str] = None, cat: str = "host"
) -> Callable[[Callable], Callable]:
    """Decorator: time every call of the wrapped function as a span.

    >>> @traced("demo.add")
    ... def add(a, b):
    ...     return a + b
    >>> add(1, 2)
    3
    """

    def deco(fn: Callable) -> Callable:
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a: Any, **kw: Any):
            if not tracer.enabled:
                return fn(*a, **kw)
            with tracer.span(label, cat):
                return fn(*a, **kw)

        return wrapper

    return deco
