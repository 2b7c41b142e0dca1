"""Distributed tracing: W3C-traceparent spans through every layer.

Counterpart of ``dragonfly2_tpu/common/tracing.py`` (reference
OpenTelemetry bootstrap, ``cmd/dependency/dependency.go:95-137``), on the
standard library: contextvar-propagated spans, the W3C ``traceparent``
header on the wire, a JSONL file exporter for post-mortems and an
OTLP/HTTP-JSON exporter (``urllib``) for live collectors.

A daemon's ``peertask`` span is the root of its download's trace; the
traceparent rides the RPC frames' metadata to the scheduler
(``sched.register``, ``sched.offer``) and the piece requests' HTTP header
to the parent's upload server (``upload.serve``), so one trace id follows
a pull from register to ``hbm.ingest``.

Usage:
    configure(service="dfdaemon", jsonl_path=".../traces.jsonl")
    with span("piece.download", task_id=tid) as sp:
        headers["traceparent"] = traceparent()
    # server side:
    with span("upload.serve", parent=from_traceparent(hdr)):
        ...

Off by default, and then free: ``span`` yields a shared no-op span and
sets no context, so ``traceparent()`` stays empty.
"""

from __future__ import annotations

import atexit
import contextlib
import contextvars
import json
import logging
import os
import queue
import secrets
import threading
import time
from dataclasses import dataclass, field

log = logging.getLogger("df.tracing")

_current: contextvars.ContextVar["SpanContext | None"] = \
    contextvars.ContextVar("df_span", default=None)


@dataclass
class SpanContext:
    trace_id: str                  # 32 hex chars
    span_id: str                   # 16 hex chars
    sampled: bool = True


@dataclass
class Span:
    name: str
    ctx: SpanContext
    parent_span_id: str = ""
    start_ns: int = 0
    end_ns: int = 0
    attributes: dict = field(default_factory=dict)
    status: str = "ok"

    def set(self, **attrs) -> None:
        self.attributes.update(attrs)

    def error(self, message: str) -> None:
        self.status = "error"
        self.attributes["error.message"] = message


class Tracer:
    """Process-wide tracer: sampling + bounded buffer + exporters."""

    MAX_BUFFER = 8192

    def __init__(self) -> None:
        self.service = "dragonfly2-tpu"
        self.sample_ratio = 1.0
        self.enabled = False
        self._jsonl_path = ""
        self._jsonl_file = None
        self._otlp_endpoint = ""
        self._lock = threading.Lock()
        self._buffer: list[Span] = []
        self._last_flush = time.monotonic()   # monotonic: NTP steps must
        # not suppress (or force) the age-based flush
        self._atexit_registered = False
        self._export_q: "queue.Queue[list[Span] | None]" = queue.Queue(64)
        self._exporter: threading.Thread | None = None
        self._flusher: threading.Thread | None = None

    def configure(self, *, service: str = "", jsonl_path: str = "",
                  otlp_endpoint: str = "",
                  sample_ratio: float = 1.0) -> None:
        with self._lock:
            if service:
                self.service = service
            self.sample_ratio = sample_ratio
            self._otlp_endpoint = otlp_endpoint
            if jsonl_path and jsonl_path != self._jsonl_path:
                os.makedirs(os.path.dirname(jsonl_path) or ".",
                            exist_ok=True)
                if self._jsonl_file:
                    self._jsonl_file.close()
                self._jsonl_file = open(jsonl_path, "a", encoding="utf-8")
                self._jsonl_path = jsonl_path
            self.enabled = bool(self._jsonl_file or self._otlp_endpoint)
            if self.enabled and not self._atexit_registered:
                # short-lived runs (the post-mortem case this module exists
                # for) rarely hit the 64-span flush threshold
                atexit.register(self._shutdown_flush)
                self._atexit_registered = True
            if self.enabled and self._flusher is None:
                # timer-driven flush: the finish()-time age check alone
                # cannot drain a burst followed by silence — a live tail of
                # the trace file would show nothing until the next span
                self._flusher = threading.Thread(
                    target=self._flush_loop, name="df-trace-flush",
                    daemon=True)
                self._flusher.start()

    def _sampled(self) -> bool:
        if self.sample_ratio >= 1.0:
            return True
        return secrets.randbelow(10_000) < self.sample_ratio * 10_000

    def start_span(self, name: str, *,
                   parent: SpanContext | None = None, **attrs) -> Span:
        if parent is None:
            parent = _current.get()
        if parent is not None:
            ctx = SpanContext(parent.trace_id, secrets.token_hex(8),
                              parent.sampled)
            parent_id = parent.span_id
        else:
            ctx = SpanContext(secrets.token_hex(16), secrets.token_hex(8),
                              self._sampled())
            parent_id = ""
        return Span(name=name, ctx=ctx, parent_span_id=parent_id,
                    start_ns=time.time_ns(), attributes=dict(attrs))

    def finish(self, sp: Span) -> None:
        sp.end_ns = time.time_ns()
        if not self.enabled or not sp.ctx.sampled:
            return
        with self._lock:
            if len(self._buffer) >= self.MAX_BUFFER:
                self._buffer.pop(0)        # bounded: drop-oldest
            self._buffer.append(sp)
            # size, notable-span, or AGE: a long-lived daemon emitting a
            # trickle must not hold its spans in memory until shutdown
            # (a live `tail -f traces.jsonl` is the point of the file)
            if (len(self._buffer) >= 64
                    or sp.end_ns - sp.start_ns > 1_000_000_000
                    or time.monotonic() - self._last_flush > 5.0):
                self._flush_locked()

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_loop(self) -> None:
        while True:
            time.sleep(5.0)
            if self._buffer:
                self.flush()

    def _shutdown_flush(self) -> None:
        """Final flush + export drain; the atexit target AND the explicit
        launcher-shutdown path (module-level ``shutdown``) — one logic
        home so the two exits cannot drift."""
        self.flush()
        if self._otlp_endpoint:
            self.drain_exports()

    def _flush_locked(self) -> None:
        batch, self._buffer = self._buffer, []
        self._last_flush = time.monotonic()
        if not batch:
            return
        if self._jsonl_file is not None:
            for sp in batch:
                self._jsonl_file.write(json.dumps({
                    "name": sp.name, "trace_id": sp.ctx.trace_id,
                    "span_id": sp.ctx.span_id,
                    "parent_span_id": sp.parent_span_id,
                    "start_ns": sp.start_ns, "end_ns": sp.end_ns,
                    "duration_ms": (sp.end_ns - sp.start_ns) / 1e6,
                    "status": sp.status, "service": self.service,
                    "attributes": sp.attributes}) + "\n")
            self._jsonl_file.flush()
        if self._otlp_endpoint:
            # single long-lived exporter thread draining a queue: a thread
            # per batch piles up against a slow collector, and a daemon
            # thread spawned from the atexit flush dies before sending
            self._ensure_exporter()
            try:
                self._export_q.put_nowait(batch)
            except queue.Full:
                log.debug("otlp export queue full; batch dropped")

    def _ensure_exporter(self) -> None:
        if self._exporter is None or not self._exporter.is_alive():
            self._exporter = threading.Thread(target=self._export_loop,
                                              name="otlp-export",
                                              daemon=True)
            self._exporter.start()

    def _export_loop(self) -> None:
        while True:
            batch = self._export_q.get()
            if batch is None:
                return
            self._export_otlp(batch)

    def drain_exports(self, timeout: float = 5.0) -> None:
        """Best-effort: wait for queued OTLP batches to leave (shutdown)."""
        deadline = time.monotonic() + timeout
        while not self._export_q.empty() and time.monotonic() < deadline:
            time.sleep(0.05)

    def _export_otlp(self, batch: list[Span]) -> None:
        """OTLP/HTTP JSON — the lingua franca every collector ingests."""
        import urllib.request
        payload = {"resourceSpans": [{
            "resource": {"attributes": [
                {"key": "service.name",
                 "value": {"stringValue": self.service}}]},
            "scopeSpans": [{"scope": {"name": "dragonfly2-tpu"},
                            "spans": [self._otlp_span(sp)
                                      for sp in batch]}]}]}
        req = urllib.request.Request(
            self._otlp_endpoint.rstrip("/") + "/v1/traces",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=10).read()
        except Exception as exc:  # noqa: BLE001 - collector may be away
            log.debug("otlp export failed: %s", exc)

    @staticmethod
    def _otlp_span(sp: Span) -> dict:
        return {
            "traceId": sp.ctx.trace_id, "spanId": sp.ctx.span_id,
            "parentSpanId": sp.parent_span_id, "name": sp.name,
            "startTimeUnixNano": str(sp.start_ns),
            "endTimeUnixNano": str(sp.end_ns),
            "kind": 1,
            "status": {"code": 2 if sp.status == "error" else 1},
            "attributes": [
                {"key": k, "value": {"stringValue": str(v)}}
                for k, v in sp.attributes.items()]}


TRACER = Tracer()
configure = TRACER.configure


def shutdown() -> None:
    """Launcher tail: flush the span buffer and give queued OTLP batches a
    bounded window to leave, deterministically BEFORE the launcher's own
    process-exit path (the atexit registration covers interpreter exit,
    but only once configure() ran; launchers call this unconditionally)."""
    TRACER._shutdown_flush()


_NOOP = Span(name="noop", ctx=SpanContext("0" * 32, "0" * 16,
                                          sampled=False))


@contextlib.contextmanager
def span(name: str, *, parent: SpanContext | None = None, **attrs):
    """Context manager: a span that is `current` inside the block (child
    spans and traceparent() pick it up via contextvars — async-safe).

    Fully free when tracing is disabled (the default): no ids are
    generated, no context is set, traceparent() stays empty — a v5p
    fan-out pushes thousands of pieces/second through this path."""
    if not TRACER.enabled and parent is None and _current.get() is None:
        yield _NOOP
        return
    sp = TRACER.start_span(name, parent=parent, **attrs)
    token = _current.set(sp.ctx)
    try:
        yield sp
    except BaseException as exc:
        sp.error(f"{type(exc).__name__}: {exc}")
        raise
    finally:
        _current.reset(token)
        TRACER.finish(sp)


def current() -> SpanContext | None:
    return _current.get()


def traceparent() -> str:
    """W3C traceparent header for the current span ('' when none)."""
    ctx = _current.get()
    if ctx is None:
        return ""
    flags = "01" if ctx.sampled else "00"
    return f"00-{ctx.trace_id}-{ctx.span_id}-{flags}"


def from_traceparent(header: str) -> SpanContext | None:
    """Parse a W3C traceparent header; None when absent/malformed."""
    if not header:
        return None
    parts = header.split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    try:
        int(parts[1], 16), int(parts[2], 16)
    except ValueError:
        return None
    try:
        flags = int(parts[3], 16)
    except ValueError:
        return None
    return SpanContext(parts[1], parts[2], sampled=bool(flags & 1))
