"""Distributed tracing — Dapper-style
sampled request tracing across the fleet (Sigelman et al. 2010,
PAPERS.md).

One ``Tracer`` per ``Observability`` bundle.  Head-based sampling: the
FIRST hop of a request (RESP ingress or the direct API) rolls the dice
once against ``sample_rate``; every downstream hop — reactor tick,
vectorizer run, coalescer segment, device launch, journal fsync fence,
and any cluster leg the request fans out to — inherits that decision.
Cross-process propagation rides an ``RTPU.TRACE <trace_id> <span_id>``
wire prelude (serve/resp.py): the cluster client / migration pump sends
it ahead of the traced command; a plain server errors on the unknown
command (harmless — the traced command still executes), a telemetry-
aware door consumes it like ASKING's one-shot flag.

Identifiers follow Dapper/W3C shape: 128-bit trace id, 64-bit span id,
parent span id; spans carry a wall-clock start, a duration, and a small
attr dict.  Finished spans land in a HARD-BOUNDED per-process ring
(``max_spans``) — tracing can never become a memory leak, only a
recency window.

Cost discipline (the chaos-module pattern): ``trace.ENABLED`` is a
module-level flag that is False while every live tracer's sample rate
is 0.  Every hot-path hook is guarded by ``if trace.ENABLED:`` so the
sampling-off cost is one attribute read + branch per site
(tests/test_observability.py bounds it at ≤5% on the submit path).

A fused launch serving ops from several traced requests records its
launch span into EVERY parent trace, each copy carrying the total
parent-link count (``links``) — the cross-connection batch-fusion
economics stay visible per trace.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
import weakref
from collections import deque
from typing import Optional

# Module guard (the chaos.ENABLED discipline): True iff ANY live tracer
# has a nonzero sample rate OR any trace scope is currently active in
# this process.  The second arm matters on fleet members whose OWN
# sampling is off: a remotely-propagated (RTPU.TRACE) span is forced —
# head-based sampling — and the coalescer hooks must still link its
# launches while its scope is live.  Hot-path hooks check this ONE
# module attribute before touching thread-locals or tracer state.
ENABLED = False

_tracers: "weakref.WeakSet" = weakref.WeakSet()
_guard_lock = threading.Lock()
_active_scopes = 0  # outermost live _Scope count (guarded)

_tls = threading.local()


def _recompute_enabled_locked() -> None:
    global ENABLED
    ENABLED = _active_scopes > 0 or any(
        t.sample_rate > 0.0 for t in _tracers
    )


def _recompute_enabled() -> None:
    with _guard_lock:
        _recompute_enabled_locked()


def current():
    """The ambient trace context(s) of this thread: None, one
    :class:`TraceContext`, or a tuple of them (a fused run executing on
    behalf of several traced requests)."""
    return getattr(_tls, "ctx", None)


class _Scope:
    """Context manager that installs ``ctx`` as the thread's ambient
    trace context for its body (restores the previous one on exit, so
    scopes nest).  An OUTERMOST scope also arms the module guard: a
    forced remote span must link its launches even on a node whose own
    sampling is off (the guard-lock round trip is paid only by traced
    commands, never by the off path)."""

    __slots__ = ("_ctx", "_prev", "_armed")

    def __init__(self, ctx):
        self._ctx = ctx
        self._prev = None
        self._armed = False

    def __enter__(self):
        self._prev = getattr(_tls, "ctx", None)
        _tls.ctx = self._ctx
        if self._ctx is not None and self._prev is None:
            global _active_scopes
            self._armed = True
            with _guard_lock:
                _active_scopes += 1
                _recompute_enabled_locked()
        return self._ctx

    def __exit__(self, *exc):
        _tls.ctx = self._prev
        if self._armed:
            global _active_scopes
            self._armed = False
            with _guard_lock:
                _active_scopes -= 1
                _recompute_enabled_locked()
        return False


def scope(ctx) -> _Scope:
    """``with trace.scope(span.ctx()): ...`` — anything that links the
    ambient context inside (coalescer submits, the fsync fence) joins
    the span's trace.  Accepts a single context or a tuple (multi-parent
    fused runs)."""
    return _Scope(ctx)


class TraceContext:
    """The propagatable identity of one live span: enough to parent a
    child span (locally or across the wire) and to reach the tracer
    that must record it."""

    __slots__ = ("tracer", "trace_id", "span_id")

    def __init__(self, tracer: "Tracer", trace_id: str, span_id: str):
        self.tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id

    def wire_args(self) -> list:
        """argv tail for the RTPU.TRACE prelude."""
        return [self.trace_id.encode(), self.span_id.encode()]


class TraceSpan:
    """One in-flight span.  ``end()`` records it into the tracer's ring;
    ``abandon()`` discards it (merged-away work whose ops ride another
    span).  rtpulint rule RT011 statically checks that every begin site
    reaches one of the two on all paths."""

    __slots__ = ("tracer", "trace_id", "span_id", "parent_id", "name",
                 "ts", "_t0", "attrs", "_done")

    def __init__(self, tracer, trace_id, span_id, parent_id, name):
        self.tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.ts = time.time()
        self._t0 = time.perf_counter()
        self.attrs: dict = {}
        self._done = False

    def ctx(self) -> TraceContext:
        return TraceContext(self.tracer, self.trace_id, self.span_id)

    def annotate(self, key: str, value) -> None:
        self.attrs[key] = value

    def end(self, error: bool = False) -> None:
        if self._done:
            return
        self._done = True
        dur_us = int((time.perf_counter() - self._t0) * 1e6)
        self.tracer._record({
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "ts": round(self.ts, 6),
            "dur_us": dur_us,
            "error": bool(error),
            "attrs": self.attrs,
        })

    def abandon(self) -> None:
        self._done = True


def _new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


class Tracer:
    """Per-process span collector with a live head-sampling knob and a
    hard ring bound.  ``sampled_counter`` / ``span_counter`` are
    optional registry families (the obs bundle passes its own) so trace
    volume is visible on /metrics."""

    def __init__(self, sample_rate: float = 0.0, max_spans: int = 2048,
                 sampled_counter=None, span_counter=None):
        self.sample_rate = 0.0
        self.max_spans = max(16, int(max_spans))
        self._spans: deque = deque(maxlen=self.max_spans)
        self._lock = threading.Lock()
        self._rng = random.Random()
        self.sampled = 0  # lifetime head-sampling hits
        self.evicted = 0  # spans pushed out of the ring
        self._sampled_counter = sampled_counter
        self._span_counter = span_counter
        _tracers.add(self)
        # Recompute the module guard when this tracer is GARBAGE
        # COLLECTED while armed: without this, dropping an armed tracer
        # (its WeakSet entry just vanishes) would leave ENABLED stuck
        # True and every hook paying the traced path forever.
        weakref.finalize(self, _recompute_enabled)
        if sample_rate:
            self.set_sample_rate(sample_rate)

    # -- sampling ----------------------------------------------------------

    def set_sample_rate(self, rate: float) -> None:
        rate = float(rate)
        if not 0.0 <= rate <= 1.0:
            raise ValueError(
                f"trace_sample_rate must be in [0, 1], got {rate!r}"
            )
        self.sample_rate = rate
        _recompute_enabled()

    def maybe_start(self, name: str,
                    parent: Optional[TraceContext] = None
                    ) -> Optional[TraceSpan]:
        """Head-sample a ROOT span (the request's first hop).  Returns
        None when the dice miss or sampling is off — callers guard with
        ``if trace.ENABLED`` so this is never reached on the off path."""
        rate = self.sample_rate
        if rate <= 0.0 or self._rng.random() >= rate:
            return None
        with self._lock:
            # Guarded: a bare += from N connection threads is a lossy
            # read-modify-write.
            self.sampled += 1
        if self._sampled_counter is not None:
            self._sampled_counter.inc()
        tid = parent.trace_id if parent is not None else _new_trace_id()
        pid = parent.span_id if parent is not None else ""
        return TraceSpan(self, tid, _new_span_id(), pid, name)

    def start(self, name: str, trace_id: str,
              parent_id: str = "") -> TraceSpan:
        """A FORCED span continuing an already-sampled trace (a remote
        hop's RTPU.TRACE prelude, or a local child): head-based sampling
        means the head's decision binds every downstream hop."""
        return TraceSpan(self, trace_id, _new_span_id(), parent_id, name)

    def start_child(self, parent: TraceSpan, name: str) -> TraceSpan:
        return self.start(name, parent.trace_id, parent.span_id)

    def span_scope(self, name: str):
        """Context manager for the direct API (client.trace(name)):
        mints a head-sampled root span and installs it as the ambient
        context, so every engine submit inside links to it.  Yields the
        span (or None when the dice missed)."""
        return _SpanScope(self, name)

    # -- recording ---------------------------------------------------------

    def _record(self, span: dict) -> None:
        with self._lock:
            if len(self._spans) >= self._spans.maxlen:
                self.evicted += 1
            self._spans.append(span)
        if self._span_counter is not None:
            self._span_counter.inc()

    def record_span(self, ctx: TraceContext, name: str, ts: float,
                    dur_s: float, attrs: Optional[dict] = None,
                    error: bool = False) -> None:
        """Record an already-timed span under ``ctx`` (the coalescer's
        launch spans arrive this way: timing came from the OpSpan, the
        parent from the submit-time link)."""
        self._record({
            "trace_id": ctx.trace_id,
            "span_id": _new_span_id(),
            "parent_id": ctx.span_id,
            "name": name,
            "ts": round(ts, 6),
            "dur_us": int(dur_s * 1e6),
            "error": bool(error),
            "attrs": dict(attrs or {}),
        })

    # -- export ------------------------------------------------------------

    def spans(self) -> list:
        with self._lock:
            return list(self._spans)

    def traces(self, trace_id: Optional[str] = None) -> dict:
        """{trace_id: [span dicts in arrival order]} — the ring grouped
        by trace; optionally filtered to one trace id."""
        out: dict = {}
        for s in self.spans():
            if trace_id is not None and s["trace_id"] != trace_id:
                continue
            out.setdefault(s["trace_id"], []).append(s)
        return out

    def traces_json(self, trace_id: Optional[str] = None) -> list:
        """One JSON document per trace (newest last) — the TRACE GET
        wire format, chosen so cross-node merges are a list concat."""
        return [
            json.dumps({"trace_id": tid, "spans": spans},
                       separators=(",", ":"))
            for tid, spans in self.traces(trace_id).items()
        ]

    def stats(self) -> dict:
        with self._lock:
            n = len(self._spans)
            tids = len({s["trace_id"] for s in self._spans})
        return {
            "sample_rate": self.sample_rate,
            "spans": n,
            "traces": tids,
            "max_spans": self.max_spans,
            "sampled": self.sampled,
            "evicted": self.evicted,
        }

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()


class _SpanScope:
    __slots__ = ("_tracer", "_name", "_span", "_scope")

    def __init__(self, tracer: Tracer, name: str):
        self._tracer = tracer
        self._name = name
        self._span = None
        self._scope = None

    def __enter__(self):
        span = self._tracer.maybe_start(self._name) if ENABLED else None
        self._span = span
        if span is not None:
            self._scope = scope(span.ctx())
            self._scope.__enter__()
        return span

    def __exit__(self, exc_type, exc, tb):
        if self._scope is not None:
            self._scope.__exit__(exc_type, exc, tb)
        if self._span is not None:
            self._span.end(error=exc_type is not None)
        return False


__all__ = [
    "ENABLED",
    "TraceContext",
    "TraceSpan",
    "Tracer",
    "current",
    "scope",
]
