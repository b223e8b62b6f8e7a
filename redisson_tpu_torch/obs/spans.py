"""Op-lifecycle spans.

One span per coalesced *launch* (segment), not per op — span cost
amortizes over the whole batch, so the producer-side submit path pays
nothing.  Phases are stamped as consecutive timestamps:

    submit ──(coalesce_wait)── stage start ──(host_stage)──
    staged ──(device_dispatch)── dispatched ──(d2h_fetch)── done

so the phase durations partition the end-to-end latency EXACTLY
(tests/test_observability.py asserts sum(phases) == end_to_end).
``host_stage`` covers the host-side pad/concat of the flush block,
which runs BEFORE the launch-slot wait so it overlaps in-flight device
execution (executor/coalescer.py _stage); ``device_dispatch`` therefore
includes any launch-slot wait plus the enqueue itself.  The
device-dispatch phase additionally runs under a
``torch.profiler.record_function`` region (see executor/coalescer.py), so a
captured device trace correlates with these host spans by name.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

PHASES = ("coalesce_wait", "host_stage", "device_dispatch", "d2h_fetch")


class OpSpan:
    __slots__ = ("op", "nops", "t0", "stamps", "error", "_rec", "links",
                 "tenants")

    def __init__(self, op: str, nops: int, recorder: "SpanRecorder"):
        self.op = op
        self.nops = nops
        self.t0 = time.monotonic()
        self.stamps: list[tuple[str, float]] = []
        self.error = False
        self._rec = recorder
        # Distributed-trace parent links: TraceContexts of
        # sampled requests whose ops ride this launch.  A fused launch
        # carries one link per traced parent; the finish hook records
        # the launch span into EVERY linked trace.  None (not []) on the
        # untraced path — the common case allocates nothing.
        self.links = None
        # Load-attribution composition: [(tenant, nops)]
        # stashed by the coalescer's completer just before finish, so
        # the recorder can split this launch's device time per tenant.
        # None when no loadmap is armed — again allocates nothing.
        self.tenants = None

    def stamp(self, phase: str) -> None:
        """End the current phase NOW (phases are consecutive intervals:
        each stamp's duration runs from the previous stamp — or t0)."""
        self.stamps.append((phase, time.monotonic()))

    def add_ops(self, nops: int) -> None:
        self.nops += nops

    def link(self, ctx) -> None:
        """Attach a sampled request's TraceContext (or a tuple of them)
        as a parent of this launch.  DEDUPED by (trace, span) identity:
        one traced request whose K submits coalesce into this launch
        links once, not K times — duplicate links would flood the span
        ring with K identical launch spans per trace."""
        if self.links is None:
            self.links = []
        if isinstance(ctx, tuple):
            for c in ctx:
                self.link(c)
            return
        for ex in self.links:
            if ex.span_id == ctx.span_id and ex.trace_id == ctx.trace_id:
                return
        self.links.append(ctx)

    def phases(self) -> dict:
        out = {}
        prev = self.t0
        for name, t in self.stamps:
            out[name] = out.get(name, 0.0) + (t - prev)
            prev = t
        return out

    def end_to_end(self) -> float:
        return (self.stamps[-1][1] - self.t0) if self.stamps else 0.0

    def finish(self, error: bool = False) -> None:
        if self._rec is None:  # abandoned or already finished: no-op
            return
        self.error = error
        self._rec._finish(self)

    def abandon(self, into: "OpSpan" = None) -> None:
        """Merged-away segment: its ops ride another span — record
        nothing.  ``into`` (the surviving head span) inherits any trace
        parent links, so a merged launch still reports to every sampled
        request it serves."""
        self._rec = None
        if into is not None and self.links:
            into.link(tuple(self.links))
            self.links = None


class SpanRecorder:
    """Feeds finished spans into the registry's phase histograms and keeps
    the last ``keep`` spans for inspection (client.get_metrics views and
    the span-sum sanity test)."""

    def __init__(self, registry, keep: int = 256, latency=None):
        self._registry = registry
        # Optional LatencyMonitor: launches whose end-to-end
        # time meets latency-monitor-threshold record a "slow-launch"
        # event.  One compare per finish when disarmed.
        self.latency = latency
        # Optional LoadMap: retiring launches attribute
        # their device-side time (dispatch + fetch phases) to the
        # tenant composition stashed on the span.  One None-check per
        # finish when disarmed.
        self.loadmap = None
        self._phase_hist = registry.histogram(
            "rtpu_op_phase_seconds",
            "per-launch lifecycle phase durations", ("op", "phase"),
        )
        self._total_hist = registry.histogram(
            "rtpu_op_seconds", "per-launch end-to-end latency", ("op",),
        )
        self._ops = registry.counter(
            "rtpu_ops", "ops completed, by op type", ("op",),
        )
        self._errors = registry.counter(
            "rtpu_op_errors", "launches failed, by op type", ("op",),
        )
        self._recent: deque[OpSpan] = deque(maxlen=keep)
        self._lock = threading.Lock()

    def start(self, op: str, nops: int = 0) -> OpSpan:
        return OpSpan(op, nops, self)

    def _finish(self, span: OpSpan) -> None:
        span._rec = None
        phases = span.phases()
        e2e = span.end_to_end()
        for phase, dur in phases.items():
            self._phase_hist.observe((span.op, phase), dur)
        self._total_hist.observe((span.op,), e2e)
        if span.error:
            self._errors.inc((span.op,))
        else:
            self._ops.inc((span.op,), max(1, span.nops))
        lat = self.latency
        if lat is not None and lat.threshold_ms > 0:
            lat.record("slow-launch", e2e * 1e3)
        lm = self.loadmap
        if lm is not None and span.tenants and not span.error:
            # Device-side share of the launch: the dispatch (launch
            # wait + enqueue) and d2h fetch phases — host-side
            # coalesce/stage time is not device time and would inflate
            # a billing signal.
            us = (phases.get("device_dispatch", 0.0)
                  + phases.get("d2h_fetch", 0.0)) * 1e6
            try:
                lm.attribute_launch(span.op, span.tenants, us)
            except Exception:
                pass  # attribution must not fail the completer
        if span.links:
            self._feed_traces(span, phases, e2e)
        with self._lock:
            self._recent.append(span)

    @staticmethod
    def _feed_traces(span: OpSpan, phases: dict, e2e: float) -> None:
        """Record this launch into every linked trace: one
        span per sampled parent, each carrying the full phase breakdown
        and the total parent-link count — a fused launch stays visible
        as fused from inside any single trace."""
        nlinks = len(span.links)
        attrs = {
            "nops": span.nops,
            "links": nlinks,
        }
        for name, dur in phases.items():
            attrs[name + "_us"] = int(dur * 1e6)
        ts = time.time() - e2e  # wall start ≈ now - span length
        for ctx in span.links:
            try:
                ctx.tracer.record_span(
                    ctx, "launch:" + span.op, ts, e2e, attrs,
                    error=span.error,
                )
            except Exception:
                pass  # a dying tracer must not fail the completer

    def recent(self, op: Optional[str] = None) -> list[OpSpan]:
        with self._lock:
            spans = list(self._recent)
        return spans if op is None else [s for s in spans if s.op == op]

    def reset(self) -> None:
        """Zero the span-derived histograms/counters and the recent
        ring — the PUBLIC lifecycle surface (benches reset after warmup
        so compile-era samples don't pollute the warm-path evidence
        view; counters reset WITH the histograms — a snapshot mixing
        all-time op counts with reset-window percentiles would misstate
        ops-per-launch)."""
        self._phase_hist.reset()
        self._total_hist.reset()
        self._ops.reset()
        self._errors.reset()
        with self._lock:
            self._recent.clear()
