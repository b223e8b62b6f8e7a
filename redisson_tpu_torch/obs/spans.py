"""Op-lifecycle spans, per-call phases, and the device's time per launch.

One span per coalesced *launch* (segment), not per op — span cost
amortizes over the whole batch.  Phases are stamped as consecutive
timestamps:

    submit ──(coalesce_wait)── stage start ──(host_stage)── staged
    ──(slot_wait)── slot taken ──(enqueue)── enqueued ──(d2h_fetch)── done

so the phase durations partition the end-to-end latency EXACTLY
(tests/test_observability.py asserts sum(phases) == end_to_end).
``host_stage`` covers the host-side concatenation of the flush block,
which runs BEFORE the launch-slot wait so it overlaps in-flight device
execution (executor/coalescer.py _stage); ``slot_wait`` is the wait for
a launch slot (the AIMD in-flight window); ``enqueue`` is the dispatch
call that queues the launch on the device; ``d2h_fetch`` runs from the
enqueue's end until the result is in host memory (the device's work,
the completer's queue and the copy home).  None of these is device
time: that is ``device_s``, below.

Three more records live here, all on the same monotonic host clock:

- ``CallRecorder``: three phases of every public data call of the
  objects (``encode``: codec to lane blocks; ``admit_wait``: the
  coalescer's backpressure loop; ``submit``: the rest up to the returned
  future), and the ``STAGE_PHASES`` of a path that has them (a count-min
  call's host ``hash``, the ``drain`` its sequential semantics waits on,
  the ``fetch`` of its estimates and its top-K ``offer``), in
  ``rtpu_call_phase_seconds``.  The open call is an ambient per-thread
  context, so the coalescer stamps the span of the segment a call
  creates with when that call began and when it was admitted, and a
  launch made with no segment (a direct dispatch) takes the stamps of
  the call that made it.
- ``LaunchTimer``: every outermost executor launch is bracketed by a
  pair of timing events on its stream (host stamps on the CPU), so its
  time holds its kernels and copies and the gaps between them in which
  the card waits for the host to issue the next; once
  the launch's result is home, ``end - start`` goes to
  ``rtpu_launch_device_seconds`` and the span's ``device_s``, and the
  idle gap between the stream's previous launch and this one is split,
  against this launch's host stamps, into the host phase that held it
  (``rtpu_device_idle_seconds{cause}``).
- ``profiling()``: whether a torch profiler is recording; the host-work
  ranges ``rtpu:encode``, ``rtpu:submit`` and ``rtpu:stage`` open only
  then, and no range is ever opened around a wait.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from collections import deque
from typing import Optional

from redisson_tpu_torch.obs.registry import bucket_index_us

PHASES = ("coalesce_wait", "host_stage", "slot_wait", "enqueue", "d2h_fetch")
CALL_PHASES = ("encode", "admit_wait", "submit")
# Phases a call observes only where its path has them, each carved out
# of what would otherwise be its submit phase.
STAGE_PHASES = ("hash", "drain", "fetch", "offer")
# What the device waited on in an idle gap before a launch, in the
# launch's own order: a coalesced launch's, then a direct launch's made
# inside a call (``hash``, ``drain``, ``submit``), then one with neither.
IDLE_CAUSES = ("caller", "encode", "hash", "drain", "submit", "admit_wait",
               "coalesce_wait", "host_stage", "slot_wait", "enqueue", "direct")

_tls = threading.local()
_INF = float("inf")
_NO_RANGE = contextlib.nullcontext()


def profiling() -> bool:
    """True while a torch profiler records (read without importing torch:
    a process that never loaded the profiler is not profiling)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


def host_range(name: str):
    """A ``record_function`` range named ``name`` while a torch profiler
    records; a context that does nothing otherwise."""
    if not profiling():
        return _NO_RANGE
    from torch.autograd.profiler import record_function

    return record_function(name)


def current_call():
    """The data call open on this thread, or None."""
    return getattr(_tls, "call", None)


def clock(wait: bool = False):
    """Now, where a data call is open on this thread, to pass to ``spent``
    when the stage ends; None otherwise.  ``wait``: the stage waits, so
    the call's ``rtpu:submit`` range closes until it ends."""
    call = getattr(_tls, "call", None)
    if call is None:
        return None
    if wait:
        call.pause()
    return time.monotonic()


def spent(phase: str, t0) -> None:
    """The open call spent ``[t0, now]`` in ``phase`` (one of
    ``STAGE_PHASES``); nothing where ``t0`` is None."""
    if t0 is None:
        return
    call = getattr(_tls, "call", None)
    if call is not None:
        call.spend(phase, t0)


def current_launch():
    """The span of the segment this thread is dispatching, or None."""
    return getattr(_tls, "launch", None)


def set_launch(span) -> None:
    _tls.launch = span


def current_timing():
    """The timed launch this thread's executor call is making, or None."""
    return getattr(_tls, "timing", None)


def set_timing(launch) -> None:
    _tls.timing = launch


class OpSpan:
    __slots__ = ("op", "nops", "t0", "stamps", "error", "_rec", "links",
                 "tenants", "first", "device_s")

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
        # stashed by the coalescer's completer before the result fetch,
        # so the launch timer can split this launch's device time per
        # tenant.  None when no loadmap is armed — again allocates nothing.
        self.tenants = None
        # The call that created this segment: (call start or None,
        # admission wait start or None, admitted or None).
        self.first = None
        # Event-timed device seconds of the launch, once it retired.
        self.device_s = None

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


# -- per-call phases ------------------------------------------------------------


class _Call:
    __slots__ = ("op", "t0", "t_enc", "admit_s", "rf", "stages", "marks")

    def __init__(self, op: str):
        self.op = op
        self.t0 = time.monotonic()
        self.t_enc = None
        self.admit_s = 0.0
        self.rf = None  # the open rtpu:submit range, while profiling
        self.stages = None  # {stage phase: seconds}, once one is spent
        self.marks = ()  # (stage phase, end) in the order they ended

    def spend(self, phase: str, t0: float) -> None:
        t = time.monotonic()
        if self.stages is None:
            self.stages = {}
            self.marks = []
        self.stages[phase] = self.stages.get(phase, 0.0) + (t - t0)
        self.marks.append((phase, t))
        if self.rf is None:
            self.resume()

    def stamps(self) -> tuple:
        """``(call start, encode end, stage marks so far)``: what a direct
        launch made now keeps for the idle gap before it."""
        return (self.t0, self.t_enc, tuple(self.marks))

    def encoded(self) -> None:
        """The call's encode phase ends now; its submit phase begins."""
        if self.t_enc is None:
            self.t_enc = time.monotonic()
            self.resume()

    def pause(self) -> None:
        """Close the submit range before a wait: a range around a wait
        would label every device gap it sits through."""
        rf, self.rf = self.rf, None
        if rf is not None:
            rf.__exit__(None, None, None)

    def resume(self) -> None:
        if self.t_enc is not None and self.rf is None and profiling():
            self.rf = host_range("rtpu:submit")
            self.rf.__enter__()


class CallRecorder:
    """``rtpu_call_phase_seconds{op, phase}``: one observation of each of
    ``CALL_PHASES`` per public data call, and of each of ``STAGE_PHASES``
    the call spent time in; together they sum to the call's time from
    entry to its return.  An op's children share one lock (made with
    them, the first time the op ends a call), so a call's observations
    take one lock and no family lookup; the family is reset only
    through ``reset``."""

    def __init__(self, registry):
        self._hist = registry.histogram(
            "rtpu_call_phase_seconds",
            "per-call client phase durations (encode | admit_wait | submit, "
            "and hash | drain | fetch | offer where the call has them)",
            ("op", "phase"))
        # op -> (lock, encode, admit_wait, submit children, {stage: child})
        self._ops: dict = {}
        self._lock = threading.Lock()

    @staticmethod
    def begin(op: str) -> Optional[_Call]:
        """Open a call on this thread; None when one is open already (the
        outermost call owns the phases)."""
        if getattr(_tls, "call", None) is not None:
            return None
        call = _tls.call = _Call(op)
        return call

    def _children(self, op: str) -> tuple:
        with self._lock:
            kids = self._ops.get(op)
            if kids is None:
                lock = threading.Lock()
                cs = [self._hist.child((op, ph)) for ph in CALL_PHASES]
                for c in cs:
                    c.lock = lock
                kids = self._ops[op] = (lock, *cs, {})
        return kids

    def _stage_children(self, op: str, stages) -> list:
        lock, _, _, _, more = self._ops.get(op) or self._children(op)
        out = []
        for ph in stages:
            c = more.get(ph)
            if c is None:
                with self._lock:
                    c = more.get(ph)
                    if c is None:
                        c = self._hist.child((op, ph))
                        c.lock = lock
                        more[ph] = c
            out.append(c)
        return out

    def end(self, call: _Call) -> None:
        _tls.call = None
        if call.rf is not None:
            call.pause()
        t = time.monotonic()
        t0, t_enc, adm = call.t0, call.t_enc, call.admit_s
        if t_enc is None:
            t_enc = t0
        enc = t_enc - t0
        sub = t - t_enc - adm
        stages = call.stages
        if stages:
            sub -= sum(stages.values())
            kids = self._stage_children(call.op, stages)
        if sub < 0.0:
            sub = 0.0
        lock, ce, ca, cs, _ = self._ops.get(call.op) or self._children(call.op)
        ie = bucket_index_us(enc * 1e6)
        ia = 0 if adm == 0.0 else bucket_index_us(adm * 1e6)
        is_ = bucket_index_us(sub * 1e6)
        with lock:
            ce.buckets[ie] += 1
            ce.sum += enc
            ce.count += 1
            ca.buckets[ia] += 1
            ca.sum += adm
            ca.count += 1
            cs.buckets[is_] += 1
            cs.sum += sub
            cs.count += 1
            if stages:
                for c, s in zip(kids, stages.values()):
                    c.buckets[bucket_index_us(s * 1e6)] += 1
                    c.sum += s
                    c.count += 1

    def observe(self, op: str, phase: str, seconds: float) -> None:
        """One observation of a stage that ran after ``op``'s call
        returned (an asynchronous call's top-K ``offer``, made when its
        future's result is first read)."""
        (c,) = self._stage_children(op, (phase,))
        with c.lock:
            c.buckets[bucket_index_us(seconds * 1e6)] += 1
            c.sum += seconds
            c.count += 1

    def reset(self) -> None:
        with self._lock:
            self._hist.reset()
            self._ops.clear()


# -- device time per launch and the idle gaps between launches --------------------


class _Stream:
    """One device's launch stream: its launches not yet retired, in record
    order, the end of the last retired one, and a few reusable events."""

    __slots__ = ("device", "cuda", "pending", "last", "free")

    def __init__(self, device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.pending: deque = deque()
        self.last = None  # end event (CUDA) or host stamp of the last retired
        self.free: list = []

    def event(self):
        if self.free:
            return self.free.pop()
        import torch

        return torch.cuda.Event(enable_timing=True)

    def release(self, ev) -> None:
        if len(self.free) < 32:
            self.free.append(ev)


class _Mark:
    """One launch on one stream."""

    __slots__ = ("launch", "stream", "cuda_stream", "start", "end", "t_rec", "t_end",
                 "staged")

    def __init__(self, launch, stream, cuda_stream, start, t_rec):
        self.launch = launch
        self.stream = stream
        self.cuda_stream = cuda_stream
        self.start = start
        self.end = None
        self.t_rec = t_rec
        self.t_end = None
        self.staged = False


class _Launch:
    __slots__ = ("timer", "op", "span", "call", "marks", "device_s", "left", "fetched")

    def __init__(self, timer, op, span, call=None):
        self.timer = timer
        self.op = op
        self.span = span
        self.call = call  # a direct launch's call stamps (``_Call.stamps``)
        self.marks: list = []
        self.device_s = 0.0
        self.left = 0
        self.fetched = False


def idle_causes(span, a: float, b: float, call=None) -> dict:
    """Split the host interval ``[a, b]`` in which the device sat idle
    before a launch into ``IDLE_CAUSES``, against the launch's host stamps.
    A coalesced launch (``span``): the caller's own code until the
    segment's first call began, that call's work until its admission wait
    (its encode and the engine's per-call work), the wait, the queue
    until staging, staging, the launch-slot wait and the enqueue up to
    ``b``.  A direct launch made inside a data call (``call``, the call's
    ``stamps()``): the caller's code until the call began, its encode,
    then each stage it marked (``hash``, ``drain``; the stretch before a
    stage counts with it) and its ``submit`` up to ``b``.  ``direct``
    with neither.  The parts sum to ``b - a``."""
    if span is not None:
        tc, ta0, ta1 = span.first or (None, None, None)
        queued = span.t0 if ta0 is None else ta0
        stamps = {}
        for name, t in span.stamps:
            stamps[name] = t  # a retried segment's latest stamps
        bounds = (
            ("caller", queued if tc is None else tc),
            ("encode", None if tc is None else queued),
            ("admit_wait", ta1),
            ("coalesce_wait", stamps.get("coalesce_wait")),
            ("host_stage", stamps.get("host_stage")),
            ("slot_wait", stamps.get("slot_wait")),
            ("enqueue", _INF),
        )
    elif call is not None:
        tc, t_enc, marks = call
        bounds = (("caller", tc), ("encode", t_enc), *marks, ("submit", _INF))
    else:
        return {"direct": b - a}
    parts: dict = {}
    lo = a
    for cause, until in bounds:
        if until is None:
            continue
        hi = b if until >= b else until
        if hi > lo:
            parts[cause] = parts.get(cause, 0.0) + (hi - lo)
            lo = hi
    return parts


class LaunchTimer:
    """Device time per launch from timing events, and each idle gap
    between launches put down to a host phase.

    ``begin`` records a start event on the current stream of each of the
    launch's devices (a launch spanning several cards gets one pair per
    card, and its device time is their sum: card-seconds) and takes the
    host stamp ``t_rec`` beside it; where the launch stages its inputs
    into one host block and copies it over (``staged``), the start moves
    to that copy, so the host's packing counts as enqueue, not device
    time; ``end`` records the end events.  On
    the CPU the host stamps are the device's: the launch's host duration
    is its device time.  ``retire`` runs once the launch's result is home
    (or, for a launch whose result is not fetched, once a later launch of
    the stream retires: a stream completes in order).  Then the launch's
    device time is observed, its span gets ``device_s``, the tenants
    stashed on the span are billed for it in the load map, and the gap
    ``g = elapsed(previous end, this start)``, where ``g > 0`` means the
    card idled over ``[t_rec - g, t_rec]`` on the host clock, is split by
    ``idle_causes`` into ``rtpu_device_idle_seconds``.  The stream is the
    bundle's own: launches of another engine on the same card count as
    idle here."""

    KEEP = 256
    MAX_PENDING = 4096

    def __init__(self, registry):
        self._device_hist = registry.histogram(
            "rtpu_launch_device_seconds",
            "device time per executor launch, from timing events around it "
            "on its stream (card-seconds: summed over the cards of a launch)",
            ("op",))
        self._idle = registry.counter(
            "rtpu_device_idle_seconds",
            "seconds the device sat idle before a launch, by the host phase "
            "that held the launch (caller | encode | hash | drain | submit | "
            "admit_wait | coalesce_wait | host_stage | slot_wait | enqueue | "
            "direct)",
            ("cause",))
        # The bundle's LoadMap: retired launches bill their device time
        # to the tenants stashed on their span.
        self.loadmap = None
        self._streams: dict = {}
        self._gaps: deque = deque(maxlen=self.KEEP)
        self._lock = threading.Lock()

    def _stream(self, device) -> _Stream:
        st = self._streams.get(device)
        if st is None:
            st = self._streams.setdefault(device, _Stream(device))
        return st

    def begin(self, devices, op: str, span=None, call=None) -> _Launch:
        """``span``: the coalesced segment the launch carries; ``call``:
        for a direct launch, the stamps of the data call making it."""
        launch = _Launch(self, op, span, call)
        for dev in devices:
            st = self._stream(dev)
            if st.cuda:
                import torch

                cs = torch.cuda.current_stream(dev)
                ev = st.event()
                ev.record(cs)
                mark = _Mark(launch, st, cs, ev, time.monotonic())
            else:
                mark = _Mark(launch, st, None, None, time.monotonic())
            launch.marks.append(mark)
        launch.left = len(launch.marks)
        with self._lock:
            for m in launch.marks:
                q = m.stream.pending
                if len(q) >= self.MAX_PENDING:
                    q.popleft()  # never retired: its gap goes uncounted
                    m.stream.last = None
                q.append(m)
        return launch

    def staged(self, launch: _Launch, device) -> None:
        """The launch's first copy to ``device`` is about to be queued:
        its work on that device begins here, so its start event is
        recorded again at this point (the host packing before it is the
        enqueue's work, not the device's)."""
        for m in launch.marks:
            if not m.staged and m.stream.device == device:
                m.staged = True
                if m.cuda_stream is not None:
                    m.start.record(m.cuda_stream)
                m.t_rec = time.monotonic()
                return

    def end(self, launch: _Launch) -> None:
        for m in launch.marks:
            if m.cuda_stream is not None:
                ev = m.stream.event()
                ev.record(m.cuda_stream)
                m.end = ev
            m.t_end = time.monotonic()

    def retire(self, launch: _Launch, fetched: bool = False) -> None:
        """The launch's result is home (``fetched``: a copy to the host
        proved it complete), or its caller is done with it."""
        with self._lock:
            launch.fetched = launch.fetched or fetched
            for m in launch.marks:
                self._retire_complete(m.stream)

    def _retire_complete(self, st: _Stream) -> None:
        q = st.pending
        last = -1
        for i in range(len(q) - 1, -1, -1):
            m = q[i]
            if m.t_end is None:
                continue  # still being enqueued
            if not st.cuda or m.launch.fetched or m.end.query():
                last = i
                break
        for _ in range(last + 1):
            self._retire_mark(st, q.popleft())

    def _retire_mark(self, st: _Stream, m: _Mark) -> None:
        if st.cuda:
            dt = m.start.elapsed_time(m.end) / 1e3
            gap = None
            if st.last is not None:
                gap = st.last.elapsed_time(m.start) / 1e3
                st.release(st.last)
            st.release(m.start)
            st.last = m.end
        else:
            dt = m.t_end - m.t_rec
            gap = None if st.last is None else m.t_rec - st.last
            st.last = m.t_end
        launch = m.launch
        launch.device_s += dt
        launch.left -= 1
        if gap is not None and gap > 0:
            parts = idle_causes(launch.span, m.t_rec - gap, m.t_rec, launch.call)
            for cause, s in parts.items():
                self._idle.inc((cause,), s)
            self._gaps.append((gap, parts, launch.op))
        if launch.left == 0:
            self._launch_retired(launch)

    def _launch_retired(self, launch: _Launch) -> None:
        self._device_hist.observe((launch.op,), launch.device_s)
        span = launch.span
        if span is None:
            return
        # A segment whose dispatch made several launches sums them.
        span.device_s = (span.device_s or 0.0) + launch.device_s
        lm = self.loadmap
        if lm is not None and span.tenants and not span.error:
            try:
                lm.attribute_launch(span.op, span.tenants, launch.device_s * 1e6)
            except Exception:
                pass  # attribution must not fail the completer

    def recent_gaps(self) -> list:
        """The last gaps: ``(seconds, {cause: seconds}, op)``, oldest first."""
        with self._lock:
            return list(self._gaps)

    def reset(self) -> None:
        self._device_hist.reset()
        self._idle.reset()
        with self._lock:
            self._gaps.clear()
