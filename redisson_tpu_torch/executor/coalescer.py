"""BatchCoalescer — cross-call op coalescing (the CommandBatchService role).

Counterpart of ``redisson_tpu/executor/coalescer.py``.  Every async sketch
op lands in a multi-producer queue; one flush thread drains it into
per-(pool, opcode, k) segments and dispatches each segment as ONE
multi-tenant device batch.

Flush policy: a segment flushes when it reaches ``max_batch`` ops, when
its oldest op is older than the live flush window, or at once when a
caller blocks on a result (``flush_hint``).  The window adapts: an
arrival-rate and queue-pressure controller moves it inside
[min_window, max_window] around the ``batch_window_us`` base.
Consecutive same-key segments merge at pop time (up to ``merge_cap``),
so a backlog collapses into fewer, larger launches.  An AIMD window
bounds dispatched-but-uncollected launches (halved on a slow
retirement, +1 after a streak of fast ones); a completer thread fetches
results (several pending launches at once through the executor's result
mailbox) and resolves the futures.  Producers block once
``max_queued_ops`` ops are queued ahead of the flush thread.

Failures (executor/failures.py):

- a dispatch that raises before writing pool state is PARKED — put back
  at the front of the queue with a jittered exponential backoff — and
  retried up to ``retry_attempts`` times in all, while other pools keep
  flushing; ``NonRetryableDispatchError`` (part of the launch already
  written) fails the launch once;
- a failure at completion (the result fetch) is not retried;
- every failure feeds the per-op-path circuit breaker (``health``);
  success is recorded only at completion, where it is proven;
- an op carrying a deadline is shed strictly before dispatch: at submit
  (already expired, or the admission estimate of its queue wait exceeds
  its residual budget), in the queue bound, or when every op of its
  segment expired while queued.

Ordering: segments of one pool flush FIFO (a parked segment holds back
its own pool's later segments), so a read submitted after a write
observes it.

Spans (obs/spans.py): with an ``obs`` bundle, each segment carries one
lifecycle span, stamped at the end of its queue wait and of its host
staging (``_stage``), when it holds a launch slot, after its dispatch
enqueue, and at retire, so the five phases partition the launch's
end-to-end time.  The span of a segment a public data call creates
keeps when that call began and when it was admitted (the call is the
submitting thread's ambient context, obs/spans.py ``current_call``), and
the flush thread names the span it dispatches (``set_launch``), so the
executor's launch timer can put each idle gap of the device before the
launch down to the phase that held it.  A sampled request's ambient
trace context (obs/trace.py) links to the span of every launch its ops
ride; a merged-away segment's links move to the head's span.

Profiler ranges: ``rtpu:stage`` around the staging and
``rtpu:enqueue:<op>`` around the dispatch, opened only while a torch
profiler records; no range covers a wait (admission, queue, launch
slot, fetch), which would span, and so label, every device gap it sits
through.
"""

from __future__ import annotations

import concurrent.futures
import queue
import random
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Optional

import numpy as np

from redisson_tpu_torch.analysis import witness as _witness
from redisson_tpu_torch import chaos as _chaos
from redisson_tpu_torch.obs import spans as _spans, trace as _trace
from redisson_tpu_torch.executor.failures import (
    DeadlineExceededError,
    DispatchTimeoutError,
    KernelExecutionError,
    NonRetryableDispatchError,
    RetryExhaustedError,
)


def _op_label(key) -> str:
    """Segment keys are tuples whose first element names the op path."""
    if isinstance(key, tuple) and key and isinstance(key[0], str):
        return key[0]
    return "op"


class _Segment:
    __slots__ = ("key", "pool_key", "dispatch", "chunks", "metas", "futures",
                 "nops", "born", "span", "not_before", "attempts")

    def __init__(self, key, pool_key, dispatch):
        self.key = key
        self.pool_key = pool_key
        self.dispatch = dispatch  # fn(cols[, metas]) -> LazyResult; None = barrier
        self.chunks: list[tuple] = []  # per-submit tuples of op arrays
        # Per-submit run-length metadata, parallel to chunks (None for
        # plain segments): values constant across one submit travel once.
        self.metas: Optional[list] = None
        self.futures: list[tuple] = []  # (future, start, n, tenant, deadline)
        self.nops = 0
        self.born = time.monotonic()
        # Lifecycle span (obs/spans.py): one per launch, not per op.
        self.span = None
        # Retry state: a transiently failed segment is parked with a
        # backoff deadline instead of sleeping the flush thread.
        self.not_before: Optional[float] = None
        self.attempts = 0


class HintedFuture:
    """Future adapter: a blocking ``.result()`` nudges the coalescer to
    flush at once instead of waiting out the batch window.

    Timeout resolution: an explicit ``timeout`` wins; otherwise the wait
    is bounded by the op's residual DEADLINE (when one rode the submit),
    capped at the coalescer's ``fetch_timeout_s``.  A deadline-bounded
    miss raises DeadlineExceededError (overload: the device is not
    implicated); a fetch-timeout miss raises DispatchTimeoutError AND
    records a breaker failure and ``rtpu_fetch_timeouts``, like any other
    completion failure."""

    def __init__(self, fut: Future, coalescer: "BatchCoalescer",
                 transform=None, deadline: Optional[float] = None,
                 op: Optional[str] = None, nops: int = 1):
        self._fut = fut
        self._c = coalescer
        self._transform = transform
        self._deadline = deadline
        self._op = op
        self._nops = nops

    @property
    def deadline(self) -> Optional[float]:
        return self._deadline

    def result(self, timeout: Optional[float] = None):
        deadline_bound = False
        if timeout is None:
            timeout = self._c.fetch_timeout_s
            if self._deadline is not None:
                rem = self._deadline - time.monotonic()
                if rem < timeout:
                    timeout = max(0.0, rem)
                    deadline_bound = True
        if not self._fut.done():
            self._c.flush_hint()
        try:
            v = self._fut.result(timeout)
        except concurrent.futures.TimeoutError as e:
            if self._fut.done():
                # The op's own failure, not the wait's: a shed op's
                # DeadlineExceededError is a TimeoutError too.
                raise
            if deadline_bound:
                self._c.note_deadline_wait(self._op, self._nops)
                raise DeadlineExceededError(
                    f"op deadline expired waiting for {self._op or 'result'} "
                    f"(residual budget {timeout * 1e3:.1f} ms)", stage="fetch_wait",
                ) from e
            err = DispatchTimeoutError(f"result not ready within {timeout}s")
            self._c.note_fetch_timeout(self._op, err)
            raise err from e
        return v if self._transform is None else self._transform(v)

    def get(self):
        return self.result()

    def done(self) -> bool:
        return self._fut.done()

    def add_done_callback(self, fn) -> None:
        self._fut.add_done_callback(fn)


class BatchCoalescer:
    def __init__(self, *, batch_window_us: int, max_batch: int,
                 metrics=None, max_inflight: int = 8, retry_attempts: int = 3,
                 retry_interval_s: float = 0.05, max_queued_ops: int = 0,
                 adaptive_inflight: bool = True, min_inflight: int = 2,
                 adaptive_window: bool = True, min_window_us: int = 0,
                 max_window_us: int = 0,
                 group_collect: Optional[Callable] = None, obs=None,
                 retry_max_backoff_s: float = 2.0,
                 retry_jitter: float = 0.2, health=None,
                 max_batch_slow_phase: int = 0,
                 fetch_timeout_s: float = 120.0):
        self.window_s = batch_window_us / 1e6
        self.max_batch = max_batch
        # Phase-aware merge cap: while the put-RT EWMA says launches
        # retire slowly, merge-at-pop may combine segments up to this
        # bound (fewer, larger launches).  0 disables; values <= max_batch
        # are inert.  Submit-side segment fill keeps the static cap.
        self.max_batch_slow_phase = max(0, int(max_batch_slow_phase))
        # EWMA of observed launch retirement latency (the put-RT signal):
        # genuine samples only for FAST readings (a backlogged completer's
        # near-zero collect time proves nothing); slow readings always
        # count (the result really took that long).
        self._put_rt_ewma = 0.0
        # Adaptive flush window around the ``batch_window_us`` base.
        self.base_window_s = self.window_s
        self._adaptive_window = adaptive_window
        self.min_window_s = (
            min_window_us if min_window_us > 0 else batch_window_us / 2
        ) / 1e6
        self.max_window_s = (
            max_window_us if max_window_us > 0 else batch_window_us * 8
        ) / 1e6
        self._rate_ewma = 0.0
        self._ops_seen = 0  # monotonic submitted-op counter (under _lock)
        self._rate_mark = (time.monotonic(), 0)
        self.obs = obs
        # serve.metrics.Metrics: one record_batch per retired launch.
        self.metrics = metrics
        # RedisExecutor-style retry budget for dispatch-time failures.
        self.retry_attempts = max(1, retry_attempts)
        self.retry_interval_s = retry_interval_s
        self.retry_max_backoff_s = max(retry_interval_s, retry_max_backoff_s)
        self.retry_jitter = max(0.0, min(1.0, retry_jitter))
        self._rng = random.Random(0x5EEDBACC)  # jitter only — not fairness
        # Optional DispatchHealth (executor/health.py): per-op-path
        # circuit breakers.  None -> retry only.
        self._health = health
        # Overload control plane: ``fetch_timeout_s`` bounds a no-deadline
        # blocking .result(); the admission estimator keeps EWMAs of
        # flush-to-retire latency and ops per launch.
        self.fetch_timeout_s = max(0.001, float(fetch_timeout_s))
        self._service_ewma_s = 0.0
        self._ops_per_launch_ewma = 0.0
        self.last_est_wait_s = 0.0  # rtpu_admission_est_wait_us gauge
        # Journal lag (durability/journal.py lag_s), wired by the engine
        # while a journal is attached: under appendfsync always an ack
        # waits for its fsync, so a slow disk sheds deadline-carrying
        # load instead of queueing it unboundedly.
        self.journal_lag_s = None
        self.max_queued_ops = max_queued_ops if max_queued_ops > 0 else 8 * max_batch
        self._queued_ops = 0
        # AIMD bound on dispatched-but-uncollected launches: a counter and
        # a condition rather than a semaphore, so the limit can adapt.
        self._max_inflight_cfg = max(1, max_inflight)
        self._min_inflight = max(1, min(min_inflight, self._max_inflight_cfg))
        self._adaptive = adaptive_inflight
        self._inflight_limit = self._max_inflight_cfg
        self._uncollected = 0
        self._inflight_cv = threading.Condition(
            _witness.named(threading.Lock(), "coalescer.inflight")
        )
        self._good_streak = 0
        # Retirement thresholds (s) of the AIMD window and the phase
        # signals (the JAX package's values).
        self.slow_launch_s = 0.25
        self.fast_launch_s = 0.08
        # Queued segments in flush order.  A segment stays joinable while
        # queued and still its pool's most recent (``_pool_tail``): per-pool
        # arrival order with cross-pool coalescing in between.
        self._order: deque[_Segment] = deque()
        self._open: dict = {}
        self._pool_tail: dict = {}
        self._hurry = False  # a caller is blocking: drain the queue now
        self._lock = _witness.named(threading.Lock(), "coalescer.queue")
        self._wake = threading.Condition(self._lock)
        # Producers blocked on the queue bound wait here in FIFO ticket
        # order, so a bulk submit is not starved by a stream of small ones.
        self._admit = threading.Condition(self._lock)
        self._admit_q: deque = deque()
        self._inflight = 0  # popped but not yet dispatched
        self._closed = False
        self._group_collect = group_collect
        self._completions: "queue.Queue" = queue.Queue()
        self._completer = threading.Thread(
            target=self._complete_loop, name="rtpu-torch-completer", daemon=True
        )
        self._completer.start()
        self._thread = threading.Thread(
            target=self._run, name="rtpu-torch-coalescer", daemon=True
        )
        self._thread.start()

    # -- producer side -----------------------------------------------------

    def submit(self, key, dispatch: Callable, arrays: tuple, nops: int,
               pool_key=None, meta=None, tenant=None,
               deadline: Optional[float] = None) -> Future:
        """Queue ``nops`` ops (column arrays in ``arrays``) for the segment
        ``key``; returns a Future of the per-op result slice.  With
        ``meta``, the segment's dispatch is called as
        ``dispatch(cols, metas)`` with ``metas`` the (nops, meta) of each
        chunk in order; all submits of one key agree on using it.

        ``deadline``: absolute monotonic instant after which the ops are
        worthless.  With one set, submit FAILS FAST with
        DeadlineExceededError instead of blocking: already expired, the
        admission estimate says the queue wait alone exceeds the residual
        budget, or the backpressure wait outlives it.  Ops shed here (and
        by the expired-segment sweep at flush) were never dispatched."""
        if pool_key is None:
            pool_key = key
        fut: Future = Future()
        call = _spans.current_call()
        adm0 = adm1 = None
        with self._lock:
            if self._closed:
                raise RuntimeError("coalescer is shut down")
            if deadline is not None:
                now = time.monotonic()
                if now >= deadline:
                    self._count_shed("deadline", "submit", nops)
                    raise DeadlineExceededError(
                        f"op deadline already expired at submit "
                        f"({_op_label(key)}, {nops} ops)", stage="submit",
                    )
                est = self.estimate_wait_s()
                if est > deadline - now:
                    self._count_shed("admission", "admission", nops)
                    raise DeadlineExceededError(
                        f"admission control: estimated queue wait "
                        f"{est * 1e3:.1f} ms exceeds residual deadline "
                        f"{(deadline - now) * 1e3:.1f} ms "
                        f"({_op_label(key)}, {nops} ops)", stage="admission",
                    )

            def _full() -> bool:
                return (
                    self._queued_ops > 0
                    and self._queued_ops + nops > self.max_queued_ops
                )

            if _full():
                adm0 = time.monotonic()
                if call is not None:
                    call.pause()
                ticket = object()
                self._admit_q.append(ticket)
                try:
                    while not self._closed and (
                        self._admit_q[0] is not ticket or _full()
                    ):
                        wait_s = 1.0
                        if deadline is not None:
                            wait_s = deadline - time.monotonic()
                            if wait_s <= 0:
                                self._count_shed("deadline", "queue", nops)
                                raise DeadlineExceededError(
                                    f"queue full past op deadline "
                                    f"({_op_label(key)}, {nops} ops)", stage="queue",
                                )
                            wait_s = min(wait_s, 1.0)
                        self._wake.notify()
                        self._admit.wait(timeout=wait_s)
                finally:
                    self._admit_q.remove(ticket)
                    self._admit.notify_all()
                    adm1 = time.monotonic()
                    if call is not None:
                        call.admit_s += adm1 - adm0
                        call.resume()
            if self._closed:
                raise RuntimeError("coalescer is shut down")
            seg = self._open.get(key)
            if (
                seg is None
                or self._pool_tail.get(seg.pool_key) is not seg
                or seg.nops + nops > self.max_batch
            ):
                seg = _Segment(key, pool_key, dispatch)
                if self.obs is not None:
                    seg.span = self.obs.spans.start(_op_label(key))
                    seg.span.first = (None if call is None else call.t0, adm0, adm1)
                if meta is not None:
                    seg.metas = []
                self._open[key] = seg
                self._pool_tail[pool_key] = seg
                self._order.append(seg)
                self._wake.notify()
            seg.chunks.append(arrays)
            if meta is not None:
                seg.metas.append((nops, meta))
            if _trace.ENABLED and seg.span is not None:
                # A sampled request's ambient context parents this launch:
                # the span's finish records the launch, with its phases,
                # into every linked trace.  One attribute read and a
                # branch while tracing is off.
                tctx = _trace.current()
                if tctx is not None:
                    seg.span.link(tctx)
            seg.futures.append((fut, seg.nops, nops, tenant, deadline))
            seg.nops += nops
            self._queued_ops += nops
            self._ops_seen += nops  # feeds the adaptive window
            if seg.nops >= self.max_batch:
                self._wake.notify()
        return fut

    def flush_hint(self) -> None:
        """A caller is about to block on a Future — flush eagerly."""
        with self._lock:
            self._hurry = True
            self._wake.notify()

    # -- overload control plane --------------------------------------------

    def pressure(self) -> float:
        """Queued ops over the admission bound (can exceed 1.0 briefly:
        an oversize single submit is admitted at an empty queue)."""
        return self._queued_ops / max(1, self.max_queued_ops)

    def _phase_service_s(self) -> float:
        """Per-launch service estimate with the phase correction: the
        flush-to-retire EWMA is the base, and the faster put-RT EWMA
        corrects it in both directions — a slow put-RT FLOORS it (a launch
        cannot retire faster than it now takes), a fast put-RT under a
        stale-slow base CAPS it near the fast bound."""
        svc = self._service_ewma_s
        rt = self._put_rt_ewma
        if svc <= 0.0 or rt <= 0.0:
            return svc
        if rt > self.slow_launch_s:
            return max(svc, rt)
        if rt < self.fast_launch_s and svc > self.slow_launch_s:
            return max(rt, self.fast_launch_s)
        return svc

    def estimate_wait_s(self) -> float:
        """Admission estimate of the queue wait a NEW op faces: launches
        ahead of it (queued ops at the observed ops per launch, plus
        dispatched-but-uncollected) times the phase-corrected service
        estimate, over the live in-flight window.  Zero until the first
        launch retires; plus the journal's fsync lag when one is wired.
        The ``overload.pressure`` chaos point inflates it
        deterministically (chaos.bias)."""
        svc = self._phase_service_s()
        if svc <= 0.0:
            est = 0.0
        else:
            opl = max(1.0, self._ops_per_launch_ewma)
            launches_ahead = self._queued_ops / opl + self._uncollected
            est = svc * launches_ahead / max(1, self._inflight_limit)
        jl = self.journal_lag_s
        if jl is not None:
            est += jl()
        if _chaos.ENABLED:
            est += _chaos.bias("overload.pressure")
        self.last_est_wait_s = est
        return est

    def _count_shed(self, reason: str, stage: str, nops: int) -> None:
        if self.obs is not None:
            self.obs.shed_ops.inc((reason,), nops)
            self.obs.deadline_exceeded.inc((stage,), nops)

    def note_fetch_timeout(self, op: Optional[str], exc) -> None:
        """A blocking result wait hit the fetch timeout: a completion
        failure like any other — it feeds the breaker (a device whose
        results never arrive must eventually open the circuit) and the
        rtpu_fetch_timeouts counter."""
        if self._health is not None:
            self._health.record_failure(op or "fetch", exc)
        if self.obs is not None:
            self.obs.fetch_timeouts.inc((op or "fetch",))

    def note_deadline_wait(self, op: Optional[str], nops: int = 1) -> None:
        """A result wait was cut short by the op's own deadline: overload
        accounting only — the device is not implicated, no breaker
        failure."""
        if self.obs is not None:
            self.obs.deadline_exceeded.inc(("fetch_wait",), nops)

    @staticmethod
    def _all_expired(seg: _Segment, now: float) -> bool:
        """True when EVERY op of the segment carries a deadline and all
        have passed: shed it before it costs a launch."""
        return bool(seg.futures) and all(
            dl is not None and dl <= now for _f, _s, _n, _t, dl in seg.futures
        )

    def _shed_segment(self, seg: _Segment) -> None:
        """Fail every future of a fully expired segment with
        DeadlineExceededError — strictly pre-dispatch (a parked retry
        segment was dispatched but FAILED: equally unapplied).  Its span
        ends in one ``enqueue`` phase, as a failed dispatch's does, so
        its queue time stays out of the ``coalesce_wait`` samples."""
        if seg.span is not None:
            seg.span.nops = seg.nops
            seg.span.stamp("enqueue")
            seg.span.finish(error=True)
        self._count_shed("deadline", "queue", seg.nops)
        e = DeadlineExceededError(
            f"op deadline expired while queued ({_op_label(seg.key)}, "
            f"{seg.nops} ops, attempts={seg.attempts})", stage="queue",
        )
        for fut, _start, _n, _tenant, _dl in seg.futures:
            if fut.set_running_or_notify_cancel():
                fut.set_exception(e)

    # -- flush thread ------------------------------------------------------

    def _detach_locked(self, seg: _Segment) -> None:
        if self._open.get(seg.key) is seg:
            del self._open[seg.key]
        if self._pool_tail.get(seg.pool_key) is seg:
            del self._pool_tail[seg.pool_key]
        if seg.nops:
            self._queued_ops -= seg.nops
            self._admit.notify_all()

    def _pop_seg_locked(self, seg: _Segment) -> _Segment:
        self._order.remove(seg)
        self._detach_locked(seg)
        seg.not_before = None
        if not self._order:
            self._hurry = False
        self._inflight += 1
        return seg

    def _requeue_locked(self, seg: _Segment, not_before: float) -> None:
        """Park a transiently failed segment at the FRONT of the queue
        with a backoff deadline: ahead of every later segment of its own
        pool (arrival order), while other pools skip past it
        (_next_locked), so one failing pool never stalls the rest."""
        seg.not_before = not_before
        self._inflight -= 1
        if seg.nops:
            self._queued_ops += seg.nops
        self._order.appendleft(seg)
        self._wake.notify()

    def merge_cap(self) -> int:
        """Live pop-time merge bound: ``max_batch``, or
        ``max_batch_slow_phase`` while the put-RT EWMA says launches
        retire slowly."""
        cap = self.max_batch_slow_phase
        if cap > self.max_batch and self._put_rt_ewma > self.slow_launch_s:
            return cap
        return self.max_batch

    def _merge_consecutive_locked(self, head: _Segment, i: int) -> _Segment:
        """Fold the queued same-key segments immediately FOLLOWING
        ``head``'s old position into it (up to merge_cap); a different
        key is an order fence, and a parked segment is never merged."""
        cap = self.merge_cap()
        while i < len(self._order):
            nxt = self._order[i]
            if (
                nxt.key != head.key
                or head.nops + nxt.nops > cap
                or nxt.not_before is not None
            ):
                break
            del self._order[i]
            self._detach_locked(nxt)
            if nxt.span is not None:
                # Its ops ride the head's span; trace links move with them.
                nxt.span.abandon(into=head.span)
            head.chunks.extend(nxt.chunks)
            if head.metas is not None:
                head.metas.extend(nxt.metas)
            for fut, start, n, tenant, dl in nxt.futures:
                head.futures.append((fut, head.nops + start, n, tenant, dl))
            head.nops += nxt.nops
        if not self._order:
            self._hurry = False
        return head

    def _next_locked(self, now: float):
        """(segment, index, deadline): the next dispatchable segment,
        honoring per-pool FIFO around PARKED segments (a parked segment
        holds back its own pool's later segments, nothing else; a barrier
        never overtakes one submitted before it).  (None, -1, deadline)
        when nothing is ready — ``deadline`` is the earliest instant
        something becomes actionable."""
        parked: set = set()
        deadline = None
        for i, seg in enumerate(self._order):
            if seg.dispatch is None:  # barrier
                if parked:
                    break
                return seg, i, None
            if seg.pool_key in parked:
                continue
            nb = seg.not_before
            if nb is not None and nb > now and not self._closed:
                if self._all_expired(seg, now):
                    # Every op expired: pop it now so the flush loop sheds
                    # it instead of waiting out the backoff.
                    return seg, i, None
                parked.add(seg.pool_key)
                deadline = nb if deadline is None else min(deadline, nb)
                continue
            if (
                seg.nops >= self.max_batch
                or seg.attempts > 0
                or self._closed
                or self._hurry
                or now - seg.born >= self.window_s
            ):
                return seg, i, None
            # Young and small: later segments are younger still.
            d = seg.born + self.window_s
            deadline = d if deadline is None else min(deadline, d)
            break
        return None, -1, deadline

    def _update_window_locked(self) -> None:
        """Adaptive flush window: EWMA the arrival rate (~50 ms time
        constant), map rate and queue backlog to a pressure score in
        [0, 1], and set the live window inside [min_window, max_window]."""
        if not self._adaptive_window:
            return
        now = time.monotonic()
        t0, seen0 = self._rate_mark
        dt = now - t0
        if dt < 0.002:  # sub-controller-tick: keep the current estimate
            return
        inst = (self._ops_seen - seen0) / dt
        self._rate_mark = (now, self._ops_seen)
        a = min(1.0, dt / 0.05)
        self._rate_ewma += a * (inst - self._rate_ewma)
        fill = self._rate_ewma * self.max_window_s / self.max_batch
        backlog = self._queued_ops / max(1, self.max_queued_ops)
        p = min(1.0, fill + backlog)
        self.window_s = self.min_window_s + (self.max_window_s - self.min_window_s) * p

    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._order and not self._closed:
                    self._hurry = False
                    self._wake.wait(timeout=0.05)
                if self._closed and not self._order:
                    return
                if not self._order:
                    continue
                self._update_window_locked()
                now = time.monotonic()
                seg, idx, deadline = self._next_locked(now)
                if seg is None:
                    timeout = (
                        0.05 if deadline is None
                        else min(max(deadline - now, 0.0005), 0.05)
                    )
                    self._wake.wait(timeout=timeout)
                    continue
                self._pop_seg_locked(seg)
                if seg.dispatch is not None and not self._all_expired(seg, now):
                    seg = self._merge_consecutive_locked(seg, idx)
            # Expired-segment sweep: shed before staging, before a launch
            # slot, before the device sees it.  (An expired head is not
            # merged, so a fresh same-key segment is not dragged along.)
            if seg.dispatch is not None and self._all_expired(seg, time.monotonic()):
                with self._lock:
                    self._inflight -= 1
                self._shed_segment(seg)
                continue
            cols = stage_exc = None
            if seg.dispatch is not None:
                # Stage first, then wait for a launch slot: host packing
                # overlaps the launches in flight.
                try:
                    cols = self._stage(seg)
                except Exception as e:
                    stage_exc = e
                if stage_exc is None:
                    self._acquire_launch_slot()
                    if seg.span is not None:
                        seg.span.stamp("slot_wait")
            self._flush(seg, cols, stage_exc)

    def _stage(self, seg: _Segment) -> list:
        """Host staging: concatenate the segment's per-submit chunks into
        flush columns, before the launch-slot wait (it overlaps the
        launches in flight); the span's host_stage phase is this work."""
        if seg.span is not None:
            seg.span.stamp("coalesce_wait")  # queue time ends here
        with _spans.host_range("rtpu:stage"):
            cols = [
                c[0] if len(c) == 1 else np.concatenate(c)
                for c in zip(*seg.chunks)
            ]
        if seg.span is not None:
            seg.span.stamp("host_stage")
        return cols

    def _acquire_launch_slot(self) -> None:
        with self._inflight_cv:
            while self._uncollected >= self._inflight_limit:
                self._inflight_cv.wait(timeout=0.5)
            self._uncollected += 1

    def _release_launch_slot(self, collect_s: Optional[float],
                             genuine: bool = True) -> None:
        """Free a launch slot; ``collect_s`` (the launch's observed
        retirement latency, None on error paths) drives the AIMD window:
        halve on a slow retirement, +1 after four fast ones.
        ``genuine``: False when the completer was backlogged, so a
        near-zero collect time says nothing and must not feed the grow
        streak (slow readings count either way)."""
        with self._inflight_cv:
            self._uncollected = max(0, self._uncollected - 1)
            if collect_s is not None and (genuine or collect_s > self.slow_launch_s):
                self._put_rt_ewma += 0.25 * (collect_s - self._put_rt_ewma)
            if self._adaptive and collect_s is not None:
                if collect_s > self.slow_launch_s:
                    self._inflight_limit = max(self._min_inflight, self._inflight_limit // 2)
                    self._good_streak = 0
                elif genuine and collect_s < self.fast_launch_s:
                    self._good_streak += 1
                    if (
                        self._good_streak >= 4
                        and self._inflight_limit < self._max_inflight_cfg
                    ):
                        self._inflight_limit += 1
                        self._good_streak = 0
            self._inflight_cv.notify_all()

    def _backoff_s(self, attempts: int) -> float:
        """Jittered exponential backoff: the base doubles per attempt,
        capped at retry_max_backoff_s, scaled by a uniform ±retry_jitter
        factor (retrying segments never herd the device)."""
        base = min(
            self.retry_interval_s * (2 ** max(0, attempts - 1)),
            self.retry_max_backoff_s,
        )
        if self.retry_jitter:
            base *= 1.0 + self.retry_jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, base)

    def _fail_futures(self, seg: _Segment, e: BaseException) -> None:
        if seg.span is not None:
            seg.span.nops = seg.nops
            seg.span.stamp("enqueue")
            seg.span.finish(error=True)
        for fut, start, n, _, _dl in seg.futures:
            if fut.set_running_or_notify_cancel():
                fut.set_exception(
                    e if isinstance(e, RetryExhaustedError)
                    else KernelExecutionError(seg.key, start, n, seg.nops, e)
                )

    def _flush(self, seg: _Segment, cols=None, stage_exc=None) -> None:
        t0 = time.monotonic()
        try:
            if seg.dispatch is None:  # drain barrier
                with self._lock:
                    self._inflight -= 1
                for fut, _, _, _, _ in seg.futures:
                    if fut.set_running_or_notify_cancel():
                        fut.set_result(None)
                return
            if stage_exc is not None:
                raise stage_exc  # no launch slot was taken
            op = _op_label(seg.key)
            h = self._health
            if h is not None and not h.allow_dispatch(op):
                # Circuit OPEN for this op path: fail fast, the device is
                # not touched.
                from redisson_tpu_torch.executor.health import CircuitOpenError

                raise RetryExhaustedError(seg.attempts + 1, CircuitOpenError(0, op))
            # The executor's launch timer reads which span it launches.
            _spans.set_launch(seg.span)
            try:
                with _spans.host_range("rtpu:enqueue:" + op):
                    if seg.metas is not None:
                        lazy = seg.dispatch(cols, seg.metas)
                    else:
                        lazy = seg.dispatch(cols)
            except NonRetryableDispatchError as e:
                # Part of the launch is already in the pools: a re-dispatch
                # would apply it twice.
                if h is not None:
                    h.record_failure(op, e)
                raise RetryExhaustedError(seg.attempts + 1, e)
            except Exception as e:
                # Dispatch-time failure before any pool write: park the
                # segment with a backoff and return the flush thread to
                # healthy traffic.
                if h is not None:
                    h.record_failure(op, e)
                seg.attempts += 1
                if seg.attempts >= self.retry_attempts or (
                    h is not None and not h.allow_dispatch(op)
                ):
                    raise RetryExhaustedError(seg.attempts, e)
                backoff = self._backoff_s(seg.attempts)
                with self._lock:
                    self._requeue_locked(seg, time.monotonic() + backoff)
                self._release_launch_slot(None)
                return
            finally:
                _spans.set_launch(None)
            # No record_success here: an enqueue proves nothing (a device
            # whose every result fetch fails would reset the breaker's
            # streak each launch and never open).  The completer records
            # success once the result is home.
            if seg.span is not None:
                seg.span.stamp("enqueue")  # enqueue done, async
            with self._lock:
                self._inflight -= 1
            self._completions.put((seg, lazy, t0))
        except Exception as e:
            with self._lock:
                if self._inflight > 0:
                    self._inflight -= 1
            if stage_exc is None:
                self._release_launch_slot(None)
            self._fail_futures(seg, e)

    def _complete_loop(self) -> None:
        stop = False
        while not stop:
            item = self._completions.get()
            if item is None:
                return
            # Scoop every completion already queued so their results come
            # home in one D2H (collect_group).
            group = [item]
            while self._group_collect is not None and len(group) < 64:
                try:
                    nxt = self._completions.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                group.append(nxt)
            genuine = len(group) == 1 and self._completions.qsize() == 0
            t_collect = time.monotonic()
            if len(group) > 1:
                try:
                    self._group_collect([lazy for _, lazy, _ in group])
                except Exception:
                    pass  # each item's own .result() below surfaces it
            first = True
            for seg, lazy, t0 in group:
                op = _op_label(seg.key)
                if seg.span is not None:
                    # Load attribution: the (tenant, nops) composition,
                    # stashed before the fetch retires the launch, so the
                    # launch timer bills its device time per tenant; only
                    # while a loadmap is armed.
                    lm = self.obs.launches.loadmap
                    if lm is not None and lm.enabled:
                        seg.span.tenants = [
                            (t, n) for _, _, n, t, _ in seg.futures
                            if t is not None
                        ] or None
                try:
                    res = lazy.result()
                except Exception as e:
                    # Completion-time failure (an asynchronous device error
                    # surfaces at this fetch): the launch ran, so it is NOT
                    # retried; each caller learns its op range.
                    if self._health is not None:
                        self._health.record_failure(op, e)
                    self._release_launch_slot(None)
                    first = False
                    if seg.span is not None:
                        seg.span.nops = seg.nops
                        seg.span.stamp("d2h_fetch")
                        seg.span.finish(error=True)
                    self._record_batch(seg, t0)
                    for fut, start, n, _, _dl in seg.futures:
                        if fut.set_running_or_notify_cancel():
                            fut.set_exception(
                                KernelExecutionError(seg.key, start, n, seg.nops, e))
                    continue
                self._release_launch_slot(
                    time.monotonic() - t_collect if first else None, genuine=genuine)
                first = False
                if self._health is not None:
                    self._health.record_success(op)
                # Admission estimator: flush-to-retire latency and ops per
                # launch (~5-sample EWMAs; GIL-atomic float stores).
                self._service_ewma_s += 0.2 * (time.monotonic() - t0 - self._service_ewma_s)
                self._ops_per_launch_ewma += 0.2 * (seg.nops - self._ops_per_launch_ewma)
                if seg.span is not None:
                    seg.span.nops = seg.nops
                    seg.span.stamp("d2h_fetch")
                    seg.span.finish()
                if self.obs is not None:
                    # Per-tenant accounting, deferred from submit to here
                    # so producers never pay the counter lock.
                    for _, _, n, tenant, _dl in seg.futures:
                        if tenant is not None:
                            self.obs.tenant_ops.inc((tenant, op), n)
                self._record_batch(seg, t0)
                for fut, start, n, _, _dl in seg.futures:
                    if fut.set_running_or_notify_cancel():
                        fut.set_result(None if res is None else res[start : start + n])

    def _record_batch(self, seg: _Segment, t0: float) -> None:
        """Wait (born -> flush) and flush (flush -> retire) of one retired
        launch, failed or not, as the JAX package records them; recorded
        before its futures resolve, so a caller whose result is home
        reads its ops in the metrics."""
        if self.metrics is not None:
            self.metrics.record_batch(
                nops=seg.nops, wait_s=t0 - seg.born,
                flush_s=time.monotonic() - t0,
            )

    def drain(self, timeout: float = 30.0) -> None:
        """Barrier: block until every segment submitted before this call
        has dispatched (direct state reads observe all prior ops)."""
        fut: Future = Future()
        with self._lock:
            if self._closed or (not self._order and self._inflight == 0):
                return
            barrier = object()  # unique key: never merged into
            seg = _Segment(barrier, barrier, None)
            seg.futures.append((fut, 0, 0, None, None))
            self._order.append(seg)
            self._hurry = True
            self._wake.notify()
        fut.result(timeout)

    # -- lifecycle ---------------------------------------------------------

    def shutdown(self, timeout: Optional[float] = 5.0) -> None:
        with self._lock:
            self._closed = True
            self._wake.notify_all()
            self._admit.notify_all()
        self._thread.join(timeout=timeout)
        if not self._thread.is_alive():
            # Flush thread drained: stop the completer after the queued work.
            self._completions.put(None)
            self._completer.join(timeout=timeout)
