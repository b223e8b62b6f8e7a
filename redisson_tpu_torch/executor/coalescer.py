"""BatchCoalescer — cross-call op coalescing (the CommandBatchService role).

Counterpart of the core of ``redisson_tpu/executor/coalescer.py``.  Every
async sketch op lands in a multi-producer queue; one flush thread drains
it into per-(pool, opcode, k) segments and dispatches each segment as ONE
multi-tenant device batch.

Flush policy: a segment flushes when it reaches ``max_batch`` ops, when
its oldest op is ``batch_window_us`` old, or at once when a caller
blocks on a result (``flush_hint``).  Consecutive same-key segments merge
at pop time, so a backlog collapses into fewer, larger launches.
``max_inflight`` bounds dispatched-but-uncollected segments; a completer
thread fetches results (several pending launches at once through the
executor's result mailbox) and resolves the futures.  Producers block
once ``max_queued_ops`` ops are queued ahead of the flush thread.

Ordering: segments of one pool flush FIFO, so a read submitted after a
write observes it.

Not here yet: deadline shedding and admission control, dispatch retries
and circuit breakers, adaptive windows, chaos points and tracing spans.
A dispatch that raises fails its segment's futures.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Optional

import numpy as np
import torch

from redisson_tpu_torch.executor.failures import (
    DispatchTimeoutError,
    KernelExecutionError,
)


def _op_label(key) -> str:
    """Segment keys are tuples whose first element names the op path."""
    if isinstance(key, tuple) and key and isinstance(key[0], str):
        return key[0]
    return "op"


class _Segment:
    __slots__ = ("key", "pool_key", "dispatch", "chunks", "metas", "futures",
                 "nops", "born")

    def __init__(self, key, pool_key, dispatch):
        self.key = key
        self.pool_key = pool_key
        self.dispatch = dispatch  # fn(cols[, metas]) -> LazyResult; None = barrier
        self.chunks: list[tuple] = []  # per-submit tuples of op arrays
        # Per-submit run-length metadata, parallel to chunks (None for
        # plain segments): values constant across one submit travel once.
        self.metas: Optional[list] = None
        self.futures: list[tuple] = []  # (future, start, n)
        self.nops = 0
        self.born = time.monotonic()


# Default bound of a blocking result wait (the JAX package's default).
_RESULT_TIMEOUT_S = 120.0


class HintedFuture:
    """Future adapter: a blocking ``.result()`` nudges the coalescer to
    flush at once instead of waiting out the batch window."""

    def __init__(self, fut: Future, coalescer: "BatchCoalescer"):
        self._fut = fut
        self._c = coalescer

    def result(self, timeout: Optional[float] = None):
        if timeout is None:
            timeout = _RESULT_TIMEOUT_S
        if not self._fut.done():
            self._c.flush_hint()
        try:
            return self._fut.result(timeout)
        except TimeoutError as e:
            raise DispatchTimeoutError(f"result not ready within {timeout}s") from e

    def get(self):
        return self.result()

    def done(self) -> bool:
        return self._fut.done()


class BatchCoalescer:
    def __init__(self, *, batch_window_us: int, max_batch: int,
                 max_inflight: int = 8, max_queued_ops: int = 0,
                 group_collect: Optional[Callable] = None):
        self.window_s = batch_window_us / 1e6
        self.max_batch = max_batch
        self.max_queued_ops = max_queued_ops if max_queued_ops > 0 else 8 * max_batch
        self._queued_ops = 0
        self._launch_slots = threading.BoundedSemaphore(max(1, max_inflight))
        # Queued segments in flush order.  A segment stays joinable while
        # queued and still its pool's most recent (``_pool_tail``): per-pool
        # arrival order with cross-pool coalescing in between.
        self._order: deque[_Segment] = deque()
        self._open: dict = {}
        self._pool_tail: dict = {}
        self._hurry = False  # a caller is blocking: drain the queue now
        self._lock = threading.Lock()
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
               pool_key=None, meta=None) -> Future:
        """Queue ``nops`` ops (column arrays in ``arrays``) for the segment
        ``key``; returns a Future of the per-op result slice.  With
        ``meta``, the segment's dispatch is called as
        ``dispatch(cols, metas)`` with ``metas`` the (nops, meta) of each
        chunk in order; all submits of one key agree on using it."""
        if pool_key is None:
            pool_key = key
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("coalescer is shut down")

            def _full() -> bool:
                return (
                    self._queued_ops > 0
                    and self._queued_ops + nops > self.max_queued_ops
                )

            if _full():
                ticket = object()
                self._admit_q.append(ticket)
                try:
                    while not self._closed and (
                        self._admit_q[0] is not ticket or _full()
                    ):
                        self._wake.notify()
                        self._admit.wait(timeout=1.0)
                finally:
                    self._admit_q.remove(ticket)
                    self._admit.notify_all()
            if self._closed:
                raise RuntimeError("coalescer is shut down")
            seg = self._open.get(key)
            if (
                seg is None
                or self._pool_tail.get(seg.pool_key) is not seg
                or seg.nops + nops > self.max_batch
            ):
                seg = _Segment(key, pool_key, dispatch)
                if meta is not None:
                    seg.metas = []
                self._open[key] = seg
                self._pool_tail[pool_key] = seg
                self._order.append(seg)
                self._wake.notify()
            seg.chunks.append(arrays)
            if meta is not None:
                seg.metas.append((nops, meta))
            seg.futures.append((fut, seg.nops, nops))
            seg.nops += nops
            self._queued_ops += nops
            if seg.nops >= self.max_batch:
                self._wake.notify()
        return fut

    def flush_hint(self) -> None:
        """A caller is about to block on a Future — flush eagerly."""
        with self._lock:
            self._hurry = True
            self._wake.notify()

    # -- flush thread ------------------------------------------------------

    def _detach_locked(self, seg: _Segment) -> None:
        if self._open.get(seg.key) is seg:
            del self._open[seg.key]
        if self._pool_tail.get(seg.pool_key) is seg:
            del self._pool_tail[seg.pool_key]
        if seg.nops:
            self._queued_ops -= seg.nops
            self._admit.notify_all()

    def _pop_locked(self) -> Optional[_Segment]:
        """The next segment ready to flush (merged with the same-key
        segments queued right behind it), or None when the head is young
        and small and nobody is waiting on it."""
        seg = self._order[0]
        if not (
            seg.dispatch is None
            or seg.nops >= self.max_batch
            or self._closed
            or self._hurry
            or time.monotonic() - seg.born >= self.window_s
        ):
            return None
        self._order.popleft()
        self._detach_locked(seg)
        if seg.dispatch is not None:
            # Fold the consecutive run of same-key segments into one
            # launch; a different key is an order fence.
            while self._order:
                nxt = self._order[0]
                if nxt.key != seg.key or seg.nops + nxt.nops > self.max_batch:
                    break
                self._order.popleft()
                self._detach_locked(nxt)
                seg.chunks.extend(nxt.chunks)
                if seg.metas is not None:
                    seg.metas.extend(nxt.metas)
                for fut, start, n in nxt.futures:
                    seg.futures.append((fut, seg.nops + start, n))
                seg.nops += nxt.nops
        if not self._order:
            self._hurry = False
        self._inflight += 1
        return seg

    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._order and not self._closed:
                    self._hurry = False
                    self._wake.wait(timeout=0.05)
                if self._closed and not self._order:
                    return
                seg = self._pop_locked()
                if seg is None:
                    wait = self._order[0].born + self.window_s - time.monotonic()
                    self._wake.wait(timeout=min(max(wait, 0.0005), 0.05))
                    continue
            if seg.dispatch is None:  # drain barrier
                with self._lock:
                    self._inflight -= 1
                for fut, _, _ in seg.futures:
                    fut.set_result(None)
                continue
            self._launch_slots.acquire()
            self._flush(seg)

    def _flush(self, seg: _Segment) -> None:
        t0 = time.monotonic()
        try:
            cols = [
                c[0] if len(c) == 1 else np.concatenate(c)
                for c in zip(*seg.chunks)
            ]
            with torch.profiler.record_function("rtpu:dispatch:" + _op_label(seg.key)):
                if seg.metas is not None:
                    lazy = seg.dispatch(cols, seg.metas)
                else:
                    lazy = seg.dispatch(cols)
        except Exception as e:
            self._launch_slots.release()
            self._fail(seg, e)
            return
        finally:
            with self._lock:
                self._inflight -= 1
        self._completions.put((seg, lazy, t0))

    @staticmethod
    def _fail(seg: _Segment, e: BaseException) -> None:
        for fut, start, n in seg.futures:
            if fut.set_running_or_notify_cancel():
                fut.set_exception(KernelExecutionError(seg.key, start, n, seg.nops, e))

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
            if len(group) > 1:
                try:
                    self._group_collect([lazy for _, lazy, _ in group])
                except Exception:
                    pass  # each item's own .result() below surfaces it
            for seg, lazy, _t0 in group:
                try:
                    res = lazy.result()
                except Exception as e:
                    self._fail(seg, e)
                else:
                    for fut, start, n in seg.futures:
                        if fut.set_running_or_notify_cancel():
                            fut.set_result(
                                None if res is None else res[start : start + n]
                            )
                finally:
                    self._launch_slots.release()

    def drain(self, timeout: float = 30.0) -> None:
        """Barrier: block until every segment submitted before this call
        has dispatched (direct state reads observe all prior ops)."""
        fut: Future = Future()
        with self._lock:
            if self._closed or (not self._order and self._inflight == 0):
                return
            barrier = object()  # unique key: never merged into
            seg = _Segment(barrier, barrier, None)
            seg.futures.append((fut, 0, 0))
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
