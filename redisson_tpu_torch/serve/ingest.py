"""Streaming ingest: RTopic → CountMinSketch (BASELINE config 5).

The reference's ingest shape is a pub/sub listener feeding application
code (→ org/redisson/RedissonTopic.java listener delivery, SURVEY.md
§3.5).  Here the listener feeds the device coalescer: messages buffer
into batches and flush to ``cms.add_all_async`` on size or deadline, so
a 100M-event stream becomes a steady sequence of large device batches —
the heavy-hitter pipeline of benchmark config 5.  The port's copy of
``redisson_tpu/serve/ingest.py``: the same batching, so a bridge-fed
sketch holds the same counts as the JAX package's.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np



class TopicCmsBridge:
    """Subscribes to a topic and streams every message into a
    CountMinSketch.  Messages are the keys; an optional ``weight_fn``
    maps a message to its count (default 1).

    The flush path is asynchronous: batches ride ``add_all_async`` and a
    small in-flight window is collected in arrival order, so ingest
    throughput tracks the engine, not one blocking round trip.
    """

    def __init__(
        self,
        client,
        topic_name: str,
        cms_name: str,
        *,
        batch_size: int = 8192,
        flush_interval_s: float = 0.005,
        weight_fn=None,
        max_inflight: int = 8,
        max_launch_events: int = 1 << 18,
    ):
        self._client = client
        self._cms = client.get_count_min_sketch(cms_name)
        self._topic = client.get_topic(topic_name)
        self._batch_size = batch_size
        self._interval = flush_interval_s
        self._weight_fn = weight_fn
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._active = 0  # take-to-dispatch windows in progress
        self._buf: list = []
        self._weights: Optional[list] = [] if weight_fn else None
        # Array messages coalesce here up to max_launch_events before one
        # device launch: per-launch cost on the bench link is latency-
        # dominated, so a 32k-event message per launch caps throughput at
        # ~launch-rate; 8 messages per launch is ~8x in slow phases.
        # Entries are (array, weights|None) pairs; only SAME-dtype
        # messages coalesce (concatenating mixed dtypes would upcast and
        # change codec encodings — the count_min_sketch offer hazard).
        self._abuf: list = []
        self._abuf_n = 0
        self._last_aflush = time.monotonic()
        self._max_launch_events = max_launch_events
        self._inflight: list = []
        self._max_inflight = max_inflight
        self._events = 0
        self._closed = False
        self._last_flush = time.monotonic()
        self._listener_id = self._topic.add_listener(self._on_message)
        self._timer = threading.Thread(
            target=self._deadline_loop, name="rtpu-cms-ingest", daemon=True
        )
        self._timer.start()

    # -- listener path -----------------------------------------------------

    def _on_message(self, channel, message) -> None:
        """One message = one event, or — the high-throughput shape — an
        ndarray of events batched at the producer (the Kafka-style
        pattern; per-event Python dispatch tops out ~200k events/s).
        Array messages coalesce into up-to-``max_launch_events`` device
        launches (per-launch cost dominates on a latency-bound link);
        ``weight_fn`` receives each whole array and may return per-event
        weights."""
        with self._lock:
            if self._closed:
                return
            self._active += 1
        try:
            if isinstance(message, np.ndarray):
                w = self._weight_fn(message) if self._weight_fn else None
                pre = post = None
                with self._lock:
                    self._events += len(message)
                    if self._abuf and self._abuf[0][0].dtype != message.dtype:
                        pre = self._take_arrays_locked()  # dtype boundary
                    self._abuf.append((message, w))
                    self._abuf_n += len(message)
                    if self._abuf_n >= self._max_launch_events:
                        post = self._take_arrays_locked()
                if pre is not None:
                    self._dispatch(*self._concat_arrays(pre))
                if post is not None:
                    self._dispatch(*self._concat_arrays(post))
                return
            flush_now = None
            with self._lock:
                self._buf.append(message)
                if self._weights is not None:
                    self._weights.append(self._weight_fn(message))
                self._events += 1
                if len(self._buf) >= self._batch_size:
                    flush_now = self._take_locked()
            if flush_now is not None:
                self._dispatch(*flush_now)
        finally:
            with self._lock:
                self._active -= 1
                if self._active == 0:
                    self._idle.notify_all()

    def _take_locked(self):
        buf, self._buf = self._buf, []
        if self._weights is not None:
            w, self._weights = self._weights, []
        else:
            w = None
        self._last_flush = time.monotonic()
        return buf, w

    def _take_arrays_locked(self):
        """Detach the coalesced (array, weights) pairs — concatenation
        happens OUTSIDE the lock (multi-MB copies must not serialize
        listener delivery)."""
        pairs, self._abuf = self._abuf, []
        self._abuf_n = 0
        self._last_aflush = time.monotonic()
        return (pairs,)

    @staticmethod
    def _concat_arrays(taken):
        (pairs,) = taken
        arrays = [a for a, _ in pairs]
        buf = arrays[0] if len(arrays) == 1 else np.concatenate(arrays)
        ws = [w for _, w in pairs]
        if all(w is None for w in ws):
            return buf, None
        # Mixed per-message weights: None means "count 1 per event";
        # scalars broadcast — normalize each to a per-event array so the
        # concatenation stays aligned with its events.
        full = []
        for a, w in pairs:
            if w is None:
                full.append(np.ones(len(a), np.int64))
            else:
                w = np.asarray(w)
                full.append(
                    np.full(len(a), int(w), np.int64) if w.ndim == 0 else w
                )
        return buf, np.concatenate(full)

    def _dispatch(self, buf, weights) -> None:
        fut = self._cms.add_all_async(buf, weights)
        with self._lock:
            self._inflight.append(fut)
            drain = (
                self._inflight[: -self._max_inflight]
                if len(self._inflight) > self._max_inflight
                else []
            )
            self._inflight = self._inflight[len(drain):]
        if drain:
            # One mailbox flush for the whole drained window (each host
            # fetch costs a link round trip — the slow-phase killer).
            self._client.collect(drain)

    def _deadline_loop(self) -> None:
        while True:
            time.sleep(self._interval)
            with self._lock:
                if self._closed:
                    return
                now = time.monotonic()
                pending = (
                    self._take_locked()
                    if (
                        self._buf
                        and now - self._last_flush >= self._interval
                    )
                    else None
                )
                # Separate staleness clock: scalar-path flushes must not
                # keep resetting the array buffer's deadline (starvation).
                apending = (
                    self._take_arrays_locked()
                    if (
                        self._abuf
                        and now - self._last_aflush >= self._interval
                    )
                    else None
                )
                if pending is None and apending is None:
                    continue
                # Counted as active from the take to the dispatch: a
                # flush() must not sample _inflight between the two, or
                # it returns with these events neither buffered nor in
                # flight (the JAX package's bridge has that window).
                self._active += 1
            try:
                if pending is not None:
                    self._dispatch(*pending)
                if apending is not None:
                    self._dispatch(*self._concat_arrays(apending))
            finally:
                with self._lock:
                    self._active -= 1
                    if self._active == 0:
                        self._idle.notify_all()

    # -- control -----------------------------------------------------------

    def flush(self) -> None:
        """Drain the buffer and wait for every in-flight batch — including
        listener callbacks still executing on bus workers (their futures
        must land in ``_inflight`` before we sample it)."""
        while True:
            # Every take-to-dispatch window (listener calls and the
            # deadline thread's flushes) is counted in _active: once it
            # is 0 under the lock, each taken batch already sits in
            # _inflight.
            with self._idle:
                while self._active > 0:
                    self._idle.wait(timeout=5.0)
                pending = self._take_locked() if self._buf else None
                apending = self._take_arrays_locked() if self._abuf else None
                batch, self._inflight = self._inflight, []
            if pending is not None:
                self._dispatch(*pending)
            if apending is not None:
                self._dispatch(*self._concat_arrays(apending))
            if batch:
                self._client.collect(batch)  # one flush, not N fetches
            elif pending is None and apending is None:
                return

    @property
    def events_ingested(self) -> int:
        return self._events

    def close(self) -> None:
        # Ordering: delist first (new publishes no longer target this
        # bridge), then wait out the CHANNEL's already-queued deliveries
        # (their target lists were snapshotted at publish, so
        # remove_listener does not cancel them — the old close dropped
        # exactly those), then flush buffered + in-flight batches, and
        # only then freeze.
        self._topic.remove_listener(self._listener_id)
        bus = getattr(self._topic, "_bus", None)
        if bus is not None:
            bus.drain(channel=self._topic.get_name())
        self.flush()
        with self._lock:
            self._closed = True
