"""Topics — → org/redisson/RedissonTopic.java (RTopic pub/sub),
RedissonPatternTopic (PSUBSCRIBE glob patterns).

The bus is host-side by design (SURVEY.md §2.4 pub/sub row): listener
callbacks run on the client's delivery executor, and this is the ingest
path that feeds a CountMinSketch (``serve/ingest.py``, BASELINE config 5).

The port's copy of ``redisson_tpu/grid/topics.py``.
"""

from __future__ import annotations

import fnmatch
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional

from redisson_tpu_torch.analysis import witness as _witness
from redisson_tpu_torch.objects.base import CamelCompatMixin


class TopicBus:
    """Per-client pub/sub hub (the PublishSubscribeService analog)."""

    def __init__(self, n_threads: int = 2):
        self._lock = _witness.named(threading.Lock(), "grid.topics.bus")
        self._listeners: dict[str, dict[int, Callable]] = {}
        self._pattern_listeners: dict[str, dict[int, Callable]] = {}
        self._next_id = 1
        self._pool = ThreadPoolExecutor(
            max_workers=n_threads, thread_name_prefix="rtpu-topic"
        )
        # Per-channel FIFO delivery: each channel's messages drain on ONE
        # worker at a time (cross-channel parallelism preserved) — with a
        # free-for-all pool, two mutations' events could be observed out
        # of order by the same listener.
        self._chan_queues: dict[str, list] = {}
        self._chan_active: set[str] = set()
        # Notified whenever a channel finishes its queued deliveries —
        # drain() waits here.
        self._idle_cv = threading.Condition(self._lock)

    def subscribe(self, channel: str, listener: Callable) -> int:
        with self._lock:
            lid = self._next_id
            self._next_id += 1
            self._listeners.setdefault(channel, {})[lid] = listener
            return lid

    def subscribe_pattern(self, pattern: str, listener: Callable) -> int:
        with self._lock:
            lid = self._next_id
            self._next_id += 1
            self._pattern_listeners.setdefault(pattern, {})[lid] = listener
            return lid

    def unsubscribe(self, channel: str, listener_id: Optional[int] = None) -> None:
        with self._lock:
            if listener_id is None:
                self._listeners.pop(channel, None)
            else:
                self._listeners.get(channel, {}).pop(listener_id, None)

    def unsubscribe_pattern(self, pattern: str, listener_id: Optional[int] = None) -> None:
        with self._lock:
            if listener_id is None:
                self._pattern_listeners.pop(pattern, None)
            else:
                self._pattern_listeners.get(pattern, {}).pop(listener_id, None)

    def publish(self, channel: str, message: Any) -> int:
        """Returns the number of receivers (PUBLISH reply semantics).
        Deliveries for one channel run in publish order (FIFO)."""
        with self._lock:
            targets = [
                (None, fn) for fn in self._listeners.get(channel, {}).values()
            ]
            for pat, subs in self._pattern_listeners.items():
                if fnmatch.fnmatchcase(channel, pat):
                    targets.extend((pat, fn) for fn in subs.values())
            if targets:
                self._chan_queues.setdefault(channel, []).append(
                    (targets, message)
                )
                if channel not in self._chan_active:
                    self._chan_active.add(channel)
                    self._pool.submit(self._drain_channel, channel)
        return len(targets)

    def _drain_channel(self, channel: str) -> None:
        while True:
            with self._lock:
                queue = self._chan_queues.get(channel)
                if not queue:
                    self._chan_active.discard(channel)
                    self._chan_queues.pop(channel, None)
                    self._idle_cv.notify_all()
                    return
                targets, message = queue.pop(0)
            for pat, fn in targets:
                if pat is None:
                    self._safe(fn, channel, message)
                else:
                    self._safe_pattern(fn, pat, channel, message)

    @staticmethod
    def _safe(fn, channel, message) -> None:
        try:
            fn(channel, message)
        except Exception:  # listener errors never kill delivery
            import logging

            logging.getLogger(__name__).exception("topic listener failed")

    @staticmethod
    def _safe_pattern(fn, pattern, channel, message) -> None:
        try:
            fn(pattern, channel, message)
        except Exception:
            import logging

            logging.getLogger(__name__).exception("pattern listener failed")

    def count_listeners(self, channel: str) -> int:
        with self._lock:
            n = len(self._listeners.get(channel, {}))
            n += sum(
                len(subs)
                for pat, subs in self._pattern_listeners.items()
                if fnmatch.fnmatchcase(channel, pat)
            )
            return n

    def drain(
        self, timeout: Optional[float] = None, channel: Optional[str] = None
    ) -> bool:
        """Barrier: block until every delivery queued before this call has
        COMPLETED (queues empty + no channel mid-callback).  Exact, not a
        pool rendezvous: the old worker-barrier broke silently at its
        5s timeout when deliveries outlasted it — callers (TopicCmsBridge
        teardown, the config-5 bench) then closed their listeners with
        messages still queued, and those events were silently dropped
        (caught as a NEGATIVE signed CMS estimate error, which a lossless
        pipe can never produce).  ``channel``: wait only for that
        channel's deliveries (listener-teardown scope).  Returns False
        only when ``timeout`` (None = wait indefinitely) elapsed with
        work still pending."""
        import time as _time

        # Not ``pending``: the lock graph resolves a bare call by name,
        # and Stream.pending (which takes the grid store's lock) would
        # stand in for this check.
        def undelivered() -> bool:
            if channel is None:
                return bool(self._chan_queues or self._chan_active)
            return (
                channel in self._chan_queues or channel in self._chan_active
            )

        deadline = None if timeout is None else _time.monotonic() + timeout
        with self._idle_cv:
            while undelivered():
                if deadline is None:
                    self._idle_cv.wait(timeout=1.0)
                else:
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        return False
                    self._idle_cv.wait(timeout=min(1.0, remaining))
        return True

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False)


class Topic(CamelCompatMixin):
    """→ RTopic: add_listener(fn(channel, msg)) + publish."""

    def __init__(self, name: str, client):
        self._name = name
        self._client = client
        self._bus = client._topic_bus

    def get_name(self) -> str:
        return self._name

    def add_listener(self, listener: Callable) -> int:
        return self._bus.subscribe(self._name, listener)

    def remove_listener(self, listener_id: int) -> None:
        self._bus.unsubscribe(self._name, listener_id)

    def remove_all_listeners(self) -> None:
        self._bus.unsubscribe(self._name)

    def publish(self, message: Any) -> int:
        return self._bus.publish(self._name, message)

    def count_subscribers(self) -> int:
        return self._bus.count_listeners(self._name)


class PatternTopic(CamelCompatMixin):
    """→ RPatternTopic: glob-pattern subscription
    (listener(fn(pattern, channel, msg)))."""

    def __init__(self, pattern: str, client):
        self._pattern = pattern
        self._bus = client._topic_bus

    def get_pattern(self) -> str:
        return self._pattern

    def add_listener(self, listener: Callable) -> int:
        return self._bus.subscribe_pattern(self._pattern, listener)

    def remove_listener(self, listener_id: int) -> None:
        self._bus.unsubscribe_pattern(self._pattern, listener_id)


class ShardedTopic(Topic):
    """→ RedissonShardedTopic (SPUBLISH/SSUBSCRIBE): in Redis cluster the
    channel pins to one slot's shard; in-process there is one bus, so the
    semantic difference (no cross-shard broadcast fan-out) is moot — the
    API class exists so reference code ports verbatim."""
