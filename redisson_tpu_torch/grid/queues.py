"""Queues — → org/redisson/RedissonQueue.java (RQueue over Redis lists),
RedissonDeque, RedissonBlockingQueue/Deque (BLPOP parked on the store
condition — the pub/sub-wakeup analog, SURVEY.md §3.3), RedissonDelayedQueue
(timeout ZSET + transfer task → here a timer thread moving due items into
the destination queue), RedissonPriorityQueue (comparator order),
RedissonRingBuffer (capacity-trimmed queue).

The port's copy of ``redisson_tpu/grid/queues.py``.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Any, Iterable, Optional

from redisson_tpu_torch.grid.base import GridObject, journaled


# "No element" marker distinct from a stored None: codecs encode None
# (b'null' / pickle) as a perfectly valid element, so blocking consumers
# must not use None to mean "queue empty" — that would silently destroy
# a popped None and park forever.
_EMPTY = object()


@journaled("offer", "offer_all", "poll", "poll_last_and_offer_first_to",
           "remove", "clear")
class Queue(GridObject):
    KIND = "list"  # queues are lists in Redis; share the kind (RQueue over RList)

    @staticmethod
    def _new_value():
        return []

    def _poll_raw(self, last: bool = False):
        """Pop one ENCODED element, or _EMPTY when none — the primitive
        every blocking consumer builds on (None-element safe)."""
        with self._store.lock:
            e = self._entry(create=False)
            if e is None or not e.value:
                return _EMPTY
            return e.value.pop(-1 if last else 0)

    def offer(self, value: Any) -> bool:
        with self._store.lock:
            self._entry().value.append(self._enc(value))
            self._store.notify()
            return True

    add = offer

    def offer_all(self, values: Iterable[Any]) -> bool:
        with self._store.lock:
            for v in values:
                self._entry().value.append(self._enc(v))
            self._store.notify()
            return True

    def poll(self) -> Any:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None or not e.value:
                return None
            return self._dec(e.value.pop(0))

    def peek(self) -> Any:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None or not e.value:
                return None
            return self._dec(e.value[0])

    def poll_last_and_offer_first_to(self, dest_name: str) -> Any:
        """→ RQueue#pollLastAndOfferFirstTo (RPOPLPUSH)."""
        with self._store.lock:
            # WRONGTYPE-check the destination BEFORE popping, so a kind
            # mismatch cannot lose the element.
            self._store.get_entry(dest_name, self.KIND)
            e = self._entry(create=False)
            if e is None or not e.value:
                return None
            vb = e.value.pop()
            dest = self._client.get_queue(dest_name)
            dest._entry().value.insert(0, vb)
            # The destination is mutated RAW (not through a decorated
            # method): the op journal, once ported, captures it here, as
            # the JAX package does.
            self._store.notify()
            return self._dec(vb)

    def size(self) -> int:
        with self._store.lock:
            e = self._entry(create=False)
            return 0 if e is None else len(e.value)

    def is_empty(self) -> bool:
        return self.size() == 0

    def contains(self, value: Any) -> bool:
        with self._store.lock:
            e = self._entry(create=False)
            return e is not None and self._enc(value) in e.value

    def remove(self, value: Any) -> bool:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return False
            vb = self._enc(value)
            if vb not in e.value:
                return False
            e.value.remove(vb)
            return True

    def clear(self) -> bool:
        return self.delete()

    def read_all(self) -> list:
        with self._store.lock:
            e = self._entry(create=False)
            return [] if e is None else [self._dec(vb) for vb in e.value]

    def __len__(self):
        return self.size()


@journaled("add_first", "add_last", "poll_first", "poll_last")
class Deque(Queue):
    """→ RedissonDeque: double-ended ops."""

    def add_first(self, value: Any) -> None:
        with self._store.lock:
            self._entry().value.insert(0, self._enc(value))
            self._store.notify()

    def add_last(self, value: Any) -> None:
        self.offer(value)

    offer_first = add_first
    offer_last = add_last

    def poll_first(self) -> Any:
        return self.poll()

    def poll_last(self) -> Any:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None or not e.value:
                return None
            return self._dec(e.value.pop())

    def peek_first(self) -> Any:
        return self.peek()

    def peek_last(self) -> Any:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None or not e.value:
                return None
            return self._dec(e.value[-1])


@journaled("poll", "take", "put", "drain_to", "poll_from_any")
class BlockingQueue(Queue):
    """→ RedissonBlockingQueue: poll with timeout parks on the store
    condition until an offer lands (the BLPOP pub/sub-wakeup analog)."""

    def poll(self, timeout_seconds: Optional[float] = None) -> Any:
        if timeout_seconds is None:
            return super().poll()
        deadline = time.monotonic() + timeout_seconds
        with self._store.cond:
            while True:
                vb = self._poll_raw()
                if vb is not _EMPTY:
                    return self._dec(vb)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._store.cond.wait(timeout=remaining)

    def take(self) -> Any:
        with self._store.cond:
            while True:
                vb = self._poll_raw()
                if vb is not _EMPTY:
                    return self._dec(vb)
                self._store.cond.wait(timeout=1.0)

    def put(self, value: Any) -> None:
        self.offer(value)

    def drain_to(self, collection: list, max_elements: Optional[int] = None) -> int:
        with self._store.lock:
            n = 0
            while max_elements is None or n < max_elements:
                vb = self._poll_raw()
                if vb is _EMPTY:
                    break
                collection.append(self._dec(vb))
                n += 1
            return n

    def poll_from_any(self, timeout_seconds: float, *queue_names: str) -> Any:
        """→ RBlockingQueue#pollFromAny (BLPOP over several keys)."""
        queues = [self] + [self._client.get_blocking_queue(n) for n in queue_names]
        deadline = time.monotonic() + timeout_seconds
        with self._store.cond:
            while True:
                for q in queues:
                    vb = q._poll_raw()
                    if vb is not _EMPTY:
                        return q._dec(vb)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._store.cond.wait(timeout=remaining)


@journaled("poll_first", "poll_last")
class BlockingDeque(BlockingQueue, Deque):
    """→ RedissonBlockingDeque."""

    def poll_first(self, timeout_seconds: Optional[float] = None) -> Any:
        return BlockingQueue.poll(self, timeout_seconds)

    def poll_last(self, timeout_seconds: Optional[float] = None) -> Any:
        if timeout_seconds is None:
            return Deque.poll_last(self)
        deadline = time.monotonic() + timeout_seconds
        with self._store.cond:
            while True:
                vb = self._poll_raw(last=True)
                if vb is not _EMPTY:
                    return self._dec(vb)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._store.cond.wait(timeout=remaining)


class DelayedQueue(GridObject):
    """→ org/redisson/RedissonDelayedQueue.java: offer(value, delay) holds
    the value in a timeout structure; a transfer thread moves due items to
    the destination queue (the reference's scheduled transfer task)."""

    KIND = "delayedqueue"

    def __init__(self, name: str, client, destination: Queue):
        super().__init__(name, client)
        # The transfer task appends raw encoded bytes into the
        # destination's backing LIST — only plain list-backed queues
        # qualify (a RingBuffer's dict value or a PriorityQueue's tuple
        # list would crash the timer thread or corrupt the structure).
        if not isinstance(destination, Queue) or not isinstance(
            destination._new_value(), list
        ):
            raise TypeError(
                "DelayedQueue destination must be a plain list-backed "
                f"queue, not {type(destination).__name__}"
            )
        self._dest = destination
        self._timer: Optional[threading.Timer] = None

    @staticmethod
    def _new_value():
        return []  # sorted list of (due_epoch, seq, value bytes)

    _seq = 0

    def offer(self, value: Any, delay_seconds: float) -> None:
        due = time.time() + float(delay_seconds)
        with self._store.lock:
            e = self._entry()
            DelayedQueue._seq += 1
            bisect.insort(e.value, (due, DelayedQueue._seq, self._enc(value)))
            self._schedule_transfer()

    def _schedule_transfer(self) -> None:
        e = self._entry(create=False)
        if e is None or not e.value:
            return
        delay = max(0.0, e.value[0][0] - time.time())
        if self._timer is not None:
            self._timer.cancel()
        self._timer = threading.Timer(delay, self._transfer_due)
        self._timer.daemon = True
        self._timer.start()

    def _transfer_due(self) -> None:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return
            now = time.time()
            while e.value and e.value[0][0] <= now:
                _, _, vb = e.value.pop(0)
                self._dest._entry().value.append(vb)
            self._store.notify()
            if e.value:
                self._schedule_transfer()

    def size(self) -> int:
        with self._store.lock:
            e = self._entry(create=False)
            return 0 if e is None else len(e.value)

    def read_all(self) -> list:
        with self._store.lock:
            e = self._entry(create=False)
            return [] if e is None else [self._dec(vb) for _, _, vb in e.value]

    def remove(self, value: Any) -> bool:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return False
            vb = self._enc(value)
            for i, (_, _, b) in enumerate(e.value):
                if b == vb:
                    e.value.pop(i)
                    return True
            return False


class PriorityQueue(GridObject):
    """→ RedissonPriorityQueue: natural-order poll."""

    KIND = "priorityqueue"

    @staticmethod
    def _new_value():
        return []  # sorted list of (value, value bytes)

    def offer(self, value: Any) -> bool:
        with self._store.lock:
            e = self._entry()
            bisect.insort(e.value, (value, self._enc(value)), key=lambda t: t[0])
            self._store.notify()
            return True

    add = offer

    def _poll_raw(self, last: bool = False):
        with self._store.lock:
            e = self._entry(create=False)
            if e is None or not e.value:
                return _EMPTY
            return e.value.pop(-1 if last else 0)[1]

    def poll(self) -> Any:
        vb = self._poll_raw()
        return None if vb is _EMPTY else self._dec(vb)

    def peek(self) -> Any:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None or not e.value:
                return None
            return self._dec(e.value[0][1])

    def size(self) -> int:
        with self._store.lock:
            e = self._entry(create=False)
            return 0 if e is None else len(e.value)

    def read_all(self) -> list:
        with self._store.lock:
            e = self._entry(create=False)
            return [] if e is None else [v for v, _ in e.value]


@journaled("offer", "offer_all", "poll", "remove",
           "poll_last_and_offer_first_to", "try_set_capacity",
           "set_capacity")
class RingBuffer(Queue):
    """→ RedissonRingBuffer: bounded queue; offers past capacity evict the
    oldest elements.

    The backing value is {"cap", "items"} rather than Queue's plain list,
    so every inherited method that walks the value is overridden below.
    """

    KIND = "ringbuffer"

    @staticmethod
    def _new_value():
        return {"cap": 0, "items": []}

    def offer_all(self, values: Iterable[Any]) -> bool:
        with self._store.lock:
            for v in values:
                self.offer(v)
            return True

    def contains(self, value: Any) -> bool:
        with self._store.lock:
            e = self._entry(create=False)
            return e is not None and self._enc(value) in e.value["items"]

    def remove(self, value: Any) -> bool:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return False
            vb = self._enc(value)
            if vb not in e.value["items"]:
                return False
            e.value["items"].remove(vb)
            return True

    def poll_last_and_offer_first_to(self, dest_name: str) -> Any:
        with self._store.lock:
            self._store.get_entry(dest_name, Queue.KIND)
            e = self._entry(create=False)
            if e is None or not e.value["items"]:
                return None
            vb = e.value["items"].pop()
            self._client.get_queue(dest_name)._entry().value.insert(0, vb)
            self._store.notify()
            return self._dec(vb)

    def try_set_capacity(self, capacity: int) -> bool:
        with self._store.lock:
            e = self._entry()
            if e.value["cap"]:
                return False
            e.value["cap"] = int(capacity)
            return True

    def set_capacity(self, capacity: int) -> None:
        with self._store.lock:
            e = self._entry()
            e.value["cap"] = int(capacity)
            self._trim(e)

    def capacity(self) -> int:
        with self._store.lock:
            e = self._entry(create=False)
            return 0 if e is None else e.value["cap"]

    def remaining_capacity(self) -> int:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return 0
            return max(0, e.value["cap"] - len(e.value["items"]))

    def _trim(self, e) -> None:
        cap = e.value["cap"]
        if cap:
            del e.value["items"][: max(0, len(e.value["items"]) - cap)]

    def offer(self, value: Any) -> bool:
        with self._store.lock:
            e = self._entry()
            if not e.value["cap"]:
                raise RuntimeError("RingBuffer capacity is not set")
            e.value["items"].append(self._enc(value))
            self._trim(e)
            self._store.notify()
            return True

    add = offer

    def poll(self) -> Any:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None or not e.value["items"]:
                return None
            return self._dec(e.value["items"].pop(0))

    def peek(self) -> Any:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None or not e.value["items"]:
                return None
            return self._dec(e.value["items"][0])

    def size(self) -> int:
        with self._store.lock:
            e = self._entry(create=False)
            return 0 if e is None else len(e.value["items"])

    def read_all(self) -> list:
        with self._store.lock:
            e = self._entry(create=False)
            return [] if e is None else [self._dec(vb) for vb in e.value["items"]]


class PriorityBlockingQueue(PriorityQueue):
    """→ RedissonPriorityBlockingQueue: natural-order poll with blocking
    take/poll(timeout) parked on the store condition."""

    KIND = "priorityqueue"

    def poll(self, timeout_seconds: Optional[float] = None) -> Any:
        if timeout_seconds is None:
            return super().poll()
        deadline = time.monotonic() + timeout_seconds
        with self._store.cond:
            while True:
                vb = self._poll_raw()
                if vb is not _EMPTY:
                    return self._dec(vb)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._store.cond.wait(timeout=remaining)

    def take(self) -> Any:
        with self._store.cond:
            while True:
                vb = self._poll_raw()
                if vb is not _EMPTY:
                    return self._dec(vb)
                self._store.cond.wait(timeout=1.0)

    def put(self, value: Any) -> None:
        self.offer(value)


class PriorityDeque(PriorityQueue):
    """→ RedissonPriorityDeque: priority order with access to BOTH ends
    (pollFirst = smallest, pollLast = largest)."""

    KIND = "priorityqueue"

    def poll_first(self) -> Any:
        return self.poll()

    def poll_last(self) -> Any:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None or not e.value:
                return None
            return self._dec(e.value.pop()[1])

    def peek_first(self) -> Any:
        return self.peek()

    def peek_last(self) -> Any:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None or not e.value:
                return None
            return self._dec(e.value[-1][1])

class _TransferHandle(bytes):
    """bytes subclass used only for its guaranteed-fresh identity (the
    constructor can never return an interned builtin-bytes singleton)."""

    __slots__ = ()


@journaled("transfer", "try_transfer", "poll", "take", "drain_to")
class TransferQueue(BlockingQueue):
    """→ RTransferQueue (java.util.concurrent.TransferQueue semantics):
    ``transfer`` blocks until a consumer takes the element; plain
    offer/poll still behave like a queue.

    Elements are PLAIN encoded bytes in the same list shape as every
    other queue (KIND "list" — one namespace with RQueue/RList, so
    RPOPLPUSH/poll_from_any/RESP LPOP all interoperate).  A pending
    transfer is tracked by the IDENTITY of its bytes object: the
    transferer waits until that exact object leaves the queue's CURRENT
    backing list — any consumer path that removes it (poll, take, LPOP,
    a move to another queue, remove(), even DEL of the whole key)
    completes the handoff."""

    def _transfer_locked(self, value: Any, deadline: Optional[float]) -> bool:
        """Caller holds the store cond.  Appends the offer, waits for a
        consumer to take it; withdraws on timeout."""
        vb = self._enc(value)
        if isinstance(vb, str):
            vb = vb.encode()
        # Identity tracking needs a DISTINCT object per transfer call:
        # ByteArrayCodec.encode returns its input unchanged, and CPython
        # interns empty/1-byte bytes (bytes(bytearray(b'a')) is b'a'), so
        # any plain-bytes copy can still alias two concurrent transfers
        # of the same value under one identity.  A bytes-subclass
        # instance is never the cached singleton, behaves as bytes
        # everywhere else, and decodes identically for consumers.
        vb = _TransferHandle(vb)
        self._entry().value.append(vb)
        self._store.cond.notify_all()
        while True:
            # Re-resolve the entry EVERY iteration: clear()/DEL swaps the
            # backing list, and a stale reference would strand this wait
            # forever on an orphaned list no consumer can reach.
            e = self._entry(create=False)
            if e is None or not any(s is vb for s in e.value):
                return True  # consumed (or the key itself was consumed)
            remaining = (
                None if deadline is None else deadline - time.monotonic()
            )
            if remaining is not None and remaining <= 0:
                for i, s in enumerate(e.value):
                    if s is vb:  # identity, not equality: duplicates of
                        del e.value[i]  # the same VALUE must survive
                        return False
                return True  # taken between checks
            self._store.cond.wait(
                timeout=1.0 if remaining is None else min(1.0, remaining)
            )

    def transfer(self, value: Any, timeout_seconds: Optional[float] = None) -> bool:
        """Blocks until a consumer removes the element; False on timeout
        (the element is withdrawn, tryTransfer-with-timeout semantics)."""
        deadline = (
            None
            if timeout_seconds is None
            else time.monotonic() + timeout_seconds
        )
        with self._store.cond:
            return self._transfer_locked(value, deadline)

    def _waiting_count(self, delta: int = 0) -> int:
        """Waiting-consumer count shared across every handle of this queue
        (kept on the store, keyed by name — handle-local state would make
        hasWaitingConsumer lie between handles)."""
        reg = self._store.__dict__.setdefault("_tq_waiting", {})
        reg[self._name] = reg.get(self._name, 0) + delta
        return reg[self._name]

    def try_transfer(self, value: Any) -> bool:
        """Immediate handoff: succeeds only if a consumer is waiting AT
        the moment of the call.  The waiting-check and the offer happen
        under ONE cond hold (no check-then-act gap); the short grace wait
        only covers the woken consumer's re-acquisition of the lock."""
        with self._store.cond:
            if self._waiting_count() <= 0:
                return False
            return self._transfer_locked(
                value, time.monotonic() + 1.0
            )

    def poll(self, timeout_seconds: Optional[float] = None) -> Any:
        deadline = (
            None
            if timeout_seconds is None
            else time.monotonic() + timeout_seconds
        )
        with self._store.cond:
            self._waiting_count(+1)
            try:
                while True:
                    vb = self._poll_raw()
                    if vb is not _EMPTY:
                        self._store.cond.notify_all()  # wake transferers
                        return self._dec(vb)
                    if deadline is None:
                        return None
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    self._store.cond.wait(timeout=min(1.0, remaining))
            finally:
                self._waiting_count(-1)

    def take(self) -> Any:
        with self._store.cond:
            self._waiting_count(+1)
            try:
                while True:
                    vb = self._poll_raw()
                    if vb is not _EMPTY:
                        self._store.cond.notify_all()
                        return self._dec(vb)
                    self._store.cond.wait(timeout=1.0)
            finally:
                self._waiting_count(-1)

    def drain_to(self, collection: list, max_elements: Optional[int] = None) -> int:
        n = super().drain_to(collection, max_elements)
        if n:
            with self._store.cond:
                self._store.cond.notify_all()  # wake transferers
        return n

    def has_waiting_consumer(self) -> bool:
        with self._store.lock:
            return self._waiting_count() > 0

    def remove(self, value: Any) -> bool:
        """Removing a pending-transfer element counts as consuming it —
        the blocked transferer resolves True."""
        with self._store.cond:
            ok = super().remove(value)
            if ok:
                self._store.cond.notify_all()
            return ok
