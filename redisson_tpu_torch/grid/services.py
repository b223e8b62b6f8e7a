"""Coordination services — the reference's service layer (SURVEY.md §2.3
services row):

- ``ExecutorService`` → org/redisson/executor/ (RExecutorService +
  RScheduledExecutorService): tasks serialize into a grid queue; worker
  threads (the RedissonNode analog) poll and execute; futures resolve
  through a per-task response slot.
- ``RemoteService`` → org/redisson/remote/ (RRemoteService): method
  invocations ride a request queue to a registered implementation;
  responses return on per-invocation channels with ack semantics.
- ``Transaction`` → org/redisson/transaction/ (RTransaction): optimistic
  — reads collect a validation set, writes buffer in an operation log,
  commit validates + applies atomically under the store lock.
- ``ScriptService`` → RScript/RFunction: named procedures executed
  ATOMICALLY against the grid (the Lua-atomicity analog; procedures are
  Python callables — there is no Lua VM here, by design).
- ``LiveObjectService`` → org/redisson/liveobject/: attribute-mapped
  proxies whose fields live in an RMap.
- ``MapReduce`` → org/redisson/mapreduce/: mapper/reducer over map
  entries fanned out on the executor service's workers.

The port's copy of ``redisson_tpu/grid/services.py``.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Callable, Optional

from redisson_tpu_torch.objects.base import CamelCompatMixin

_MISSING = object()


class TaskFuture:
    """RExecutorFuture analog."""

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None
        self._cancelled = False

    def _resolve(self, value=None, error=None):
        self._value = value
        self._error = error
        self._event.set()

    def cancel(self) -> bool:
        if self._event.is_set():
            return False
        self._cancelled = True
        self._event.set()
        return True

    def cancelled(self) -> bool:
        return self._cancelled

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("task result not ready")
        if self._cancelled:
            raise RuntimeError("task was cancelled")
        if self._error is not None:
            raise self._error
        return self._value

    get = result


class ExecutorService(CamelCompatMixin):
    """→ RExecutorService / RScheduledExecutorService.

    Tasks are (callable, args, kwargs) tuples on a named in-process queue;
    ``register_workers(n)`` is the RedissonNode analog — without workers,
    tasks queue but never run (exactly the reference's model where a
    separate worker JVM polls the task queue)."""

    def __init__(self, name: str, client):
        self._name = name
        self._client = client
        self._tasks: "list[tuple]" = []
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._workers: list[threading.Thread] = []
        self._futures: dict[str, TaskFuture] = {}
        self._shutdown = False
        self._timer: Optional[threading.Thread] = None
        self._scheduled: list[tuple] = []  # (fire_at, period|None, task)
        self._periodic: set[str] = set()  # futures stay open for cancel()

    def get_name(self) -> str:
        return self._name

    # -- submission (→ RExecutorService#submit) -----------------------------

    def submit(self, fn: Callable, *args, **kwargs) -> TaskFuture:
        fut = TaskFuture()
        task_id = uuid.uuid4().hex
        with self._cond:
            if self._shutdown:
                raise RuntimeError("executor service is shut down")
            self._futures[task_id] = fut
            self._tasks.append((task_id, fn, args, kwargs))
            self._cond.notify()
        return fut

    def execute(self, fn: Callable, *args, **kwargs) -> None:
        """→ RExecutorService#execute (fire-and-forget)."""
        self.submit(fn, *args, **kwargs)

    # -- scheduling (→ RScheduledExecutorService) ---------------------------

    def schedule(self, fn: Callable, delay_seconds: float, *args, **kwargs) -> TaskFuture:
        fut = TaskFuture()
        task_id = uuid.uuid4().hex
        with self._cond:
            if self._shutdown:
                raise RuntimeError("executor service is shut down")
            self._futures[task_id] = fut
            self._scheduled.append(
                (time.monotonic() + delay_seconds, None, (task_id, fn, args, kwargs))
            )
            self._ensure_timer()
        return fut

    def schedule_at_fixed_rate(self, fn: Callable, initial_delay_seconds: float,
                               period_seconds: float, *args, **kwargs) -> TaskFuture:
        """Returns a future usable only for cancel() (like the reference's
        scheduled future for periodic tasks)."""
        fut = TaskFuture()
        task_id = uuid.uuid4().hex
        with self._cond:
            if self._shutdown:
                raise RuntimeError("executor service is shut down")
            self._futures[task_id] = fut
            self._periodic.add(task_id)
            self._scheduled.append(
                (
                    time.monotonic() + initial_delay_seconds,
                    period_seconds,
                    (task_id, fn, args, kwargs),
                )
            )
            self._ensure_timer()
        return fut

    def schedule_cron(self, fn: Callable, cron: str, *args, **kwargs) -> TaskFuture:
        """→ RScheduledExecutorService#schedule(cron) with the upstream
        CronExpression grammar (Quartz 6-field with seconds, or classic
        5-field).  Periodic: the returned future exists for cancel()."""
        from redisson_tpu_torch.grid.cron import CronExpression

        expr = CronExpression(cron)
        fut = TaskFuture()
        task_id = uuid.uuid4().hex
        with self._cond:
            if self._shutdown:
                raise RuntimeError("executor service is shut down")
            self._futures[task_id] = fut
            self._periodic.add(task_id)
            delay = expr.next_after(time.time()) - time.time()
            self._scheduled.append(
                (time.monotonic() + delay, expr, (task_id, fn, args, kwargs))
            )
            self._ensure_timer()
        return fut

    def _ensure_timer(self) -> None:
        if self._timer is None or not self._timer.is_alive():
            self._timer = threading.Thread(
                target=self._timer_loop, name="rtpu-exec-timer", daemon=True
            )
            self._timer.start()

    def _timer_loop(self) -> None:
        while True:
            with self._cond:
                if self._shutdown:
                    return
                now = time.monotonic()
                due = [s for s in self._scheduled if s[0] <= now]
                self._scheduled = [s for s in self._scheduled if s[0] > now]
                for fire_at, period, task in due:
                    fut = self._futures.get(task[0])
                    if fut is not None and fut.cancelled():
                        # Cancelled periodic/cron tasks leave the tables
                        # for good — no re-arm, no future leak.
                        self._futures.pop(task[0], None)
                        self._periodic.discard(task[0])
                        continue
                    self._tasks.append(task)
                    if period is not None:
                        from redisson_tpu_torch.grid.cron import CronExpression

                        if isinstance(period, CronExpression):
                            # Cron re-arm: wall-clock next fire mapped
                            # onto the monotonic timer.
                            delay = period.next_after(time.time()) - time.time()
                            self._scheduled.append((now + delay, period, task))
                        else:
                            self._scheduled.append(
                                (fire_at + period, period, task)
                            )
                if due:
                    self._cond.notify_all()
            time.sleep(0.02)

    # -- workers (→ RedissonNode / TasksRunnerService) ----------------------

    def register_workers(self, n: int = 1) -> None:
        for _ in range(n):
            t = threading.Thread(
                target=self._worker_loop, name=f"rtpu-exec-{self._name}",
                daemon=True,
            )
            self._workers.append(t)
            t.start()

    def _worker_loop(self) -> None:
        while True:
            with self._cond:
                while not self._tasks and not self._shutdown:
                    self._cond.wait(timeout=0.5)
                if self._shutdown and not self._tasks:
                    return
                task_id, fn, args, kwargs = self._tasks.pop(0)
            fut = self._futures.get(task_id)
            if fut is not None and fut.cancelled():
                with self._cond:
                    # Purge EVERY trace of the task: dropping only the
                    # future would let the timer loop re-arm the periodic
                    # entry (its cancelled-check reads _futures) — an
                    # uncancellable task running forever.
                    self._futures.pop(task_id, None)
                    self._periodic.discard(task_id)
                    self._scheduled = [
                        ent for ent in self._scheduled if ent[2][0] != task_id
                    ]
                continue
            # Periodic tasks keep their future OPEN (it exists for
            # cancel(), like the reference's scheduled future).
            resolve = fut is not None and task_id not in self._periodic
            try:
                value = fn(*args, **kwargs)
                if resolve and not fut.done():
                    fut._resolve(value=value)
            except BaseException as e:  # task errors resolve the future
                if resolve and not fut.done():
                    fut._resolve(error=e)
            finally:
                if resolve:  # one-shot futures leave the table once run
                    self._futures.pop(task_id, None)

    # -- lifecycle -----------------------------------------------------------

    def get_task_count(self) -> int:
        with self._lock:
            return len(self._tasks)

    def shutdown(self) -> None:
        with self._cond:
            self._shutdown = True
            # Scheduled-but-not-yet-due tasks will never fire: resolve
            # their futures with a rejection instead of leaving callers
            # blocked forever.
            for _fire_at, _period, task in self._scheduled:
                fut = self._futures.pop(task[0], None)
                if fut is not None and not fut.done():
                    fut._resolve(
                        error=RuntimeError("executor service shut down")
                    )
            self._scheduled.clear()
            self._cond.notify_all()

    def is_shutdown(self) -> bool:
        return self._shutdown


class RemoteService(CamelCompatMixin):
    """→ RRemoteService: request-queue RPC between a registered
    implementation and proxies (get())."""

    def __init__(self, name: str, client):
        self._name = name
        self._client = client
        self._impls: dict[str, tuple] = {}  # iface -> (impl, executor)
        self._lock = threading.Lock()

    def register(self, iface: str, impl: Any, workers: int = 1) -> None:
        """→ RRemoteService#register(Class, T, workers).  Re-registering
        an iface replaces the implementation and shuts down the previous
        registration's worker pool (it would otherwise leak its threads
        for the process lifetime)."""
        ex = ExecutorService(f"{self._name}:{iface}:workers", self._client)
        ex.register_workers(workers)
        with self._lock:
            prev = self._impls.get(iface)
            self._impls[iface] = (impl, ex)
        if prev is not None:
            prev[1].shutdown()

    def deregister(self, iface: str) -> None:
        with self._lock:
            got = self._impls.pop(iface, None)
        if got is not None:
            got[1].shutdown()

    def get(self, iface: str, timeout_seconds: float = 30.0,
            ack_timeout_seconds: float = 1.0):
        """→ RRemoteService#get(Class, executionTimeout, ackTimeout): sync
        proxy.  A worker must ACK pickup of the invocation within
        ``ack_timeout_seconds`` (the reference's ack message on the
        per-invocation response queue) or the call fails with
        RemoteServiceAckTimeoutException WITHOUT waiting the full
        execution timeout — the no-live-worker fast-fail."""
        service = self

        class _Proxy(CamelCompatMixin):
            def __getattr__(self, method):
                def call(*args, **kwargs):
                    with service._lock:
                        got = service._impls.get(iface)
                    if got is None:
                        raise RuntimeError(
                            f"no workers registered for {iface!r}"
                        )
                    impl, ex = got
                    ack = threading.Event()
                    target = getattr(impl, method)
                    # ack vs timeout is decided EXACTLY once under this
                    # lock: either the worker acks first (we await the
                    # result) or the caller times out first (the worker
                    # then refuses to start, so the invocation NEVER runs
                    # after an ack-timeout was reported — no invisible
                    # side effects).
                    gate_lock = threading.Lock()
                    state = {"v": "pending"}

                    def acked_call():
                        with gate_lock:
                            if state["v"] == "timedout":
                                return None  # late pickup: refuse to run
                            state["v"] = "acked"
                            ack.set()
                        return target(*args, **kwargs)

                    fut = ex.submit(acked_call)
                    if not ack.wait(ack_timeout_seconds):
                        with gate_lock:
                            if state["v"] == "pending":
                                state["v"] = "timedout"
                                fut.cancel()
                                raise RemoteServiceAckTimeoutException(
                                    f"no worker acked {iface}.{method} "
                                    f"within {ack_timeout_seconds}s"
                                )
                        # The worker won the race and is executing.
                    return fut.result(timeout_seconds)

                return call

        return _Proxy()

    def get_async(self, iface: str):
        """Async proxy: calls return TaskFutures."""
        service = self

        class _AsyncProxy(CamelCompatMixin):
            def __getattr__(self, method):
                def call(*args, **kwargs):
                    with service._lock:
                        got = service._impls.get(iface)
                    if got is None:
                        raise RuntimeError(
                            f"no workers registered for {iface!r}"
                        )
                    impl, ex = got
                    return ex.submit(getattr(impl, method), *args, **kwargs)

                return call

        return _AsyncProxy()


class RemoteServiceAckTimeoutException(RuntimeError):
    """→ org.redisson.remote.RemoteServiceAckTimeoutException: no worker
    acknowledged the invocation within the ack timeout."""


class TransactionException(RuntimeError):
    """→ org.redisson.transaction.TransactionException."""


class Transaction(CamelCompatMixin):
    """→ RTransaction (optimistic): reads collect a validation snapshot,
    writes buffer in an operation log; commit() validates every read
    under the store lock and applies the log atomically, raising
    TransactionException when a concurrent writer invalidated a read."""

    def __init__(self, client):
        self._client = client
        self._store = client._grid
        self._reads: dict[tuple, Any] = {}  # (name, key_bytes|None) -> snapshot
        # Set-membership reads validate as BOOLEANS: 'entry absent' and
        # 'entry exists, member absent' are the same observation (False),
        # unlike bucket/map reads where None is a distinct value.
        self._set_reads: dict[tuple, bool] = {}
        # Zset score reads validate by VALUE (score-or-None), distinct
        # from set membership booleans.
        self._score_reads: dict[tuple, Any] = {}
        self._writes: list[tuple] = []  # (apply_fn,)
        self._done = False

    # -- transactional facades ---------------------------------------------

    def get_bucket(self, name: str):
        return _TxBucket(self, name)

    def get_map(self, name: str):
        return _TxMap(self, name)

    def get_set(self, name: str):
        """→ RTransaction#getSet (upstream transactions cover sets too)."""
        return _TxSet(self, name)

    def get_list(self, name: str):
        """→ RTransaction-scoped list (upstream transactional breadth)."""
        return _TxList(self, name)

    def get_scored_sorted_set(self, name: str):
        """→ RedissonTransactionalSet's scored sibling."""
        return _TxScoredSortedSet(self, name)

    # -- commit/rollback -----------------------------------------------------

    def _check_open(self):
        if self._done:
            raise TransactionException("transaction already completed")

    def commit(self) -> None:
        self._check_open()
        self._done = True
        with self._store.lock:
            for (name, kb), snapshot in self._reads.items():
                cur = self._current(name, kb)
                if cur != snapshot:
                    raise TransactionException(
                        f"read of {name!r} invalidated by a concurrent write"
                    )
            for (name, kb), member in self._set_reads.items():
                if bool(self._current(name, kb)) != member:
                    raise TransactionException(
                        f"read of {name!r} invalidated by a concurrent write"
                    )
            for (name, kb), score in self._score_reads.items():
                if self._current_score(name, kb) != score:
                    raise TransactionException(
                        f"read of {name!r} invalidated by a concurrent write"
                    )
            # Pre-validate EVERY write target's kind BEFORE applying any
            # (write-only keys are not in the read-validation set): a
            # WRONGTYPE surfacing mid-apply would leave the log half-
            # committed — the atomicity contract this method documents.
            for name, kind, _fn in self._writes:
                if kind is None:
                    continue
                e = self._store.get_entry(name)
                if e is not None and e.kind != kind:
                    raise TransactionException(
                        f"WRONGTYPE: {name!r} holds a {e.kind}, "
                        f"transaction writes a {kind}"
                    )
            try:
                for _name, _kind, apply_fn in self._writes:
                    apply_fn()
            except BaseException as e:  # pragma: no cover — applies are
                raise TransactionException(  # pre-validated; belt+braces
                    f"transaction partially applied: {e!r}"
                ) from e
            self._store.cond.notify_all()

    def rollback(self) -> None:
        self._check_open()
        self._done = True
        self._reads.clear()
        self._writes.clear()

    def _register_read(self, table: dict, key: tuple, current_fn):
        """First-read-wins snapshot registration: repeated reads of the
        same key return the FIRST observation (repeatable reads within
        the tx) and commit validates against it — re-registering on
        every read would validate only the LAST observation, silently
        accepting a concurrent write between two in-tx reads."""
        if key in table:
            return table[key]
        cur = current_fn()
        table[key] = cur
        return cur

    def _current(self, name: str, kb: Optional[bytes]):
        e = self._store.get_entry(name)
        if e is None:
            return None
        if kb is None:
            if isinstance(e.value, list):
                # Whole-list reads snapshot CONTENTS (a tuple copy) —
                # the live list object always equals itself, which would
                # make validation vacuous.
                return tuple(e.value)
            return e.value
        if hasattr(e.value, "live"):  # map: per-key live slot
            slot = e.value.live(kb)
            return None if slot is None else slot[0]
        if isinstance(e.value, dict):  # set: membership snapshot
            return kb in e.value
        return None

    def _current_score(self, name: str, kb: bytes):
        """Zset score-or-None (distinct from set membership: a set's
        dict values are all None, so .get() cannot express membership)."""
        e = self._store.get_entry(name)
        if e is None or not isinstance(e.value, dict):
            return None
        return e.value.get(kb)


class _TxBucket:
    def __init__(self, tx: Transaction, name: str):
        self._tx = tx
        self._name = name
        self._codec = tx._client.config.codec
        self._local: Any = _MISSING

    def get(self):
        self._tx._check_open()
        if self._local is not _MISSING:
            return None if self._local is None else self._codec.decode(self._local)
        with self._tx._store.lock:
            def current():
                e = self._tx._store.get_entry(self._name, "bucket")
                return None if e is None else e.value
            snapshot = self._tx._register_read(
                self._tx._reads, (self._name, None), current
            )
            return None if snapshot is None else self._codec.decode(snapshot)

    def set(self, value) -> None:
        self._tx._check_open()
        vb = self._codec.encode(value)
        self._local = vb
        store, name = self._tx._store, self._name

        def apply():
            store.put_entry(name, "bucket", vb)

        self._tx._writes.append((name, "bucket", apply))

    def delete(self) -> None:
        self._tx._check_open()
        self._local = None
        store, name = self._tx._store, self._name
        self._tx._writes.append((name, None, lambda: store.delete(name)))


class _TxMap:
    def __init__(self, tx: Transaction, name: str):
        self._tx = tx
        self._name = name
        self._codec = tx._client.config.codec
        self._local: dict[bytes, Any] = {}

    def get(self, key):
        self._tx._check_open()
        kb = self._codec.encode_key(key)
        if kb in self._local:
            vb = self._local[kb]
            return None if vb is None else self._codec.decode(vb)
        with self._tx._store.lock:
            cur = self._tx._register_read(
                self._tx._reads, (self._name, kb),
                lambda: self._tx._current(self._name, kb),
            )
            return None if cur is None else self._codec.decode(cur)

    def put(self, key, value) -> None:
        self._tx._check_open()
        kb = self._codec.encode_key(key)
        vb = self._codec.encode(value)
        self._local[kb] = vb
        tx, name = self._tx, self._name

        def apply():
            from redisson_tpu_torch.grid.maps import _MapValue

            e = tx._store.ensure_entry(name, "map", _MapValue)
            e.value.data[kb] = [vb, None, None, time.time()]

        self._tx._writes.append((name, "map", apply))

    def remove(self, key) -> None:
        self._tx._check_open()
        kb = self._codec.encode_key(key)
        self._local[kb] = None
        tx, name = self._tx, self._name

        def apply():
            e = tx._store.get_entry(name, "map")
            if e is not None:
                e.value.data.pop(kb, None)

        self._tx._writes.append((name, "map", apply))


class _TxSet:
    """Transactional set facade (→ org/redisson/transaction/
    RedissonTransactionalSet): contains() snapshots membership for
    commit-time validation; add/remove buffer in the operation log."""

    def __init__(self, tx: Transaction, name: str):
        self._tx = tx
        self._name = name
        self._codec = tx._client.config.codec
        self._local: dict[bytes, bool] = {}  # staged membership

    def contains(self, value) -> bool:
        self._tx._check_open()
        kb = self._codec.encode(value)
        if kb in self._local:
            return self._local[kb]
        with self._tx._store.lock:
            return self._tx._register_read(
                self._tx._set_reads, (self._name, kb),
                lambda: bool(self._tx._current(self._name, kb)),
            )

    def add(self, value) -> bool:
        added = not self.contains(value)
        kb = self._codec.encode(value)
        self._local[kb] = True
        tx, name = self._tx, self._name

        def apply():
            e = tx._store.ensure_entry(name, "set", dict)
            e.value[kb] = None

        tx._writes.append((name, "set", apply))
        return added

    def remove(self, value) -> bool:
        removed = self.contains(value)
        kb = self._codec.encode(value)
        self._local[kb] = False
        tx, name = self._tx, self._name

        def apply():
            e = tx._store.get_entry(name, "set")
            if e is not None:
                e.value.pop(kb, None)

        tx._writes.append((name, "set", apply))
        return removed


class _TxList:
    """Transactional list facade (→ org/redisson/transaction breadth):
    reads snapshot the WHOLE list contents for commit-time validation
    (list positions shift under concurrent writes, so per-index
    validation would be unsound).  Staged ops replay over the snapshot
    for reads (read-your-writes AND read-your-removes) and over the live
    list at commit — ONE apply closure registered on first mutation."""

    def __init__(self, tx: Transaction, name: str):
        self._tx = tx
        self._name = name
        self._codec = tx._client.config.codec
        self._ops: list[tuple] = []  # ("add"|"remove", value_bytes)
        self._registered = False

    def _snapshot(self) -> tuple:
        with self._tx._store.lock:
            # Snapshot None for an ABSENT key (commit-time _current also
            # yields None there — storing () made every read of a
            # not-yet-existing list fail validation spuriously).
            cur = self._tx._register_read(
                self._tx._reads, (self._name, None),
                lambda: self._tx._current(self._name, None),
            )
            return cur if isinstance(cur, tuple) else ()

    def _view(self) -> list:
        """Snapshot with this tx's staged ops replayed — what reads see."""
        out = list(self._snapshot())
        for op, vb in self._ops:
            if op == "add":
                out.append(vb)
            elif vb in out:
                out.remove(vb)
        return out

    def _ensure_apply(self) -> None:
        if self._registered:
            return
        self._registered = True
        tx, name, ops = self._tx, self._name, self._ops

        def apply():
            e = tx._store.ensure_entry(name, "list", list)
            for op, vb in ops:
                if op == "add":
                    e.value.append(vb)
                elif vb in e.value:
                    e.value.remove(vb)

        tx._writes.append((name, "list", apply))

    def read_all(self) -> list:
        self._tx._check_open()
        return [self._codec.decode(vb) for vb in self._view()]

    def size(self) -> int:
        self._tx._check_open()
        return len(self._view())

    def get(self, index: int):
        self._tx._check_open()
        return self.read_all()[index]

    def contains(self, value) -> bool:
        self._tx._check_open()
        return self._codec.encode(value) in self._view()

    def add(self, value) -> bool:
        self._tx._check_open()
        self._ops.append(("add", self._codec.encode(value)))
        self._ensure_apply()
        return True

    def remove(self, value) -> bool:
        self._tx._check_open()
        vb = self._codec.encode(value)
        present = vb in self._view()
        if present:
            self._ops.append(("remove", vb))
            self._ensure_apply()
        return present


class _TxScoredSortedSet:
    """Transactional scored-sorted-set facade: score reads validate by
    value at commit (see Transaction._score_reads); add/remove buffer."""

    def __init__(self, tx: Transaction, name: str):
        self._tx = tx
        self._name = name
        self._codec = tx._client.config.codec
        self._local: dict[bytes, Any] = {}  # staged member -> score|None

    def get_score(self, member):
        self._tx._check_open()
        kb = self._codec.encode(member)
        if kb in self._local:
            return self._local[kb]
        with self._tx._store.lock:
            return self._tx._register_read(
                self._tx._score_reads, (self._name, kb),
                lambda: self._tx._current_score(self._name, kb),
            )

    def contains(self, member) -> bool:
        return self.get_score(member) is not None

    def add(self, score: float, member) -> bool:
        fresh = not self.contains(member)
        kb = self._codec.encode(member)
        self._local[kb] = float(score)
        tx, name = self._tx, self._name
        sc = float(score)

        def apply():
            e = tx._store.ensure_entry(name, "zset", dict)
            e.value[kb] = sc

        tx._writes.append((name, "zset", apply))
        return fresh

    def remove(self, member) -> bool:
        present = self.contains(member)
        kb = self._codec.encode(member)
        self._local[kb] = None
        tx, name = self._tx, self._name

        def apply():
            e = tx._store.get_entry(name, "zset")
            if e is not None:
                e.value.pop(kb, None)

        tx._writes.append((name, "zset", apply))
        return present


class ScriptService(CamelCompatMixin):
    """→ RScript/RFunction analog: named procedures run ATOMICALLY against
    the grid (under the store lock — the Lua-script atomicity contract).
    Procedures are Python callables ``fn(client, keys, args)`` registered
    in-process; there is deliberately no Lua VM."""

    def __init__(self, client):
        self._client = client
        self._fns: dict[str, Callable] = {}
        self._lock = threading.Lock()

    def register(self, name: str, fn: Callable) -> None:
        """→ SCRIPT LOAD (returns nothing; the name is the sha analog)."""
        with self._lock:
            self._fns[name] = fn

    def eval(self, name: str, keys: list = (), args: list = ()):
        """→ RScript#eval(EVALSHA): atomic w.r.t. every other grid op."""
        with self._lock:
            fn = self._fns.get(name)
        if fn is None:
            raise KeyError(f"NOSCRIPT: {name!r} is not registered")
        with self._client._grid.lock:
            out = fn(self._client, list(keys), list(args))
            self._client._grid.cond.notify_all()
            return out


class FunctionService(CamelCompatMixin):
    """→ RFunction (org/redisson/api/RFunction.java, upstream ≥3.17):
    Redis Functions group named procedures into LIBRARIES (FUNCTION LOAD
    ships a library of functions; FCALL invokes one by name).  Same
    atomicity contract as ScriptService — a call runs under the grid
    lock, indivisible w.r.t. every other grid op.  ``call_ro`` mirrors
    FCALL_RO's read-only contract: the function must not mutate (the
    contract is declarative here, as upstream's is — Redis enforces it
    via script flags, we via the no_writes registration flag).

    Libraries hold Python callables ``fn(client, keys, args)``; there is
    deliberately no Lua VM (ScriptService's design note applies)."""

    def __init__(self, client):
        self._client = client
        # library -> {function name -> (fn, no_writes)}
        self._libs: dict[str, dict] = {}
        self._by_name: dict[str, tuple] = {}  # flat FCALL lookup
        self._lock = threading.Lock()

    def load(self, library: str, functions: dict, *, replace: bool = False,
             no_writes: tuple = ()) -> None:
        """→ FUNCTION LOAD [REPLACE]: register a library.  ``functions``
        maps function name -> callable; names are GLOBAL across libraries
        (the Redis rule) — loading a clashing name raises unless
        ``replace`` and the name belongs to this same library."""
        with self._lock:
            if library in self._libs and not replace:
                raise ValueError(f"library {library!r} already exists")
            for fname in functions:
                owner = self._by_name.get(fname)
                if owner is not None and owner[0] != library:
                    raise ValueError(
                        f"function {fname!r} already registered by "
                        f"library {owner[0]!r}"
                    )
            old = self._libs.pop(library, {})
            for fname in old:
                self._by_name.pop(fname, None)
            lib = {
                fname: (fn, fname in no_writes)
                for fname, fn in functions.items()
            }
            self._libs[library] = lib
            for fname, entry in lib.items():
                self._by_name[fname] = (library, *entry)

    def call(self, name: str, keys: list = (), args: list = ()):
        """→ FCALL: atomic named-function invocation."""
        with self._lock:
            entry = self._by_name.get(name)
        if entry is None:
            raise KeyError(f"Function not found: {name!r}")
        _, fn, _ = entry
        with self._client._grid.lock:
            out = fn(self._client, list(keys), list(args))
            self._client._grid.cond.notify_all()
            return out

    def call_ro(self, name: str, keys: list = (), args: list = ()):
        """→ FCALL_RO: only functions registered ``no_writes`` qualify."""
        with self._lock:
            entry = self._by_name.get(name)
        if entry is None:
            raise KeyError(f"Function not found: {name!r}")
        _, fn, ro = entry
        if not ro:
            raise ValueError(
                f"Can not execute a function with write flag using fcall_ro: "
                f"{name!r}"
            )
        with self._client._grid.lock:
            return fn(self._client, list(keys), list(args))

    def list(self, library_pattern: Optional[str] = None) -> list:
        """→ FUNCTION LIST [LIBRARYNAME pat]: library metadata."""
        import fnmatch

        with self._lock:
            out = []
            for lib, fns in self._libs.items():
                if library_pattern and not fnmatch.fnmatch(lib, library_pattern):
                    continue
                out.append(
                    {
                        "library_name": lib,
                        "functions": [
                            {"name": f, "flags": ["no-writes"] if ro else []}
                            for f, (_, ro) in fns.items()
                        ],
                    }
                )
            return out

    def delete(self, library: str) -> None:
        """→ FUNCTION DELETE."""
        with self._lock:
            fns = self._libs.pop(library, None)
            if fns is None:
                raise KeyError(f"Library not found: {library!r}")
            for fname in fns:
                self._by_name.pop(fname, None)

    def flush(self) -> None:
        """→ FUNCTION FLUSH."""
        with self._lock:
            self._libs.clear()
            self._by_name.clear()


class LiveObjectService(CamelCompatMixin):
    """→ RLiveObjectService: instances whose attributes live in an RMap
    named ``{class}:{id}`` — every attribute read/write is a map op, so
    state is shared across handles (the @REntity/@RId proxy pattern).

    Index/search (→ org/redisson/liveobject/ @RIndex machinery): fields
    named in ``persist(..., index=(...))`` maintain per-(class, field,
    value) index sets, so ``find_by_field`` resolves indexed queries as
    one set read; non-indexed fields fall back to scanning the class's
    id registry (upstream requires the annotation; the scan fallback is
    a convenience)."""

    def __init__(self, client):
        self._client = client

    def _map_for(self, cls_name: str, rid) -> Any:
        return self._client.get_map(f"live:{cls_name}:{rid}")

    def _registry(self, cls_name: str):
        return self._client.get_set(f"live:{cls_name}:__ids__")

    def _indexed_fields(self, cls_name: str):
        return self._client.get_set(f"live:{cls_name}:__indexed__")

    def _value_key(self, value) -> str:
        """Deterministic index-set key component: the CODEC bytes of the
        value (repr() embedded memory addresses for objects with the
        default repr, so removal/lookup could never find the add-time
        set)."""
        return self._client.config.codec.encode(value).hex()

    def _index_set(self, cls_name: str, field: str, value):
        return self._client.get_set(
            f"live-idx:{cls_name}:{field}:{self._value_key(value)}"
        )

    def persist(self, obj: Any, rid=None, index: tuple = ()) -> "LiveProxy":
        """Store a plain object's __dict__ and return its live proxy.
        ``index`` names fields to index (the @RIndex analog); indexed
        fields stay maintained through proxy writes.  Marking a field
        indexed BACKFILLS its index sets from every already-registered
        instance, so the fast path never hides pre-index objects."""
        cls_name = type(obj).__name__
        rid = rid if rid is not None else getattr(obj, "id", None)
        if rid is None:
            raise ValueError("live object needs an 'id' attribute or rid=")
        m = self._map_for(cls_name, rid)
        indexed = self._indexed_fields(cls_name)
        with self._client._grid.lock:  # index + map mutate atomically
            newly_indexed = [
                f for f in index if not indexed.contains(f)
            ]
            for f in index:
                indexed.add(f)
            for f in newly_indexed:
                # Backfill from the registry: objects persisted BEFORE
                # the field became indexed must be findable too.
                for other in self._registry(cls_name).read_all():
                    if other == rid:
                        continue
                    v = self._map_for(cls_name, other).get(f)
                    if v is not None:
                        self._index_set(cls_name, f, v).add(other)
            idx_fields = set(indexed.read_all())
            for k, v in vars(obj).items():
                if k in idx_fields:
                    # Re-persist: drop the rid from the OLD value's set
                    # first, or a changed field leaves a stale entry.
                    old = m.get(k)
                    if old is not None and old != v:
                        self._index_set(cls_name, k, old).remove(rid)
                    self._index_set(cls_name, k, v).add(rid)
                m.fast_put(k, v)
            self._registry(cls_name).add(rid)
        return LiveProxy(self._client, cls_name, rid, self)

    def get(self, cls_or_name, rid) -> "LiveProxy":
        name = cls_or_name if isinstance(cls_or_name, str) else cls_or_name.__name__
        return LiveProxy(self._client, name, rid, self)

    def delete(self, cls_or_name, rid) -> bool:
        name = cls_or_name if isinstance(cls_or_name, str) else cls_or_name.__name__
        m = self._map_for(name, rid)
        # Drop this instance from every index it occupies.
        idx_fields = set(self._indexed_fields(name).read_all())
        for f in idx_fields:
            v = m.get(f)
            if v is not None:
                self._index_set(name, f, v).remove(rid)
        self._registry(name).remove(rid)
        return m.delete()

    def exists(self, cls_or_name, rid) -> bool:
        name = cls_or_name if isinstance(cls_or_name, str) else cls_or_name.__name__
        return self._map_for(name, rid).is_exists()

    # -- find/search (→ RLiveObjectService#find + Conditions.eq) -----------

    def find_by_field(self, cls_or_name, field: str, value) -> list:
        """All live proxies of the class whose ``field`` equals
        ``value`` — one index-set read when the field is indexed, a
        registry scan otherwise."""
        name = cls_or_name if isinstance(cls_or_name, str) else cls_or_name.__name__
        if field in set(self._indexed_fields(name).read_all()):
            rids = self._index_set(name, field, value).read_all()
        else:
            rids = [
                rid for rid in self._registry(name).read_all()
                if self._map_for(name, rid).get(field) == value
            ]
        return [LiveProxy(self._client, name, rid, self) for rid in rids]

    find = find_by_field  # upstream-shaped alias (Conditions.eq analog)

    def count(self, cls_or_name) -> int:
        name = cls_or_name if isinstance(cls_or_name, str) else cls_or_name.__name__
        return self._registry(name).size()

    def list_ids(self, cls_or_name) -> list:
        name = cls_or_name if isinstance(cls_or_name, str) else cls_or_name.__name__
        return self._registry(name).read_all()


class LiveProxy:
    """Attribute-mapped live object (the ByteBuddy proxy analog).
    Writes to indexed fields keep the class's index sets current."""

    def __init__(self, client, cls_name: str, rid, service=None):
        object.__setattr__(self, "_map", client.get_map(f"live:{cls_name}:{rid}"))
        object.__setattr__(self, "_cls_name", cls_name)
        object.__setattr__(self, "_rid", rid)
        object.__setattr__(
            self, "_svc", service or LiveObjectService(client)
        )

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return self._map.get(item)

    def __setattr__(self, item, value):
        svc, cls_name, rid = self._svc, self._cls_name, self._rid
        # One lock hold across read-old/move-index/write: two racing
        # writers would otherwise both read the same old value and leave
        # the rid ghost-indexed under both new values.
        with self._map._store.lock:
            if item in set(svc._indexed_fields(cls_name).read_all()):
                old = self._map.get(item)
                if old is not None and old != value:
                    svc._index_set(cls_name, item, old).remove(rid)
                svc._index_set(cls_name, item, value).add(rid)
            self._map.fast_put(item, value)

    def __delattr__(self, item):
        svc, cls_name, rid = self._svc, self._cls_name, self._rid
        with self._map._store.lock:
            if item in set(svc._indexed_fields(cls_name).read_all()):
                old = self._map.get(item)
                if old is not None:
                    svc._index_set(cls_name, item, old).remove(rid)
            self._map.fast_remove(item)


class MapReduce(CamelCompatMixin):
    """→ RMapReduce: mapper over a Map's entries, grouped shuffle, reducer
    per key — fanned out over an ExecutorService's workers in chunks."""

    def __init__(self, client, source_map, *, workers: int = 4,
                 chunk_size: int = 256):
        self._client = client
        self._source = source_map
        self._mapper: Optional[Callable] = None
        self._reducer: Optional[Callable] = None
        self._workers = workers
        self._chunk = chunk_size

    def mapper(self, fn: Callable) -> "MapReduce":
        """``fn(key, value) -> iterable[(k2, v2)]``."""
        self._mapper = fn
        return self

    def reducer(self, fn: Callable) -> "MapReduce":
        """``fn(k2, values) -> result``."""
        self._reducer = fn
        return self

    def execute(self) -> dict:
        if self._mapper is None or self._reducer is None:
            raise RuntimeError("mapper and reducer must both be set")
        entries = self._source.entry_set()
        ex = ExecutorService("mapreduce", self._client)
        ex.register_workers(self._workers)
        try:
            chunks = [
                entries[i : i + self._chunk]
                for i in range(0, len(entries), self._chunk)
            ]

            def run_chunk(chunk):
                out = []
                for k, v in chunk:
                    out.extend(self._mapper(k, v))
                return out

            futs = [ex.submit(run_chunk, c) for c in chunks]
            shuffled: dict[Any, list] = {}
            for f in futs:
                for k2, v2 in f.result(60.0):
                    shuffled.setdefault(k2, []).append(v2)
            rfuts = {
                k2: ex.submit(self._reducer, k2, vals)
                for k2, vals in shuffled.items()
            }
            return {k2: f.result(60.0) for k2, f in rfuts.items()}
        finally:
            ex.shutdown()
