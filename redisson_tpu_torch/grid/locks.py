"""Locks & synchronizers — → org/redisson/RedissonLock.java (reentrant
lock + watchdog), RedissonFairLock (FIFO), RedissonReadWriteLock,
RedissonSemaphore, RedissonPermitExpirableSemaphore,
RedissonCountDownLatch, RedissonSpinLock, RedissonFencedLock,
RedissonMultiLock/RedLock (client-side N-lock composition),
RedissonRateLimiter (token bucket).

The reference implements these as Lua scripts + pub/sub wake-ups
(SURVEY.md §3.3); in-process the store's condition variable plays the
unlock-channel role and lease expiry replaces the watchdog's renew loop
(a held lock with no lease simply cannot be lost while the process
lives).  Owner identity is (client id, thread id) — the analog of the
reference's UUID:threadId lock value.

The port's copy of ``redisson_tpu/grid/locks.py``.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Optional

from redisson_tpu_torch.grid.base import GridObject


def _now() -> float:
    return time.monotonic()


class Lock(GridObject):
    KIND = "lock"

    @staticmethod
    def _new_value():
        return {"owner": None, "count": 0, "expire_at": None, "token": 0}

    def _me(self):
        # UUID:threadId — the reference's lock value (→ RedissonLock).
        # id(client) would alias once a dead client's id is recycled.
        return (self._client.id, threading.get_ident())

    def _live_state(self):
        e = self._entry()
        st = e.value
        if st["owner"] is not None and st["expire_at"] is not None and _now() >= st["expire_at"]:
            st["owner"] = None
            st["count"] = 0
            st["expire_at"] = None
        return st

    def _live_state_ro(self):
        """Read-only state peek: does NOT materialize a keyspace entry for
        an absent lock (in Redis an unheld lock key does not exist)."""
        e = self._entry(create=False)
        if e is None:
            return None
        st = e.value
        if st["owner"] is not None and st["expire_at"] is not None and _now() >= st["expire_at"]:
            st["owner"] = None
            st["count"] = 0
            st["expire_at"] = None
        return st

    def _tokens(self) -> dict:
        """Fencing-token counters survive OUTSIDE the keyspace entry (per
        store, keyed by name): the entry itself is deleted on full release
        — in Redis an unheld lock key does not exist — but fencing tokens
        must stay monotonic across acquire/release cycles."""
        return self._store.__dict__.setdefault("_lock_tokens", {})

    def _try_take(self, lease_seconds: Optional[float]) -> bool:
        me = self._me()
        # Contended probe: do NOT materialize an entry for a lock someone
        # else holds (failed try_lock calls must not leak keyspace names).
        ro = self._live_state_ro()
        if ro is not None and ro["owner"] is not None and ro["owner"] != me:
            return False
        st = self._live_state()
        if st["owner"] is None:
            st["owner"] = me
            st["count"] = 1
            st["expire_at"] = None if lease_seconds is None else _now() + lease_seconds
            toks = self._tokens()
            toks[self._name] = st["token"] = toks.get(self._name, 0) + 1
            return True
        if st["owner"] == me:
            st["count"] += 1  # reentrancy (→ RedissonLock hash-incr)
            if lease_seconds is not None:
                st["expire_at"] = _now() + lease_seconds
            return True
        return False

    def lock(self, lease_seconds: Optional[float] = None) -> None:
        with self._store.cond:
            while not self._try_take(lease_seconds):
                self._store.cond.wait(timeout=self._wait_slice())

    def try_lock(self, wait_seconds: float = 0.0, lease_seconds: Optional[float] = None) -> bool:
        deadline = _now() + wait_seconds
        with self._store.cond:
            while True:
                if self._try_take(lease_seconds):
                    return True
                remaining = deadline - _now()
                if remaining <= 0:
                    return False
                self._store.cond.wait(timeout=min(remaining, self._wait_slice()))

    def _wait_slice(self) -> float:
        """Cap waits so lease expiry is noticed without an unlock signal."""
        st = self._live_state_ro()
        if st is None or st["expire_at"] is None:
            return 1.0
        return max(0.01, min(1.0, st["expire_at"] - _now()))

    def unlock(self) -> None:
        with self._store.cond:
            st = self._live_state()
            if st["owner"] != self._me():
                raise RuntimeError(
                    f"lock {self._name!r} is not held by this thread"
                )
            st["count"] -= 1
            if st["count"] <= 0:
                # Full release DELETES the key (Redis unlock semantics:
                # an unheld lock does not exist in the keyspace).
                self._release_entry()
                self._store.cond.notify_all()  # the unlock-channel PUBLISH

    def _release_entry(self) -> None:
        """Remove the keyspace entry on full release.  Subclasses with
        extra durable state (fair queue) override to decide."""
        self._store.delete(self._name)

    def force_unlock(self) -> bool:
        with self._store.cond:
            st = self._live_state_ro()
            held = st is not None and st["owner"] is not None
            if st is not None:
                self._release_entry()
            self._store.cond.notify_all()
            return held

    def is_locked(self) -> bool:
        with self._store.lock:
            st = self._live_state_ro()
            return st is not None and st["owner"] is not None

    def is_held_by_current_thread(self) -> bool:
        with self._store.lock:
            st = self._live_state_ro()
            return st is not None and st["owner"] == self._me()

    def get_hold_count(self) -> int:
        with self._store.lock:
            st = self._live_state_ro()
            if st is None:
                return 0
            return st["count"] if st["owner"] == self._me() else 0

    def remain_lease_time(self) -> int:
        """ms until lease expiry; -1 held without lease, -2 not held."""
        with self._store.lock:
            st = self._live_state_ro()
            if st is None or st["owner"] is None:
                return -2
            if st["expire_at"] is None:
                return -1
            return max(0, int((st["expire_at"] - _now()) * 1000))

    # context manager sugar
    def __enter__(self):
        self.lock()
        return self

    def __exit__(self, *exc):
        self.unlock()


class SpinLock(Lock):
    """→ RedissonSpinLock: same semantics, polling acquisition (the
    reference variant avoids pub/sub; in-process the distinction is moot)."""

    KIND = "spinlock"


class FencedLock(Lock):
    """→ RedissonFencedLock: lock() returns a monotonically increasing
    fencing token."""

    KIND = "fencedlock"

    def lock_and_get_token(self, lease_seconds: Optional[float] = None) -> int:
        self.lock(lease_seconds)
        with self._store.lock:
            return self._entry().value["token"]

    def get_token(self) -> Optional[int]:
        with self._store.lock:
            st = self._live_state_ro()
            if st is None:
                return None
            return st["token"] if st["owner"] == self._me() else None

    # token counters live in Lock._tokens() (store-side), so fencing
    # monotonicity survives the entry's deletion on release.


class FairLock(Lock):
    """→ RedissonFairLock: FIFO handoff — waiters queue and only the head
    may take the lock."""

    KIND = "fairlock"

    @staticmethod
    def _new_value():
        return {"owner": None, "count": 0, "expire_at": None, "token": 0,
                "queue": []}

    def _try_take(self, lease_seconds):
        st = self._live_state()
        me = self._me()
        q = st["queue"]
        if st["owner"] == me:
            return super()._try_take(lease_seconds)
        if st["owner"] is None and (not q or q[0] == me):
            if q and q[0] == me:
                q.pop(0)
            return super()._try_take(lease_seconds)
        if me not in q:
            q.append(me)
        return False

    def try_lock(self, wait_seconds: float = 0.0, lease_seconds: Optional[float] = None) -> bool:
        got = super().try_lock(wait_seconds, lease_seconds)
        if not got:
            with self._store.lock:  # leave the queue on timeout
                st = self._live_state_ro()
                me = self._me()
                if st is not None and me in st["queue"]:
                    st["queue"].remove(me)
                    if st["owner"] is None and not st["queue"]:
                        self._release_entry()  # nothing left to preserve
        return got

    def _release_entry(self) -> None:
        # The FIFO queue must survive a release while waiters are parked
        # (deleting it would lose their positions); the entry goes away
        # only once the queue is empty too.
        st = self._live_state_ro()
        if st is None or not st["queue"]:
            self._store.delete(self._name)
        else:
            st["owner"] = None
            st["count"] = 0
            st["expire_at"] = None


class ReadWriteLock(GridObject):
    """→ RedissonReadWriteLock: many readers or one writer; the writer may
    downgrade by taking the read lock while holding write."""

    KIND = "rwlock"

    @staticmethod
    def _new_value():
        return {"readers": {}, "writer": None, "write_count": 0}

    def read_lock(self) -> "_ReadLock":
        return _ReadLock(self)

    def write_lock(self) -> "_WriteLock":
        return _WriteLock(self)

    def _me(self):
        return (self._client.id, threading.get_ident())


class _ReadLock:
    def __init__(self, rw: ReadWriteLock):
        self._rw = rw
        self._store = rw._store

    def _try_take(self) -> bool:
        st = self._rw._entry().value
        me = self._rw._me()
        if st["writer"] is None or st["writer"] == me:
            st["readers"][me] = st["readers"].get(me, 0) + 1
            return True
        return False

    def lock(self) -> None:
        with self._store.cond:
            while not self._try_take():
                self._store.cond.wait(timeout=1.0)

    def try_lock(self, wait_seconds: float = 0.0) -> bool:
        deadline = _now() + wait_seconds
        with self._store.cond:
            while True:
                if self._try_take():
                    return True
                remaining = deadline - _now()
                if remaining <= 0:
                    return False
                self._store.cond.wait(timeout=remaining)

    def unlock(self) -> None:
        with self._store.cond:
            st = self._rw._entry().value
            me = self._rw._me()
            n = st["readers"].get(me, 0)
            if n <= 0:
                raise RuntimeError("read lock is not held by this thread")
            if n == 1:
                del st["readers"][me]
            else:
                st["readers"][me] = n - 1
            self._store.cond.notify_all()

    def __enter__(self):
        self.lock()
        return self

    def __exit__(self, *exc):
        self.unlock()


class _WriteLock:
    def __init__(self, rw: ReadWriteLock):
        self._rw = rw
        self._store = rw._store

    def _try_take(self) -> bool:
        st = self._rw._entry().value
        me = self._rw._me()
        others_reading = any(k != me for k in st["readers"])
        if st["writer"] in (None, me) and not others_reading:
            st["writer"] = me
            st["write_count"] += 1
            return True
        return False

    def lock(self) -> None:
        with self._store.cond:
            while not self._try_take():
                self._store.cond.wait(timeout=1.0)

    def try_lock(self, wait_seconds: float = 0.0) -> bool:
        deadline = _now() + wait_seconds
        with self._store.cond:
            while True:
                if self._try_take():
                    return True
                remaining = deadline - _now()
                if remaining <= 0:
                    return False
                self._store.cond.wait(timeout=remaining)

    def unlock(self) -> None:
        with self._store.cond:
            st = self._rw._entry().value
            if st["writer"] != self._rw._me():
                raise RuntimeError("write lock is not held by this thread")
            st["write_count"] -= 1
            if st["write_count"] <= 0:
                st["writer"] = None
                st["write_count"] = 0
            self._store.cond.notify_all()

    def __enter__(self):
        self.lock()
        return self

    def __exit__(self, *exc):
        self.unlock()


class Semaphore(GridObject):
    """→ RedissonSemaphore: permits must be set before acquisition
    (trySetPermits), release() may exceed the initial count (Redis
    semantics — permits are just a counter)."""

    KIND = "semaphore"

    @staticmethod
    def _new_value():
        return {"permits": 0, "init": False}

    def try_set_permits(self, permits: int) -> bool:
        with self._store.lock:
            e = self._entry()
            # Guard on initialization, not on the counter: a fully-drained
            # semaphore (permits == 0) must NOT be silently re-armed.
            if e.value["init"]:
                return False
            e.value["permits"] = int(permits)
            e.value["init"] = True
            return True

    def available_permits(self) -> int:
        with self._store.lock:
            e = self._entry(create=False)
            return 0 if e is None else e.value["permits"]

    def try_acquire(self, permits: int = 1, wait_seconds: float = 0.0) -> bool:
        deadline = _now() + wait_seconds
        with self._store.cond:
            while True:
                st = self._entry().value
                if st["permits"] >= permits:
                    st["permits"] -= permits
                    return True
                remaining = deadline - _now()
                if remaining <= 0:
                    return False
                self._store.cond.wait(timeout=remaining)

    def acquire(self, permits: int = 1) -> None:
        with self._store.cond:
            while True:
                st = self._entry().value
                if st["permits"] >= permits:
                    st["permits"] -= permits
                    return
                self._store.cond.wait(timeout=1.0)

    def release(self, permits: int = 1) -> None:
        with self._store.cond:
            self._entry().value["permits"] += permits
            self._store.cond.notify_all()

    def add_permits(self, permits: int) -> None:
        self.release(permits)

    def drain_permits(self) -> int:
        with self._store.lock:
            st = self._entry().value
            n = st["permits"]
            st["permits"] = 0
            return n


class PermitExpirableSemaphore(GridObject):
    """→ RedissonPermitExpirableSemaphore: acquire() returns a permit id;
    leased permits auto-return on expiry; release(id) is idempotent-safe."""

    KIND = "xsemaphore"

    @staticmethod
    def _new_value():
        return {"permits": 0, "leased": {}}  # id -> expire_at|None

    def _reclaim(self, st) -> None:
        now = _now()
        dead = [
            pid
            for pid, exp in st["leased"].items()
            if exp is not None and now >= exp
        ]
        for pid in dead:
            del st["leased"][pid]
            st["permits"] += 1

    def try_set_permits(self, permits: int) -> bool:
        with self._store.lock:
            st = self._entry().value
            if st["permits"] != 0 or st["leased"]:
                return False
            st["permits"] = int(permits)
            return True

    def available_permits(self) -> int:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return 0
            st = e.value
            self._reclaim(st)
            return st["permits"]

    def try_acquire(self, wait_seconds: float = 0.0,
                    lease_seconds: Optional[float] = None) -> Optional[str]:
        deadline = _now() + wait_seconds
        with self._store.cond:
            while True:
                st = self._entry().value
                self._reclaim(st)
                if st["permits"] > 0:
                    st["permits"] -= 1
                    pid = uuid.uuid4().hex
                    st["leased"][pid] = (
                        None if lease_seconds is None else _now() + lease_seconds
                    )
                    return pid
                remaining = deadline - _now()
                if remaining <= 0:
                    return None
                self._store.cond.wait(timeout=min(0.05, max(0.01, remaining)))

    def acquire(self, lease_seconds: Optional[float] = None) -> str:
        while True:
            pid = self.try_acquire(wait_seconds=1.0, lease_seconds=lease_seconds)
            if pid is not None:
                return pid

    def try_release(self, permit_id: str) -> bool:
        with self._store.cond:
            st = self._entry().value
            if permit_id not in st["leased"]:
                return False
            del st["leased"][permit_id]
            st["permits"] += 1
            self._store.cond.notify_all()
            return True

    def release(self, permit_id: str) -> None:
        if not self.try_release(permit_id):
            raise RuntimeError(f"permit {permit_id!r} is not leased (expired?)")


class CountDownLatch(GridObject):
    """→ RedissonCountDownLatch: trySetCount / countDown / await."""

    KIND = "countdownlatch"

    @staticmethod
    def _new_value():
        return {"count": 0}

    def try_set_count(self, count: int) -> bool:
        with self._store.lock:
            st = self._entry().value
            if st["count"] != 0:
                return False
            st["count"] = int(count)
            return True

    def get_count(self) -> int:
        with self._store.lock:
            e = self._entry(create=False)
            return 0 if e is None else e.value["count"]

    def count_down(self) -> None:
        with self._store.cond:
            st = self._entry().value
            if st["count"] > 0:
                st["count"] -= 1
                if st["count"] == 0:
                    self._store.cond.notify_all()

    def wait_for(self, timeout_seconds: Optional[float] = None) -> bool:
        """→ RCountDownLatch#await (``await`` is reserved in Python)."""
        deadline = None if timeout_seconds is None else _now() + timeout_seconds
        with self._store.cond:
            while self.get_count() > 0:
                remaining = None if deadline is None else deadline - _now()
                if remaining is not None and remaining <= 0:
                    return False
                self._store.cond.wait(
                    timeout=1.0 if remaining is None else min(1.0, remaining)
                )
            return True


class MultiLock:
    """→ RedissonMultiLock / RedissonRedLock: acquire N locks as a unit,
    releasing everything on partial failure."""

    def __init__(self, *locks: Lock):
        if not locks:
            raise ValueError("MultiLock needs at least one lock")
        self._locks = list(locks)

    def try_lock(self, wait_seconds: float = 0.0,
                 lease_seconds: Optional[float] = None) -> bool:
        acquired = []
        deadline = _now() + wait_seconds
        for lk in self._locks:
            remaining = max(0.0, deadline - _now())
            if lk.try_lock(remaining, lease_seconds):
                acquired.append(lk)
            else:
                for got in reversed(acquired):
                    try:
                        got.unlock()
                    except RuntimeError:
                        pass  # lease expired while acquiring the rest
                return False
        return True

    def lock(self, lease_seconds: Optional[float] = None) -> None:
        while not self.try_lock(wait_seconds=1.0, lease_seconds=lease_seconds):
            pass

    def unlock(self) -> None:
        errors = []
        for lk in reversed(self._locks):
            try:
                lk.unlock()
            except RuntimeError as e:
                errors.append(e)
        if errors:
            raise errors[0]

    def __enter__(self):
        self.lock()
        return self

    def __exit__(self, *exc):
        self.unlock()


class RateLimiter(GridObject):
    """→ org/redisson/RedissonRateLimiter.java: fixed-interval token
    bucket — ``rate`` permits become available every ``interval`` seconds
    (the reference's RateType OVERALL; per-client mode keys the bucket by
    client id)."""

    KIND = "ratelimiter"

    OVERALL = "overall"
    PER_CLIENT = "per_client"

    @staticmethod
    def _new_value():
        return {"mode": None, "rate": 0, "interval": 0.0, "buckets": {}}

    @classmethod
    def _check_mode(cls, mode: str) -> None:
        if mode not in (cls.OVERALL, cls.PER_CLIENT):
            raise ValueError(f"unknown rate mode: {mode}")

    def try_set_rate(self, mode: str, rate: int, interval_seconds: float) -> bool:
        self._check_mode(mode)
        with self._store.lock:
            st = self._entry().value
            if st["mode"] is not None:
                return False
            st.update(mode=mode, rate=int(rate), interval=float(interval_seconds))
            return True

    def set_rate(self, mode: str, rate: int, interval_seconds: float) -> None:
        self._check_mode(mode)
        with self._store.lock:
            st = self._entry().value
            st.update(
                mode=mode, rate=int(rate), interval=float(interval_seconds),
                buckets={},
            )

    def _bucket(self, st):
        key = "all" if st["mode"] == self.OVERALL else self._client.id
        b = st["buckets"].get(key)
        now = _now()
        if b is None or now >= b["window_end"]:
            b = {"tokens": st["rate"], "window_end": now + st["interval"]}
            st["buckets"][key] = b
        return b

    def try_acquire(self, permits: int = 1, wait_seconds: float = 0.0) -> bool:
        deadline = _now() + wait_seconds
        while True:
            with self._store.lock:
                st = self._entry().value
                if st["mode"] is None:
                    raise RuntimeError("rate is not set (try_set_rate first)")
                if permits > st["rate"]:
                    raise ValueError(
                        f"requested {permits} permits > rate {st['rate']}"
                    )
                b = self._bucket(st)
                if b["tokens"] >= permits:
                    b["tokens"] -= permits
                    return True
                retry_at = b["window_end"]
            remaining = deadline - _now()
            if remaining <= 0:
                return False
            time.sleep(min(remaining, max(0.005, retry_at - _now())))

    def acquire(self, permits: int = 1) -> None:
        while not self.try_acquire(permits, wait_seconds=1.0):
            pass

    def available_permits(self) -> int:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None or e.value["mode"] is None:
                return 0
            return self._bucket(e.value)["tokens"]
