"""GridObject — shared RObject plumbing for data-grid objects.

→ org/redisson/RedissonObject.java + RedissonExpirable.java: every object
is name-addressed, codec-encoded, supports delete/rename/exists/TTL and
``dump()/restore()`` (here: codec-pickled state round-trip).  camelCase
aliases ride the same CamelCompatMixin as the sketch objects.  The port's
copy of ``redisson_tpu/grid/base.py``.
"""

from __future__ import annotations

import pickle
from typing import Any, Optional

from redisson_tpu_torch.objects.base import CamelCompatMixin


def _journal_wrap(fn):
    """After the wrapped mutator returns, journal the object's full
    current state through the store (capture is atomic under the store
    lock, so seq order equals state order even when the method already
    released the lock — see GridStore._journal_capture)."""
    import functools

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        res = fn(self, *args, **kwargs)
        store = self._store
        if store.journal_active():
            store.journal_entry(self._name)
        return res

    return wrapper


def journaled(*method_names):
    """Class decorator: route the named MUTATOR methods through the op
    journal, so replicas and crash recovery mirror grid mutations.  Grid
    records are full-entry-state and idempotent; read-only methods must
    NOT be listed (every record costs an encode + a journal append).
    The ``_async`` twins wrap the sync methods via ``__getattr__``, so
    decorating the sync form covers both."""

    def deco(cls):
        for n in method_names:
            setattr(cls, n, _journal_wrap(getattr(cls, n)))
        return cls

    return deco


class GridObject(CamelCompatMixin):
    KIND: str = ""

    def __init__(self, name: str, client):
        self._name = name
        self._client = client
        self._store = client._grid
        self._codec = client.config.codec

    # -- identity ----------------------------------------------------------

    def get_name(self) -> str:
        return self._name

    @property
    def name(self) -> str:
        return self._name

    # -- codec helpers -----------------------------------------------------

    def _enc(self, obj: Any) -> bytes:
        return self._codec.encode(obj)

    def _dec(self, data: bytes) -> Any:
        return self._codec.decode(data)

    def _enc_key(self, obj: Any) -> bytes:
        return self._codec.encode_key(obj)

    def _dec_key(self, data: bytes) -> Any:
        return self._codec.decode_key(data)

    # -- near-cache reach ---------------------------------------------------
    #
    # Hot grid SCALAR reads (XLEN, GEOPOS/GEODIST-class) ride the sketch
    # engine's epoch-guarded near cache: grid keys live under a
    # ``grid:``-prefixed tenant so they can never collide with a sketch
    # tenant, every mutator bumps the write epoch, and the store-level
    # delete/rename/expiry paths invalidate through GridStore's hook.
    # Reads and writes both run under the one grid store lock, so the
    # capture-before-compute / install-if-unmoved discipline is exactly
    # the engine's (cache/nearcache.py module doc).

    def _nc_store(self):
        return getattr(
            getattr(self._client, "_engine", None), "nearcache", None
        )

    def _nc_bump(self, structural: bool = False) -> None:
        nc = self._nc_store()
        if nc is not None:
            note = nc.note_structural if structural else nc.note_write
            note("grid:" + self._name)

    def _nc_scalar(self, kind: str, key, compute):
        """Epoch-tagged scalar read-through; falls straight through to
        ``compute()`` when the tier is off.

        Cached values carry the key's TTL DEADLINE: a probe past it
        recomputes (which lazily reaps) instead of serving the
        pre-expiry value for up to a sweep interval — expiry is
        observed at read time, exactly like an uncached read.  TTL
        *changes* (EXPIRE/PERSIST) invalidate through the store hook,
        so a stale deadline can never outlive the command that moved
        it."""
        nc = self._nc_store()
        if nc is None or not nc.active(1):
            return compute()
        import time as _time

        from redisson_tpu_torch.cache.lru import MISS

        tenant = "grid:" + self._name
        captured = nc.epochs(tenant)
        hit = nc.probe(tenant, key)
        if hit is not MISS:
            v, deadline = hit
            if deadline is None or _time.time() < deadline:
                nc._count(kind, 1, 0)
                return v
        nc._count(kind, 0, 1)
        v = compute()
        # Deadline AFTER compute: an EXPIRE landing between the two
        # bumps the epoch (store hook) and retires this install.
        deadline = self._store.peek_expire_at(self._name)
        nc.install(
            tenant, key, (v, deadline), captured=captured, monotone=False
        )
        return v

    # -- keyspace ops (→ RedissonObject) -----------------------------------

    def is_exists(self) -> bool:
        return self._store.exists(self._name)

    def delete(self) -> bool:
        return self._store.delete(self._name)

    def rename(self, new_name: str) -> None:
        """→ RedissonObject#rename: raises when the source key does not
        exist (Redis RENAME semantics); the facade only re-points on
        success."""
        if not self._store.rename(self._name, new_name):
            raise RuntimeError(f"object {self._name!r} does not exist")
        self._name = new_name

    def touch(self) -> bool:
        return self._store.exists(self._name)

    def unlink(self) -> bool:
        return self.delete()

    # -- TTL (→ RedissonExpirable) -----------------------------------------

    def expire(self, ttl_seconds: float) -> bool:
        return self._store.expire(self._name, float(ttl_seconds))

    def expire_at(self, epoch_seconds: float) -> bool:
        return self._store.expire_at(self._name, float(epoch_seconds))

    def clear_expire(self) -> bool:
        return self._store.clear_expire(self._name)

    def remain_time_to_live(self) -> int:
        return self._store.remain_ttl_ms(self._name)

    # -- dump/restore (→ RObject#dump/restore over DUMP/RESTORE) -----------

    def dump(self) -> bytes:
        e = self._store.get_entry(self._name, self.KIND)
        if e is None:
            raise RuntimeError(f"object {self._name!r} does not exist")
        return pickle.dumps((self.KIND, e.value), protocol=pickle.HIGHEST_PROTOCOL)

    def restore(self, data: bytes, replace: bool = False) -> None:
        kind, value = pickle.loads(data)
        if kind != self.KIND:
            raise TypeError(f"dump holds a {kind}, not a {self.KIND}")
        with self._store.lock:
            if not replace and self._store.exists(self._name):
                raise RuntimeError(f"object {self._name!r} already exists")
            self._store.put_entry(self._name, self.KIND, value)

    # -- internals ---------------------------------------------------------

    def _entry(self, create: bool = True):
        if create:
            return self._store.ensure_entry(self._name, self.KIND, self._new_value)
        return self._store.get_entry(self._name, self.KIND)

    @staticmethod
    def _new_value() -> Any:
        raise NotImplementedError

    def __getattr__(self, item):
        # RFuture idiom parity (→ every reference object's *Async twin):
        # ``fooAsync``/``foo_async`` works for EVERY grid method, running
        # off the caller thread.  Methods whose NAME can block (queue
        # take/poll, lock waits — _may_block) get a dedicated thread per
        # call, because on a shared bounded pool blocked ops occupy every
        # worker and the op that would unblock them queues behind
        # (deadlock); everything else runs on ONE bounded shared pool so
        # thousands of concurrent async gets cost pool-width threads,
        # not one thread each.  Like the reference's async facade,
        # ordering across independent async calls is not guaranteed;
        # Batch provides the ordered pipeline.
        if item.endswith("_async") and not item.startswith("_"):
            sync = getattr(self, item[: -len("_async")], None)
            if callable(sync):

                def async_form(*args, **kwargs):
                    return _spawn_future(sync, args, kwargs)

                return async_form
        return super().__getattr__(item)


# Method-name tokens that can legitimately BLOCK (waiting on another
# grid op to unblock them): these MUST run on dedicated threads — on a
# shared bounded pool they occupy every worker and the op that would
# release them queues behind (classic pool deadlock).  False positives
# (a non-blocking 'put') merely cost one extra thread; a false NEGATIVE
# deadlocks, so the list errs broad.
_BLOCKING_TOKENS = (
    "take", "poll", "lock", "acquire", "wait", "await", "transfer",
    "offer", "put", "pop", "read", "drain", "subscribe", "listen",
    "publish", "invoke", "remove",
)


def _may_block(name: str) -> bool:
    n = name.lower()
    return any(t in n for t in _BLOCKING_TOKENS)


import threading as _threading

from redisson_tpu_torch.analysis import witness as _witness

_shared_pool = None
# Module-scope lock: creating it lazily raced — two first callers could
# each install a different lock and build two executors.
_shared_pool_lock = _witness.named(_threading.Lock(), "grid.shared_pool")


def _get_shared_pool():
    """ONE bounded pool per process for non-blocking async twins (the
    reference's shared executor role)."""
    global _shared_pool
    with _shared_pool_lock:
        if _shared_pool is None:
            import concurrent.futures
            import os

            _shared_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=min(32, (os.cpu_count() or 4) + 4),
                thread_name_prefix="rtpu-async-pool",
            )
        return _shared_pool


def _spawn_future(fn, args, kwargs):
    """Run ``fn`` off-thread; returns a concurrent-style future
    (result/get/done).  Possibly-blocking methods (by name — see
    _may_block) get a dedicated daemon thread so they can never starve
    each other; everything else shares one bounded pool, so 5k
    concurrent async map gets cost pool-width threads, not 5k."""
    import concurrent.futures
    import threading

    if not _may_block(getattr(fn, "__name__", "")):
        return _PoolFuture(_get_shared_pool().submit(fn, *args, **kwargs))

    fut: "concurrent.futures.Future" = concurrent.futures.Future()

    def run():
        if not fut.set_running_or_notify_cancel():
            return
        try:
            fut.set_result(fn(*args, **kwargs))
        except BaseException as e:
            fut.set_exception(e)

    threading.Thread(target=run, daemon=True, name="rtpu-grid-async").start()
    return _PoolFuture(fut)


class _PoolFuture:
    """concurrent.futures adapter with the RFuture-ish get/done surface
    the sketch futures expose.  ``result()`` waits indefinitely by
    default, matching concurrent.futures and the sync-call contract."""

    def __init__(self, fut):
        self._fut = fut

    def result(self, timeout: Optional[float] = None):
        return self._fut.result(timeout)

    def get(self):
        return self.result()

    def done(self) -> bool:
        return self._fut.done()
