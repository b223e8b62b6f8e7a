"""Bucket pre-warming — take first launches off the serving path.

Counterpart of ``redisson_tpu/executor/prewarm.py``.  The JAX package
warms its jit cache; PyTorch runs eagerly and compiles nothing, but the
first launch of an (op, bucket, pool signature) still pays one-time
costs on the card: CUDA's lazy load of each kernel module on its first
launch, the caching allocator's first block of each bucket's staging
and result sizes, and (for K1) the nvcc build.  This module moves those
to a background thread: on pool attach (and on every pool growth, which
changes the pool signature), the engine registers the pool's hot
dispatch signatures here, and the pre-warm thread drives each one
through the REAL executor methods at every padded bucket of the
(min_bucket → max_batch) ladder.

Design constraints that shaped this (the JAX package's, kept):

- Warm calls go through the UNWRAPPED executor methods (``_locked``
  keeps the lock-free body behind ``__wrapped__``) against a private
  scratch pool of the same shape: holding the dispatch lock for a whole
  ladder would stall serving, and the scratch state makes the calls
  race-free without it (staging blocks are allocated per call, never
  shared).  Op content is irrelevant; only shapes reach the kernels and
  the allocator.
- Warm batches are harmless by construction anyway (contains-only /
  OP_GET / weight-0), and they run against scratch state, so even
  mutating signatures (HLL adds) cannot perturb tenant data.
- Each warm launch's result is fetched, so a launch that fails on the
  card raises in the warm thread; the first such error is raised again
  out of :meth:`BucketPrewarmer.wait_idle` (and the engine's
  ``prewarm_wait``) — warming never swallows a device error.

The executor counts first launches process-wide
(:func:`first_launch_count`); tests and the smoke run snapshot it around
a serving window to show the warm path adds none.
"""

from __future__ import annotations

import atexit
import queue
import threading
from typing import Callable, Optional

import numpy as np

from redisson_tpu_torch import chaos as _chaos
from redisson_tpu_torch.executor.torch_executor import first_launch_count

__all__ = ["BucketPrewarmer", "first_launch_count"]


class _WarmPool:
    """Scratch stand-in for a SizeClassPool: same spec, capacity and row
    units (so its launches have the real pool's signature) but private
    state — warm dispatches mutate it freely without the dispatch lock."""

    __slots__ = ("spec", "state", "capacity", "row_units")

    def __init__(self, pool, executor):
        # Snapshot capacity ONCE: the real pool can grow concurrently
        # (its dispatch lock is exactly what warm calls avoid), and a
        # torn read here would mix two layouts in one scratch state.
        cap = pool.capacity
        self.spec = pool.spec
        self.capacity = cap
        self.row_units = pool.row_units
        self.state = executor.make_pool_state(
            cap, pool.row_units, pool.spec.dtype, kind=pool.spec.kind
        )


def _raw(executor, name: str) -> Callable:
    """The unwrapped (lock-free) executor method — see module docstring."""
    return getattr(type(executor), name).__wrapped__


def _fetch(res) -> None:
    """Bring a warm launch's result home: the D2H path warms too, and a
    launch that failed on the card raises here instead of later."""
    if res is not None and hasattr(res, "result"):
        res.result()


def _rows(wpool, B: int) -> np.ndarray:
    return (np.arange(B, dtype=np.int64) % max(1, wpool.capacity)).astype(np.int32)


# -- warm-batch builders ------------------------------------------------------
#
# Each returns fn(executor, warm_pool, bucket) that drives ONE real
# dispatch method with a bucket-sized batch whose shapes and dtypes match
# serving traffic.


def warm_bloom_mixed(k: int) -> Callable:
    """The host-hashed mixed ladder (the engine's ``bloom_add`` /
    ``bloom_contains`` of pre-hashed keys): contains-only batches."""
    def fn(ex, wpool, B):
        h = np.zeros(B, np.uint32)
        _fetch(_raw(ex, "bloom_mixed")(
            ex, wpool, _rows(wpool, B), np.ones(B, np.uint32), k, h, h,
            np.zeros(B, bool),
        ))
    return fn


def warm_bloom_mixed_keys(k: int, L: int, Lt: int) -> Callable:
    def fn(ex, wpool, B):
        blocks = np.zeros((B, L), np.uint32)
        blocks[:, :Lt] = 1  # trim keeps exactly Lt lanes
        _fetch(_raw(ex, "bloom_mixed_keys")(
            ex, wpool, _rows(wpool, B), np.ones(B, np.uint32), k, blocks,
            np.full(B, Lt * 4, np.uint32), np.zeros(B, bool),
        ))
    return fn


def warm_bloom_mixed_keys_runs(k: int, L: int, Lt: int, const_len: bool) -> Callable:
    def fn(ex, wpool, B):
        blocks = np.zeros((B, L), np.uint32)
        blocks[:, :Lt] = 1
        lengths = (
            np.uint32(Lt * 4) if const_len else np.full(B, Lt * 4, np.uint32)
        )
        _fetch(_raw(ex, "bloom_mixed_keys_runs")(
            ex, wpool, k, blocks, lengths,
            np.zeros(1, np.int32), np.ones(1, np.uint32),
            np.zeros(1, bool), np.array([0, B], np.int32),
        ))
    return fn


def warm_bitset_mixed() -> Callable:
    def fn(ex, wpool, B):
        from redisson_tpu_torch.ops import bitset as bitset_ops

        _fetch(_raw(ex, "bitset_mixed")(
            ex, wpool, _rows(wpool, B), np.zeros(B, np.uint32),
            np.full(B, bitset_ops.OP_GET, np.uint32),
        ))
    return fn


def warm_bitset_mixed_runs() -> Callable:
    def fn(ex, wpool, B):
        from redisson_tpu_torch.ops import bitset as bitset_ops

        _fetch(_raw(ex, "bitset_mixed_runs")(
            ex, wpool, np.zeros(B, np.uint32),
            np.zeros(1, np.int32),
            np.full(1, bitset_ops.OP_GET, np.uint32),
            np.array([0, B], np.int32),
        ))
    return fn


def warm_hll_add_changed() -> Callable:
    def fn(ex, wpool, B):
        z = np.zeros(B, np.uint32)
        _fetch(_raw(ex, "hll_add_changed")(ex, wpool, _rows(wpool, B), z, z, z))
    return fn


def warm_cms_update_estimate(d: int, w: int) -> Callable:
    """The multi-tenant CMS path (``cms_update_estimate``).  The
    sequential path (K1) has no warm function, as in the JAX package."""
    def fn(ex, wpool, B):
        z = np.zeros(B, np.uint32)
        _fetch(_raw(ex, "cms_update_estimate")(
            ex, wpool, _rows(wpool, B), z, z, z, d, w))
    return fn


class BucketPrewarmer:
    """Background warm thread: one daemon pops (pool, signature, bucket)
    tasks and runs the signature's warm builder at that bucket.

    ``register(pool, sig, warm_fn)`` is idempotent per signature and
    enqueues the whole bucket ladder on first sight; pool growth
    re-enqueues every signature of that pool (its signature changed).
    ``wait_idle`` blocks until the queue drains, then raises the first
    warm failure if there was one."""

    def __init__(self, executor, *, max_batch: int,
                 max_state_bytes: int = 1 << 28, obs=None):
        self._executor = executor
        self.max_batch = max_batch
        self.max_state_bytes = max_state_bytes
        self._q: "queue.Queue" = queue.Queue()
        self._sigs: dict = {}  # id(pool) -> {sig: warm_fn}
        self._pools: dict = {}  # id(pool) -> pool (keeps registration alive)
        self._warm_pools: dict = {}  # id(pool) -> (capacity, _WarmPool)
        self._lock = threading.Lock()
        self._outstanding = 0
        self._idle = threading.Condition(self._lock)
        self._closed = False
        self._failure: Optional[BaseException] = None
        self.warmed = 0  # completed warm tasks (test/bench introspection)
        self.errors = 0
        self._thread = threading.Thread(
            target=self._run, name="rtpu-prewarm", daemon=True
        )
        self._thread.start()
        # Interpreter teardown while the daemon worker sits inside a
        # device launch must not race the runtime's own teardown: join
        # the worker first.  Unregistered by a clean shutdown.
        atexit.register(self._join_at_exit)

    # -- registration ------------------------------------------------------

    def ladder(self) -> list:
        """Every padded bucket a serving batch can hit, floor → max_batch."""
        out, n = [], 1
        while n <= self.max_batch:
            b = self._executor._bucket(n)
            if not out or b != out[-1]:
                out.append(b)
            n *= 2
        return out

    def _pool_too_big(self, pool) -> bool:
        itemsize = np.dtype(pool.spec.dtype).itemsize
        return pool.capacity * pool.row_units * itemsize > self.max_state_bytes

    def register(self, pool, sig, warm_fn: Callable) -> bool:
        """Idempotently attach a warm signature to a pool and enqueue its
        bucket ladder.  Returns True when the signature was new."""
        if self._closed or self._pool_too_big(pool):
            return False
        with self._lock:
            sigs = self._sigs.setdefault(id(pool), {})
            if sig in sigs:
                return False
            sigs[sig] = warm_fn
            self._pools[id(pool)] = pool
            # Growth changes the pool signature: re-warm the ladder
            # against the new layout.
            pool.on_grow = self.on_pool_grow
            self._enqueue_locked(pool, warm_fn)
        return True

    def _enqueue_locked(self, pool, warm_fn) -> None:
        for b in self.ladder():
            self._outstanding += 1
            self._q.put((pool, warm_fn, b))

    def on_pool_grow(self, pool) -> None:
        if self._closed or self._pool_too_big(pool):
            return
        with self._lock:
            self._warm_pools.pop(id(pool), None)  # stale shape
            for warm_fn in self._sigs.get(id(pool), {}).values():
                self._enqueue_locked(pool, warm_fn)

    def rebind_executor(self, executor) -> None:
        """A live change_topology retired the executor this warmer was
        built around: adopt the successor, drop every scratch state (the
        layout changed) and re-run all registered ladders against it."""
        if self._closed:
            return
        with self._lock:
            self._executor = executor
            self._warm_pools.clear()
            for pid, sigs in self._sigs.items():
                pool = self._pools.get(pid)
                if pool is None or self._pool_too_big(pool):
                    continue
                for warm_fn in sigs.values():
                    self._enqueue_locked(pool, warm_fn)

    # -- worker ------------------------------------------------------------

    def _warm_pool_for(self, pool) -> _WarmPool:
        cached = self._warm_pools.get(id(pool))
        if cached is not None and cached[0] == pool.capacity:
            return cached[1]
        wp = _WarmPool(pool, self._executor)
        # Tag the cache with the capacity the scratch state was ACTUALLY
        # built at (wp.capacity), not a re-read of pool.capacity: a
        # growth landing between the two reads would tag a stale-shape
        # pool as current, and the re-warm ladder the growth enqueued
        # would then run against the old layout.
        self._warm_pools[id(pool)] = (wp.capacity, wp)
        return wp

    def _run(self) -> None:
        while True:
            task = self._q.get()
            if task is None:
                return
            pool, warm_fn, bucket = task
            try:
                if _chaos.ENABLED:  # prewarm fault point
                    _chaos.fire("prewarm")
                warm_fn(self._executor, self._warm_pool_for(pool), bucket)
                self.warmed += 1
            except Exception as exc:  # kept, and raised by wait_idle
                with self._lock:
                    self.errors += 1
                    if self._failure is None:
                        self._failure = exc
            finally:
                with self._lock:
                    # max(0): shutdown may have zeroed the counter while
                    # this task was in flight.
                    self._outstanding = max(0, self._outstanding - 1)
                    if self._outstanding == 0:
                        # Ladder drained: drop the scratch states (a warm
                        # pool can be hundreds of MB of device memory).
                        self._warm_pools.clear()
                        self._idle.notify_all()

    def pending(self) -> int:
        with self._lock:
            return self._outstanding

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until every enqueued warm task has run; True on drained.
        Raises the first warm failure (once), chained to its cause."""
        with self._idle:
            if self._outstanding:
                self._idle.wait_for(lambda: self._outstanding == 0, timeout)
            drained = self._outstanding == 0
            failure, self._failure = self._failure, None
        if failure is not None:
            raise RuntimeError(f"a pre-warm launch failed: {failure!r}") from failure
        return drained

    def _discard_pending(self) -> None:
        """Drop every queued (not yet started) warm task: only the
        in-flight one remains to wait out."""
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        with self._lock:
            self._outstanding = 0
            self._idle.notify_all()

    def shutdown(self, timeout: float = 5.0) -> None:
        self._closed = True
        self._discard_pending()
        self._q.put(None)
        self._thread.join(timeout=timeout)
        if not self._thread.is_alive():
            atexit.unregister(self._join_at_exit)
        self._warm_pools.clear()

    def _join_at_exit(self) -> None:
        """atexit hook: the worker must not be inside a launch when the
        interpreter tears down.  Bounded join."""
        self._closed = True
        self._discard_pending()
        self._q.put(None)
        self._thread.join(timeout=300.0)
