"""The port's locks and synchronizers, LocalCachedMap and JCache against
the JAX package's.

Two kinds of check:

* the JAX package's own tests run again on the port
  (``test_locks_batch_keys.py``'s lock, read-write lock, semaphore and
  rate-limiter classes; ``TestLocalCachedMap`` of
  ``test_wave2_objects.py`` and the LocalCachedMap classes of
  ``test_nearcache.py``; ``TestJCache`` of ``test_wave3_objects.py`` and
  every class of ``test_jcache_depth.py``; the lock, LocalCachedMap and
  JCache cases of ``test_coordination_fixes.py``; the keyspace and lock
  owner cases of ``test_review_regressions.py``).  ``port_class`` and
  ``port_case`` rebind a reference test's globals and imports to the
  port, so a body that builds its own client (``redisson_tpu.create(
  Config())``) or names a class of the JAX package gets the port's; the
  reference's asserts are the values the JAX package gives;
* differential traces: the same calls through a JAX client and a port
  client must give equal results (or equal error classes).

Time: where a reference case sleeps to let a lease, a TTL or an expiry
pass, the port's run advances an injected clock instead (``clock``: the
locks module's ``_now``, the grid modules' ``time.time`` and the test
body's ``time`` share one settable clock; the body's ``time.sleep``
advances it).  Threaded cases wait with a deadline, never a fixed sleep.

``port_class``, ``port_case``, ``clocked`` and the ``clock`` fixture are
shared with ``test_torch_services.py`` and ``test_torch_admin.py``.
"""

import builtins
import importlib
import inspect
import sys
import threading
import time
import types

import pytest

torch = pytest.importorskip("torch")

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
import test_coordination_fixes as _ref_fix  # noqa: E402
import test_jcache_depth as _ref_jdepth  # noqa: E402
import test_locks_batch_keys as _ref_locks  # noqa: E402
import test_nearcache as _ref_nc  # noqa: E402
import test_review_regressions as _ref_rev  # noqa: E402
import test_wave2_objects as _ref2  # noqa: E402
import test_wave3_objects as _ref3  # noqa: E402
from redisson_tpu_torch.grid import locks as port_locks  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- running the JAX package's tests on the port -------------------------------


class PortConfig(rt.Config):
    """The port's Config as a reference body builds the JAX one: the
    CPU device and the tests' small buckets, with ``use_tpu_sketch`` read
    as ``use_gpu_sketch``."""

    def __init__(self):
        super().__init__()
        self.use_gpu_sketch(device="cpu", min_bucket=64)

    def use_tpu_sketch(self, **kwargs):
        return self.use_gpu_sketch(**kwargs)


def port_create(config=None):
    config = config if config is not None else PortConfig()
    if not config.gpu_sketch.enabled:
        config.use_gpu_sketch(device="cpu", min_bucket=64)
    return rt.create(config)


class _PortPackage(types.ModuleType):
    """What ``import redisson_tpu`` gives a rebound body: the port
    package with ``create`` and ``Config`` defaulting to the CPU."""

    def __init__(self):
        super().__init__("redisson_tpu_torch")
        self.create = port_create
        self.Config = PortConfig

    def __getattr__(self, item):
        return getattr(rt, item)


class _PortConfigModule(types.ModuleType):
    def __init__(self):
        super().__init__("redisson_tpu_torch.config")
        self.Config = PortConfig

    def __getattr__(self, item):
        return getattr(importlib.import_module("redisson_tpu_torch.config"), item)


_PORT_PKG = _PortPackage()
_PORT_CONFIG = _PortConfigModule()


def _port_name(name: str) -> str:
    return "redisson_tpu_torch" + name[len("redisson_tpu"):]


def _is_ref(name) -> bool:
    return isinstance(name, str) and (
        name == "redisson_tpu" or name.startswith("redisson_tpu.")
    )


def _port_module(name: str):
    if name == "redisson_tpu":
        return _PORT_PKG
    if name == "redisson_tpu.config":
        return _PORT_CONFIG
    return importlib.import_module(_port_name(name))


def _port_module_or_none(name: str):
    try:
        return _port_module(name)
    except ImportError:  # a JAX module the port has no copy of
        return None


def _port_import(name, globals=None, locals=None, fromlist=(), level=0):
    if level == 0 and _is_ref(name):
        if fromlist:
            return _port_module(name)
        _port_module(name)  # ``import redisson_tpu.x.y`` binds the top
        return _PORT_PKG
    return builtins.__import__(name, globals, locals, fromlist, level)


_BUILTINS = dict(vars(builtins), __import__=_port_import)


def _port_value(v):
    if isinstance(v, types.ModuleType) and _is_ref(v.__name__):
        return _port_module_or_none(v.__name__) or v
    if v is redisson_tpu.Config:
        return PortConfig
    mod = getattr(v, "__module__", None)
    if (isinstance(v, type) or inspect.isfunction(v)) and _is_ref(mod):
        return getattr(_port_module_or_none(mod), v.__name__, v)
    return v


def port_case(fn, **overrides):
    """``fn`` with every name of the JAX package it reaches (its
    module's globals and the imports inside its body) bound to the port;
    ``overrides`` replace further globals (``time=clock``)."""
    g = {k: _port_value(v) for k, v in fn.__globals__.items()}
    g["__builtins__"] = _BUILTINS
    g.update(overrides)
    new = types.FunctionType(
        fn.__code__, g, fn.__name__, fn.__defaults__, fn.__closure__
    )
    new.__kwdefaults__ = fn.__kwdefaults__
    new.__doc__ = fn.__doc__
    return new


def port_class(ref, skip=(), clock=()):
    """A subclass of the reference test class whose every method runs
    rebound to the port (``port_case``); methods named in ``clock`` take
    the ``clock`` fixture as the body's ``time``; methods named in
    ``skip`` are not collected."""
    ns = {"__module__": sys._getframe(1).f_globals["__name__"]}
    for klass in reversed(ref.__mro__[:-1]):
        for name, fn in vars(klass).items():
            if inspect.isfunction(fn):
                ns[name] = clocked(fn) if name in clock else port_case(fn)
    for name in skip:
        ns[name] = None
    return type(ref.__name__, (ref,), ns)


def clocked(fn):
    """A test running ``fn``'s body on the port with the ``clock``
    fixture as its ``time`` module (its ``sleep`` advances the clock)."""
    sig = inspect.signature(fn)
    params = list(sig.parameters.values())
    names = [p.name for p in params]

    def run(*args, **kwargs):
        ck = kwargs.pop("clock")
        return port_case(fn, time=ck.body)(*args, **kwargs)

    run.__name__ = fn.__name__
    run.__doc__ = fn.__doc__
    if "clock" not in names:
        params.append(
            inspect.Parameter("clock", inspect.Parameter.KEYWORD_ONLY)
        )
    run.__signature__ = sig.replace(parameters=params)
    return run


# -- the clock -------------------------------------------------------------------


class Clock:
    """One settable clock behind three views: ``grid`` (a ``time`` module
    for the grid modules: ``time()`` settable, ``sleep``/``monotonic``
    real, so their sweeper threads keep their cadence), ``body`` (the
    test body's ``time``: ``time()`` and ``monotonic()`` settable,
    ``sleep`` advances) and ``now_mono`` (the locks module's ``_now``)."""

    def __init__(self):
        self.epoch = time.time()
        self.mono = time.monotonic()
        clock = self

        class _Grid(types.ModuleType):
            def time(self):
                return clock.epoch

            def __getattr__(self, item):
                return getattr(time, item)

        class _Body(_Grid):
            def monotonic(self):
                return clock.mono

            def sleep(self, s):
                clock.advance(s)

        self.grid = _Grid("time")
        self.body = _Body("time")

    def advance(self, s: float) -> None:
        self.epoch += s
        self.mono += s

    def now_mono(self) -> float:
        return self.mono


_CLOCKED = ("store", "maps", "multimaps", "collections", "queues", "streams",
            "timeseries", "buckets", "counters", "geo", "jcache")


@pytest.fixture
def clock(monkeypatch):
    ck = Clock()
    for pkg in ("redisson_tpu", "redisson_tpu_torch"):
        for m in _CLOCKED:
            mod = importlib.import_module(f"{pkg}.grid.{m}")
            if hasattr(mod, "time"):
                monkeypatch.setattr(mod, "time", ck.grid)
        locks = importlib.import_module(f"{pkg}.grid.locks")
        monkeypatch.setattr(locks, "_now", ck.now_mono)
        monkeypatch.setattr(locks, "time", ck.body)
    return ck


def _port_client(**kw):
    kw.setdefault("min_bucket", 64)
    return rt.create(rt.Config().use_gpu_sketch(device="cpu", **kw))


@pytest.fixture
def client():
    c = _port_client()
    yield c
    c.shutdown()


@pytest.fixture
def clients():
    jc = redisson_tpu.create(redisson_tpu.Config().use_tpu_sketch(min_bucket=64))
    tc = _port_client()
    yield jc, tc
    tc.shutdown()
    jc.shutdown()


@pytest.fixture
def manager(client):
    return client.get_cache_manager()


def wait_for(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.005)


def both(clients, fn):
    """Run ``fn(client)`` on each package; results (or error types) must
    be equal."""
    out = []
    for c in clients:
        try:
            out.append(("ok", fn(c)))
        except Exception as e:  # the error class is part of the contract
            out.append(("err", type(e).__name__))
    assert out[0] == out[1], out
    return out[1][1]


def trace(clients, fn):
    """``both`` for a call trace that must run to its end on each
    package (an error there would hide the calls after it)."""
    out = both(clients, fn)
    assert not (isinstance(out, str) and out.endswith(("Error", "Exception"))), out
    return out


# -- locks and synchronizers ---------------------------------------------------


class TestLock(port_class(_ref_locks.TestLock)):
    def test_lease_expiry(self, client, clock):
        lk = client.get_lock("L5")
        lk.lock(lease_seconds=0.15)
        assert 0 < lk.remain_lease_time() <= 150
        clock.advance(0.2)
        assert lk.remain_lease_time() == -2
        got = []
        t = threading.Thread(target=lambda: got.append(lk.try_lock(0.0)))
        t.start()
        t.join()
        assert got == [True]  # lease expired, other thread took it

    def test_fair_lock_fifo(self, client):
        # The reference sleeps so each waiter joins the queue in turn;
        # here each start waits until the queue holds it.
        lk = client.get_fair_lock("FA")
        lk.lock()
        order, threads = [], []

        def queued():
            with client._grid.lock:
                e = client._grid.get_entry("FA", "fairlock")
                return 0 if e is None else len(e.value["queue"])

        for i in range(3):
            t = threading.Thread(
                target=lambda n=i: (lk.lock(), order.append(n), lk.unlock())
            )
            t.start()
            wait_for(lambda: queued() == i + 1)
            threads.append(t)
        lk.unlock()
        [t.join() for t in threads]
        assert order == [0, 1, 2]


class TestReadWriteLock(port_class(_ref_locks.TestReadWriteLock)):
    pass


class TestSemaphores(port_class(
        _ref_locks.TestSemaphores, clock=("test_permit_lease_expiry",))):
    pass


class TestRateLimiter(port_class(
        _ref_locks.TestRateLimiter, clock=("test_rate_enforced",))):
    pass


class TestRound3AdviceFixes(port_class(
        _ref_rev.TestRound3AdviceFixes,
        skip=[n for n in vars(_ref_rev.TestRound3AdviceFixes)
              if n.startswith("test_") and n not in (
                  "test_cross_backend_wrongtype_grid_then_sketch",
                  "test_cross_backend_wrongtype_sketch_then_grid",
                  "test_readonly_lock_queries_do_not_materialize",
                  "test_set_if_exists_clears_ttl",
                  "test_lock_owner_uses_client_uuid",
                  "test_cross_backend_guard_no_deadlock",
              )])):
    pass


test_lock_keyspace_hygiene = port_case(_ref_fix.test_lock_keyspace_hygiene)
test_fencing_tokens_survive_release = port_case(
    _ref_fix.test_fencing_tokens_survive_release)


# -- LocalCachedMap --------------------------------------------------------------


class TestLocalCachedMap(port_class(_ref2.TestLocalCachedMap)):
    pass


class TestLocalCachedMapSharedStore(port_class(
        _ref_nc.TestLocalCachedMapSharedStore)):
    pass


class TestLocalCachedMapCrossHandleSharing(port_class(
        _ref_nc.TestLocalCachedMapCrossHandleSharing)):
    pass


test_local_cached_map_conditional_remove_none = port_case(
    _ref_fix.test_local_cached_map_conditional_remove_none)
test_local_cached_map_replace_invalidates_peers = port_case(
    _ref_fix.test_local_cached_map_replace_invalidates_peers)
test_local_cached_map_preload = port_case(_ref_fix.test_local_cached_map_preload)


# -- JCache ------------------------------------------------------------------------


class TestJCache(port_class(_ref3.TestJCache, clock=("test_default_ttl",))):
    pass


class TestEntryListeners(port_class(
        _ref_jdepth.TestEntryListeners,
        clock=("test_expired_event_fires_on_lazy_reap",))):
    pass


class TestReadWriteThrough(port_class(_ref_jdepth.TestReadWriteThrough)):
    pass


class TestStatistics(port_class(_ref_jdepth.TestStatistics)):
    pass


class TestExpiryPolicy(port_class(
        _ref_jdepth.TestExpiryPolicy,
        clock=[n for n in vars(_ref_jdepth.TestExpiryPolicy)
               if n.startswith("test_")])):
    pass


class TestJCacheReviewFixes(port_class(
        _ref_jdepth.TestReviewFixes,
        clock=("test_update_ttl_applies_on_plain_put",))):
    pass


class TestJCacheSweepFixes(port_class(
        importlib.import_module("test_liveobject_tx_r5").TestJCacheSweepFixes)):
    pass


test_jcache_get_cache_none_when_absent = port_case(
    _ref_fix.test_jcache_get_cache_none_when_absent)


# -- the rebinding itself --------------------------------------------------------


def test_rebound_bodies_reach_the_port(client):
    """A rebound reference body builds port clients and port classes: the
    harness above proves nothing unless this holds."""

    def body():
        import redisson_tpu
        from redisson_tpu.grid.locks import Lock

        c = redisson_tpu.create(Config())
        try:
            return type(c).__module__, Lock.__module__, TransactionException
        finally:
            c.shutdown()

    g = {"Config": redisson_tpu.Config,
         "TransactionException": redisson_tpu.grid.TransactionException}
    fn = types.FunctionType(body.__code__, g)
    got = port_case(fn)()
    assert got == ("redisson_tpu_torch.client", "redisson_tpu_torch.grid.locks",
                   rt.grid.TransactionException)
    assert port_locks.Lock is rt.grid.Lock


def test_clock_drives_lock_leases_and_grid_ttls(client, clock):
    lk = client.get_lock("ck-lease")
    lk.lock(lease_seconds=10.0)
    b = client.get_bucket("ck-ttl")
    b.set("v", ttl_seconds=10.0)
    clock.advance(9.9)
    assert lk.is_locked() and b.get() == "v"
    clock.advance(0.2)
    assert not lk.is_locked() and b.get() is None


# -- differential traces ---------------------------------------------------------


def test_lock_trace(clients, clock):
    def run(c):
        out = []
        lk, fl, sl = c.get_lock("t-l"), c.get_fair_lock("t-f"), c.get_spin_lock("t-s")
        fen = c.get_fenced_lock("t-fen")
        lk.lock()
        lk.lock(lease_seconds=5.0)
        out += [lk.is_locked(), lk.get_hold_count(), lk.remain_lease_time(),
                lk.is_held_by_current_thread()]
        lk.unlock()
        lk.unlock()
        out += [lk.is_locked(), lk.remain_lease_time(), lk.force_unlock()]
        out += [fl.try_lock(), sl.try_lock(), fl.get_hold_count()]
        fl.unlock()
        sl.unlock()
        out += [fen.lock_and_get_token(), fen.get_token()]
        fen.unlock()
        out += [fen.lock_and_get_token()]
        fen.unlock()
        lk.lock(lease_seconds=1.0)
        clock.advance(1.5)
        out += [lk.is_locked(), lk.remain_lease_time()]
        ml = c.get_multi_lock(c.get_lock("t-m1"), c.get_lock("t-m2"))
        out += [ml.try_lock(), c.get_lock("t-m1").is_locked()]
        ml.unlock()
        out += [c.get_lock("t-m2").is_locked()]
        try:
            c.get_lock("t-free").unlock()
        except RuntimeError as e:
            out.append(type(e).__name__)
        out.append(sorted(c.get_keys().get_keys()))
        return out

    trace(clients, run)


def test_synchronizer_trace(clients, clock):
    def run(c):
        out = []
        rw = c.get_read_write_lock("t-rw")
        r, w = rw.read_lock(), rw.write_lock()
        out += [r.try_lock(), w.try_lock()]  # the reader may not upgrade
        r.unlock()
        out += [w.try_lock(), r.try_lock()]  # the writer downgrades
        r.unlock()
        w.unlock()
        s = c.get_semaphore("t-sem")
        out += [s.available_permits(), s.try_set_permits(3), s.try_set_permits(4),
                s.try_acquire(2), s.try_acquire(2), s.available_permits()]
        s.release(5)
        out += [s.available_permits(), s.drain_permits(), s.available_permits()]
        ps = c.get_permit_expirable_semaphore("t-ps")
        out += [ps.try_set_permits(2)]
        p1 = ps.try_acquire(lease_seconds=1.0)
        p2 = ps.try_acquire()
        out += [p1 is not None, p2 is not None, ps.try_acquire() is None,
                ps.available_permits()]
        clock.advance(1.5)
        out += [ps.available_permits(), ps.try_release(p1), ps.try_release(p2),
                ps.available_permits()]
        cdl = c.get_count_down_latch("t-cdl")
        out += [cdl.get_count(), cdl.try_set_count(2), cdl.try_set_count(5)]
        cdl.count_down()
        out += [cdl.get_count(), cdl.wait_for(0.0)]
        cdl.count_down()
        cdl.count_down()
        out += [cdl.get_count(), cdl.wait_for(0.0)]
        rl = c.get_rate_limiter("t-rl")
        out += [rl.available_permits(), rl.try_set_rate(rl.OVERALL, 4, 1.0),
                rl.try_set_rate(rl.OVERALL, 9, 1.0), rl.try_acquire(3),
                rl.try_acquire(2), rl.available_permits()]
        clock.advance(1.0)
        out += [rl.available_permits(), rl.try_acquire(4)]
        rl.set_rate(rl.PER_CLIENT, 2, 5.0)
        out += [rl.available_permits(), rl.try_acquire(2), rl.try_acquire()]
        for bad in (lambda: rl.try_acquire(3), lambda: rl.try_set_rate("x", 1, 1)):
            try:
                bad()
            except ValueError as e:
                out.append(type(e).__name__)
        out.append(sorted(c.get_keys().get_keys()))
        return out

    trace(clients, run)


def test_local_cached_map_trace(clients):
    def run(c):
        out = []
        a = c.get_local_cached_map("t-lcm", cache_size=8)
        b = c.get_local_cached_map("t-lcm", sync_strategy="update")
        for i in range(20):
            a.put(f"k{i}", i)
        c._topic_bus.drain(timeout=10)
        out += [a.get("k3"), b.get("k3"), a.cached_size() <= 8]
        out += [a.put_if_absent("k3", 99), a.replace("k4", 40), b.get("k4")]
        out += [a.remove("k5"), a.remove("k6", 7), a.remove("k6", 6), b.get("k6")]
        b.put("k7", "seven")
        c._topic_bus.drain(timeout=10)
        out += [a.get("k7"), sorted(a.read_all_map().items())[:4], a.size()]
        out += [a.fast_put("n", 1), a.fast_remove("n", "k8"), b.contains_key("k8")]
        a.clear_local_cache()
        out += [a.cached_size(), a.get("k9"), a.get_all(["k1", "k2", "nope"])]
        try:
            c.get_local_cached_map("t-lcm", sync_strategy="bogus")
        except ValueError as e:
            out.append(type(e).__name__)
        return out

    trace(clients, run)


def test_jcache_trace(clients, clock):
    def run(c):
        out = []
        mgr = c.get_cache_manager()
        jc = mgr.create_cache("t-jc", statistics_enabled=True)
        jc.put("a", 1)
        jc.put_all({"b": 2, "c": 3})
        out += [jc.get("a"), jc.get("zz"), jc.contains_key("b"),
                jc.put_if_absent("a", 9), jc.get_and_put("a", 10),
                jc.replace("b", 20), jc.replace("b", 99, 21),
                jc.replace("c", 30), jc.remove("c", 31), jc.remove("c"),
                jc.get_and_remove("b"), sorted(jc.get_all(["a", "b", "c"]).items())]
        st = jc.statistics
        out += [(st.hits, st.misses, st.puts, st.removals)]
        ttl = mgr.create_cache("t-jc-ttl", default_ttl_seconds=1.0)
        ttl.put("k", "v")
        clock.advance(1.5)
        out += [ttl.get("k"), sorted(mgr.get_cache_names())]
        mgr.destroy_cache("t-jc-ttl")
        out += [mgr.get_cache("t-jc-ttl") is None]
        try:
            mgr.create_cache("t-jc")
        except Exception as e:  # an existing name
            out.append(type(e).__name__)
        return out

    trace(clients, run)


def test_lock_waiters_wake_on_unlock_across_packages(clients):
    """The store's condition is the unlock channel on both packages: a
    parked ``lock()`` wakes on the holder's unlock, never on a poll."""
    for c in clients:
        lk = c.get_lock("wake")
        lk.lock()
        got = []
        t = threading.Thread(target=lambda: (lk.lock(), got.append(1), lk.unlock()))
        t.start()
        wait_for(lambda: len(c._grid.cond._waiters) > 0)
        lk.unlock()
        t.join(timeout=5)
        assert got == [1] and not lk.is_locked()
