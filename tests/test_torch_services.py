"""The port's coordination services — the executor with its schedules and
cron, remote services, transactions, scripts and functions, live objects,
map-reduce — and the integrations and the reactive facade, against the
JAX package's.

* The JAX package's own tests run again on the port: every class of
  ``test_services.py``, ``test_function_service.py``,
  ``test_liveobject_tx_r5.py`` (its JCache class runs in
  ``test_torch_grid_coordination.py``), ``test_integrations.py``,
  ``test_reactive.py`` and the executor, remote, transaction, reactive
  and integration cases of ``test_coordination_fixes.py``, rebound to
  the port by ``port_class``/``port_case`` (see
  ``test_torch_grid_coordination.py``).  The integrations' TTL and
  session-expiry cases advance the injected clock instead of sleeping.
* Differential traces: the same calls through a JAX client and a port
  client give equal results (or equal error classes).

The executor's schedule, fixed-rate and cron cases run on the wall clock,
as the reference does: their waits are the schedules themselves (a timer
thread firing tasks on worker threads), not a lease or a TTL to let pass.
"""

import asyncio
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu_torch as rt  # noqa: E402
import test_coordination_fixes as _ref_fix  # noqa: E402
import test_function_service as _ref_fn  # noqa: E402
import test_integrations as _ref_int  # noqa: E402
import test_liveobject_tx_r5 as _ref_lo  # noqa: E402
import test_reactive as _ref_rx  # noqa: E402
import test_services as _ref_svc  # noqa: E402
from test_torch_grid_coordination import (  # noqa: E402,F401
    _one_torch_thread,
    clients,
    client,
    clock,
    port_case,
    port_class,
    trace,
    wait_for,
)


# -- the JAX package's tests on the port ------------------------------------------


class TestExecutorService(port_class(_ref_svc.TestExecutorService)):
    pass


class TestRemoteService(port_class(_ref_svc.TestRemoteService)):
    pass


class TestTransaction(port_class(_ref_svc.TestTransaction)):
    pass


class TestScriptService(port_class(_ref_svc.TestScriptService)):
    pass


class TestLiveObjects(port_class(_ref_svc.TestLiveObjects)):
    pass


class TestMapReduce(port_class(_ref_svc.TestMapReduce)):
    pass


class TestServiceHandleSharing(port_class(_ref_svc.TestServiceHandleSharing)):
    pass


class TestServicesDepthR4(port_class(_ref_svc.TestServicesDepthR4)):
    pass


class TestServicesReviewFixesR4(port_class(_ref_svc.TestServicesReviewFixesR4)):
    pass


test_load_and_fcall = port_case(_ref_fn.test_load_and_fcall)
test_fcall_ro_contract = port_case(_ref_fn.test_fcall_ro_contract)
test_unknown_function = port_case(_ref_fn.test_unknown_function)
test_library_replace_and_global_names = port_case(
    _ref_fn.test_library_replace_and_global_names)
test_list_delete_flush = port_case(_ref_fn.test_list_delete_flush)
test_camel_aliases = port_case(_ref_fn.test_camel_aliases)


class TestLiveObjectFind(port_class(_ref_lo.TestLiveObjectFind)):
    pass


class TestTxList(port_class(_ref_lo.TestTxList)):
    pass


class TestTxScoredSortedSet(port_class(_ref_lo.TestTxScoredSortedSet)):
    pass


class TestTxListReadYourRemoves(port_class(_ref_lo.TestTxListReadYourRemoves)):
    pass


class TestGridSweepFixes(port_class(_ref_lo.TestGridSweepFixes)):
    pass


class TestCachedDecorator(port_class(
        _ref_int.TestCachedDecorator, clock=("test_ttl",))):
    pass


class TestCacheManagerAdapter(port_class(
        _ref_int.TestCacheManagerAdapter, clock=("test_named_configs",))):
    pass


class TestSessionStore(port_class(
        _ref_int.TestSessionStore, clock=("test_inactivity_expiry_and_touch",))):
    pass


test_reactive_bloom_roundtrip = port_case(_ref_rx.test_reactive_bloom_roundtrip)
test_reactive_grid_objects_and_camelcase = port_case(
    _ref_rx.test_reactive_grid_objects_and_camelcase)
test_reactive_runs_off_event_loop = port_case(
    _ref_rx.test_reactive_runs_off_event_loop)
test_reactive_many_blocking_ops_no_pool_deadlock = port_case(
    _ref_rx.test_reactive_many_blocking_ops_no_pool_deadlock)
test_reactive_async_named_methods_resolve_to_values = port_case(
    _ref_rx.test_reactive_async_named_methods_resolve_to_values)
test_reactive_concurrent_awaitables = port_case(
    _ref_rx.test_reactive_concurrent_awaitables)
test_reactive_bounded_pool_for_nonblocking_ops = port_case(
    _ref_rx.test_reactive_bounded_pool_for_nonblocking_ops)
test_blocking_ops_still_cannot_starve_each_other = port_case(
    _ref_rx.test_blocking_ops_still_cannot_starve_each_other)

test_cancelled_periodic_never_resurrects = port_case(
    _ref_fix.test_cancelled_periodic_never_resurrects)
test_transaction_wrongtype_write_applies_nothing = port_case(
    _ref_fix.test_transaction_wrongtype_write_applies_nothing)
test_remote_reregister_shuts_down_previous_workers = port_case(
    _ref_fix.test_remote_reregister_shuts_down_previous_workers)
test_reactive_returns_plain_future_objects = port_case(
    _ref_fix.test_reactive_returns_plain_future_objects)
test_cached_functions_do_not_collide = port_case(
    _ref_fix.test_cached_functions_do_not_collide)


# -- the port's own cases -----------------------------------------------------------


def test_reactive_awaits_unwrap_the_ports_futures(client):
    """Awaiting an ``*_async`` method yields its value: the unwrap keys on
    the port's own package, whose futures (the coalescer's HintedFuture,
    the grid pool's) are not the JAX package's."""
    rc = client.reactive()
    bf = client.get_bloom_filter("rx-unwrap")
    bf.try_init(10_000, 0.01)
    keys = np.arange(64, dtype=np.uint64)

    async def main():
        rbf = rc.get_bloom_filter("rx-unwrap")
        added = await rbf.add_all_async(keys)
        hits = await rbf.contains_all_async(keys)
        return added, hits

    added, hits = asyncio.run(main())
    assert type(added).__module__.split(".")[0] != "redisson_tpu_torch"
    assert int(np.sum(np.asarray(added))) == 64
    assert bool(np.all(np.asarray(hits)))


@pytest.fixture
def long_client():
    from redisson_tpu_torch.codecs import LongCodec

    c = rt.create(rt.Config().set_codec(LongCodec()).use_gpu_sketch(
        device="cpu", min_bucket=64))
    yield c
    c.shutdown()


def test_executor_tasks_drive_the_sketch_engine(long_client):
    """Executor workers are plain client threads: a task may drive a
    sketch object, as chip_smoke phase 13b drives K1 (its plain version
    here), and each task's estimates and table equal ``golden_seq``."""
    from redisson_tpu_torch.ops import cms_seq
    from redisson_tpu_torch.utils import hashing

    client = long_client
    d, w = 4, 1 << 10
    ex = client.get_executor_service("ex-cms")
    ex.register_workers(2)
    rng = np.random.default_rng(9)
    streams = [rng.integers(0, 500, size=3000, dtype=np.uint64) for _ in range(2)]
    eng = client._engine

    def task(i):
        cms = client.get_count_min_sketch(f"ex-cms-{i}")
        cms.try_init(d, w)
        est = np.asarray(cms.add_all_seq(streams[i]))
        eng._drain()
        e = eng.registry.lookup(f"ex-cms-{i}")
        return est, np.asarray(eng.executor.read_row(e.pool, e.row))

    futs = [ex.submit(task, i) for i in range(2)]
    for i, f in enumerate(futs):
        est, row = f.result(60)
        h1w, h2w = hashing.km_reduce_mod(
            *hashing.hash128_np(*hashing.encode_uint64_batch(streams[i])), w)
        table, want = cms_seq.golden_seq(
            np.zeros((d, w), np.uint32), h1w, h2w,
            np.ones(len(streams[i]), np.uint32), d=d, w=w)
        assert np.array_equal(est, want)
        assert np.array_equal(row.view(np.uint32)[: d * w].reshape(d, w), table)
    ex.shutdown()


# -- differential traces ------------------------------------------------------------


def test_executor_and_remote_trace(clients):
    def run(c):
        out = []
        ex = c.get_executor_service("t-ex")
        out += [ex.get_name(), ex.is_shutdown()]
        f0 = ex.submit(lambda: "queued")
        out += [ex.get_task_count(), f0.done()]
        ex.register_workers(2)
        out += [f0.result(5), [ex.submit(pow, i, 2).result(5) for i in range(5)]]
        err = ex.submit(lambda: 1 / 0)
        try:
            err.result(5)
        except ZeroDivisionError as e:
            out.append(type(e).__name__)
        out += [c.get_executor_service("t-ex") is ex]
        ex.shutdown()
        out += [ex.is_shutdown(), c.get_executor_service("t-ex") is ex]
        try:
            ex.submit(lambda: 1)
        except RuntimeError as e:
            out.append(type(e).__name__)
        rs = c.get_remote_service("t-rs")

        class Calc:
            def add(self, a, b):
                return a + b

            def fail(self):
                raise KeyError("nope")

        rs.register("Calc", Calc(), workers=2)
        p = rs.get("Calc")
        out += [p.add(2, 3), rs.get_async("Calc").add(4, 5).result(5)]
        for call in (p.fail, lambda: rs.get("Missing").add(1, 2)):
            try:
                call()
            except Exception as e:
                out.append(type(e).__name__)
        rs.deregister("Calc")
        try:
            p.add(1, 1)
        except RuntimeError as e:
            out.append(type(e).__name__)
        out += [c.get_remote_service("t-rs") is rs]
        return out

    trace(clients, run)


def test_transaction_trace(clients):
    def run(c):
        out = []
        c.get_bucket("tx-b").set("b0")
        c.get_map("tx-m").put("k", 1)
        c.get_set("tx-s").add("s0")
        c.get_list("tx-l").add("l0")
        c.get_scored_sorted_set("tx-z").add(1.0, "z0")
        tx = c.create_transaction()
        tb, tm = tx.get_bucket("tx-b"), tx.get_map("tx-m")
        ts, tl, tz = tx.get_set("tx-s"), tx.get_list("tx-l"), tx.get_scored_sorted_set("tx-z")
        out += [tb.get(), tm.get("k"), ts.contains("s0"), tl.read_all(), tz.get_score("z0")]
        tb.set("b1")
        tm.put("k", 2)
        tm.put("k2", 3)
        ts.add("s1")
        ts.remove("s0")
        tl.add("l1")
        tz.add(2.0, "z1")
        out += [tb.get(), tm.get("k"), ts.contains("s1"), tl.read_all(),
                tz.get_score("z1"), c.get_bucket("tx-b").get()]
        tx.commit()
        out += [c.get_bucket("tx-b").get(), sorted(c.get_map("tx-m").read_all_map().items()),
                sorted(c.get_set("tx-s").read_all()), c.get_list("tx-l").read_all(),
                c.get_scored_sorted_set("tx-z").get_score("z1")]
        tx2 = c.create_transaction()
        tx2.get_map("tx-m").get("k")
        c.get_map("tx-m").put("k", 99)
        tx2.get_map("tx-m").put("k", 7)
        try:
            tx2.commit()
        except Exception as e:
            out.append(type(e).__name__)
        out += [c.get_map("tx-m").get("k")]
        tx3 = c.create_transaction()
        tx3.get_bucket("tx-b").set("gone")
        tx3.rollback()
        for call in (tx3.commit, tx3.rollback):
            try:
                call()
            except Exception as e:
                out.append(type(e).__name__)
        out += [c.get_bucket("tx-b").get()]
        return out

    trace(clients, run)


def test_script_function_liveobject_mapreduce_trace(clients):
    class Item:
        def __init__(self, id, name, qty):
            self.id, self.name, self.qty = id, name, qty

    def run(c):
        out = []
        s = c.get_script()
        s.register("bump", lambda cl, keys, args: cl.get_atomic_long(keys[0]).add_and_get(args[0]))
        out += [s.eval("bump", keys=["sc-a"], args=[3]), s.eval("bump", keys=["sc-a"], args=[4]),
                c.get_script() is s]
        try:
            s.eval("nope")
        except KeyError as e:
            out.append(type(e).__name__)
        f = c.get_function()
        f.load("lib", {"get": lambda cl, keys, args: cl.get_atomic_long(keys[0]).get()})
        out += [f.call("get", keys=["sc-a"]), sorted(x["library_name"] for x in f.list())]
        live = c.get_live_object_service()
        p = live.persist(Item(1, "bolt", 5), index=("name",))
        p.qty = 9
        live.persist(Item(2, "nut", 1), index=("name",))
        out += [live.get(Item, 1).qty, live.count(Item), sorted(live.list_ids(Item)),
                [q._rid for q in live.find_by_field(Item, "name", "nut")],
                live.delete(Item, 2), live.exists(Item, 2)]
        m = c.get_map("mr-src")
        for i in range(30):
            m.put(f"d{i}", " ".join(["w%d" % (j % 7) for j in range(i % 5 + 1)]))
        mr = c.get_map_reduce(m, workers=3, chunk_size=4)
        counts = (mr.mapper(lambda k, v: [(w, 1) for w in v.split()])
                  .reducer(lambda k, vals: sum(vals)).execute())
        out += [sorted(counts.items())]
        return out

    trace(clients, run)


def test_reactive_trace(clients):
    def run(c):
        rc = c.reactive()

        async def main():
            bf = rc.get_bloom_filter("rx-t")
            out = [await bf.try_init(5000, 0.01)]
            out += [int(await bf.add_all(np.arange(200, dtype=np.uint64)))]
            out += [np.asarray(await bf.contains_all(np.arange(190, 210, dtype=np.uint64))).tolist()]
            m = rc.get_map("rx-tm")
            await asyncio.gather(*[m.put(f"k{i}", i) for i in range(20)])
            out += [await m.size(), await m.get("k7")]
            ctr = rc.get_atomic_long("rx-ctr")
            await asyncio.gather(*[ctr.add_and_get(i) for i in range(10)])
            out += [await ctr.get()]
            return out

        return asyncio.run(main())

    trace(clients, run)


def test_integrations_trace(clients, clock):
    from redisson_tpu import integrations as jint
    from redisson_tpu_torch import integrations as tint

    def run(c):
        mod = tint if type(c).__module__.startswith("redisson_tpu_torch") else jint
        calls = []

        @mod.cached(c, "int-c", ttl_seconds=1.0)
        def sq(x):
            calls.append(x)
            return x * x

        out = [sq(3), sq(3), list(calls)]
        clock.advance(1.5)
        out += [sq(3), list(calls)]
        mgr = mod.CacheManagerAdapter(c, {"short": {"ttl_seconds": 1.0}})
        mgr.get_cache("short").put("k", 1)
        mgr.get_cache("other").put("k", 2)
        out += [sorted(mgr.get_cache_names())]
        clock.advance(1.5)
        out += [mgr.get_cache("short").get("k"), mgr.get_cache("other").get("k")]
        store = mod.SessionStore(c, max_inactive_seconds=1.0)
        sess = store.create()
        sess["u"] = 1
        sess.save()
        out += [store.load(sess.session_id)["u"]]
        clock.advance(1.5)
        out += [store.load(sess.session_id)]
        return out

    trace(clients, run)


def test_executor_worker_threads_run_concurrently(client):
    """``register_workers(n)`` runs n tasks at once (a barrier of n
    parties completes), on both the executor and the remote service."""
    ex = client.get_executor_service("ex-par")
    ex.register_workers(4)
    barrier = threading.Barrier(4, timeout=10)
    futs = [ex.submit(barrier.wait) for _ in range(4)]
    assert sorted(f.result(10) for f in futs) == [0, 1, 2, 3]
    ex.shutdown()
