"""The port's data grid — maps, multimaps, sets, lists, sorted sets, the
queue family, streams, geo, time series and topics — against the JAX
package's.

Two kinds of check:

* the JAX package's own per-object tests (``tests/test_grid_objects.py``,
  the multimap/stream/reliable-topic cases of ``test_wave2_objects.py``,
  the geo/time-series/queue cases of ``test_wave3_objects.py``, the
  map-listener and sharded-topic cases of ``test_wave4_objects.py`` and
  the grid cases of ``test_batch_pipelining.py``) run again with a port
  client (``device="cpu"``) in place of the JAX one: the reference's
  asserts are the values the JAX package gives;
* differential traces: the same calls through a JAX client and a port
  client must give equal results (or equal error classes), and the grid
  snapshot, written by the facades of every kind, must be byte-identical
  both ways.

Time-dependent cases (TTLs, max-idle, stream idle times) advance an
injected clock instead of sleeping: ``clock`` replaces the ``time``
module of the grid modules of both packages with a settable clock.
Threaded cases wait for a taker to park on the store's condition with a
deadline, never for a fixed sleep.
"""

import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
import test_batch_pipelining as _ref_batch  # noqa: E402
import test_grid_objects as _ref  # noqa: E402
import test_wave2_objects as _ref2  # noqa: E402
import test_wave3_objects as _ref3  # noqa: E402
import test_wave4_objects as _ref4  # noqa: E402
from redisson_tpu_torch.grid.store import GridStore  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


_CLOCKED = ("store", "maps", "multimaps", "collections", "queues", "streams",
            "timeseries", "buckets", "counters", "geo")


class _Clock(types.ModuleType):
    """A ``time`` module whose ``time()`` reads a settable epoch clock;
    everything else (``monotonic``, ``sleep``) is the real module's."""

    def __init__(self):
        super().__init__("time")
        self.start = self.now = time.time()

    def reset(self) -> None:
        """Back to the start: each package's run of a trace sees the
        same clock."""
        self.now = self.start

    def time(self):
        return self.now

    def advance(self, s: float) -> None:
        self.now += s

    def __getattr__(self, item):
        return getattr(time, item)


@pytest.fixture
def clock(monkeypatch):
    import importlib

    ck = _Clock()
    for pkg in ("redisson_tpu", "redisson_tpu_torch"):
        for m in _CLOCKED:
            mod = importlib.import_module(f"{pkg}.grid.{m}")
            if hasattr(mod, "time"):
                monkeypatch.setattr(mod, "time", ck)
    return ck


def _wait_for(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.005)


def _parked(client):
    """True once some thread waits on the grid store's condition."""
    return lambda: len(client._grid.cond._waiters) > 0


def _both(clients, fn):
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


def _trace(clients, fn):
    """``_both`` for a call trace that must run to its end on each
    package (an error there would hide the calls after it)."""
    out = _both(clients, fn)
    assert not (isinstance(out, str) and out.endswith("Error")), out
    return out


# -- the JAX package's per-object tests on the port ---------------------------


class TestBucket(_ref.TestBucket):
    def test_ttl(self, client, clock):
        b = client.get_bucket("b5")
        b.set("ephemeral", ttl_seconds=0.15)
        assert b.get() == "ephemeral"
        assert 0 < b.remain_time_to_live() <= 150
        clock.advance(0.2)
        assert b.get() is None
        assert b.remain_time_to_live() == -2


class TestBinaryStream(_ref.TestBinaryStream):
    pass


class TestCounters(_ref.TestCounters):
    pass


class TestMap(_ref.TestMap):
    def test_map_cache_entry_ttl(self, client, clock):
        mc = client.get_map_cache("mc1")
        mc.put("t", "gone", ttl_seconds=0.15)
        mc.put("p", "stays")
        assert mc.get("t") == "gone"
        assert mc.remain_time_to_live_entry("t") > 0
        assert mc.remain_time_to_live_entry("p") == -1
        clock.advance(0.2)
        assert mc.get("t") is None
        assert mc.get("p") == "stays"
        assert mc.size() == 1

    def test_map_cache_max_idle(self, client, clock):
        mc = client.get_map_cache("mc2")
        mc.put("i", "v", max_idle_seconds=0.2)
        clock.advance(0.1)
        assert mc.get("i") == "v"  # access refreshes idle clock
        clock.advance(0.15)
        assert mc.get("i") == "v"
        clock.advance(0.25)
        assert mc.get("i") is None


class TestSet(_ref.TestSet):
    def test_set_cache_ttl(self, client, clock):
        sc = client.get_set_cache("scache")
        sc.add("fleeting", ttl_seconds=0.15)
        sc.add("durable")
        assert sc.contains("fleeting")
        clock.advance(0.2)
        assert not sc.contains("fleeting")
        assert sc.read_all() == ["durable"]


class TestList(_ref.TestList):
    pass


class TestSortedSets(_ref.TestSortedSets):
    pass


class TestQueues(_ref.TestQueues):
    def test_blocking_wakeup_across_threads(self, client):
        bq = client.get_blocking_queue("bq2")
        got = []

        def taker():
            got.append(bq.poll(timeout_seconds=3.0))

        t = threading.Thread(target=taker)
        t.start()
        _wait_for(_parked(client))
        bq.offer("wake")
        t.join(timeout=3.0)
        assert got == ["wake"]


class TestTopics(_ref.TestTopics):
    pass


class TestObjectLifecycle(_ref.TestObjectLifecycle):
    def test_expire_whole_object(self, client, clock):
        m = client.get_map("ttl-map")
        m.put("k", "v")
        assert m.expire(0.15) is True
        assert m.remain_time_to_live() > 0
        clock.advance(0.2)
        assert m.get("k") is None
        assert not m.is_exists()

    def test_clear_expire(self, client, clock):
        b = client.get_bucket("persist")
        b.set("v")
        b.expire(0.2)
        assert b.clear_expire() is True
        clock.advance(0.25)
        assert b.get() == "v"
        assert b.remain_time_to_live() == -1

    def test_sweeper_removes_expired(self, client, clock):
        b = client.get_bucket("swept")
        b.set("v")
        b.expire(0.1)
        clock.advance(0.5)

        def gone():
            with client._grid.lock:
                return "swept" not in client._grid._data

        _wait_for(gone)  # the sweeper's own 0.25 s cadence


class TestReviewFixes(_ref.TestReviewFixes):
    def test_max_idle_not_refreshed_by_size_or_sweeper(self, client, clock):
        mc = client.get_map_cache("mc-idle")
        mc.put("i", "v", max_idle_seconds=0.25)
        # Arm the grid sweeper (it calls prune_expired on every value).
        client.get_bucket("tick").set("x")
        client.get_bucket("tick").expire(10)
        for _ in range(6):
            clock.advance(0.1)
            mc.size()  # size() must not refresh the idle clock
        assert mc.get("i") is None


class TestListMultimap(_ref2.TestListMultimap):
    pass


class TestSetMultimap(_ref2.TestSetMultimap):
    pass


class TestMultimapCache(_ref2.TestMultimapCache):
    def test_per_key_ttl(self, client, clock):
        mm = client.get_set_multimap_cache("smmc")
        mm.put("hot", 1)
        mm.put("cold", 2)
        assert mm.expire_key("cold", 0.1)
        assert mm.remain_key_ttl_ms("cold") > 0
        assert mm.remain_key_ttl_ms("hot") == -1
        assert mm.remain_key_ttl_ms("absent") == -2
        clock.advance(0.15)
        assert not mm.contains_key("cold")
        assert mm.contains_key("hot")


class TestStream(_ref2.TestStream):
    def test_claim_idle_entries(self, client, clock):
        s = client.get_stream("grp3")
        s.create_group("g", from_id="0-0")
        mid = s.add({"n": 1})
        s.read_group("g", "dead-consumer")
        clock.advance(0.05)
        claimed = s.claim("g", "rescuer", 10, mid)
        assert [i for i, _ in claimed] == [mid]
        pr = s.pending_range("g")
        assert pr[0]["consumer"] == "rescuer"
        assert pr[0]["delivered"] == 2
        # min_idle not reached -> no claim
        assert s.claim("g", "again", 60_000, mid) == []

    def test_auto_claim(self, client, clock):
        s = client.get_stream("grp4")
        s.create_group("g", from_id="0-0")
        ids = [s.add({"n": i}) for i in range(4)]
        s.read_group("g", "dead")
        clock.advance(0.05)
        claimed = s.auto_claim("g", "live", 10, count=3)
        assert [i for i, _ in claimed] == ids[:3]

    def test_blocking_read(self, client):
        s = client.get_stream("blk")
        got = []

        def reader():
            got.extend(s.read(from_id="$", block_seconds=5.0))

        t = threading.Thread(target=reader)
        t.start()
        _wait_for(_parked(client))
        s.add({"x": 42})
        t.join(timeout=5)
        assert not t.is_alive()
        assert got and got[0][1] == {"x": 42}


class TestReliableTopic(_ref2.TestReliableTopic):
    pass


class TestGeo(_ref3.TestGeo):
    pass


class TestTimeSeries(_ref3.TestTimeSeries):
    def test_entry_ttl(self, client, clock):
        ts = client.get_time_series("ts4")
        ts.add(1, "stays")
        ts.add(2, "goes", ttl_seconds=0.1)
        clock.advance(0.15)
        assert ts.size() == 1
        assert ts.get(2) is None


class TestTransferQueue(_ref3.TestTransferQueue):
    def test_transfer_blocks_until_taken(self, client):
        q = client.get_transfer_queue("tq")
        done = []

        def producer():
            done.append(q.transfer("hot-potato", timeout_seconds=5.0))

        t = threading.Thread(target=producer)
        t.start()
        _wait_for(_parked(client))  # the producer waits for a taker
        assert not done  # still blocked: nobody took it
        assert q.take() == "hot-potato"
        t.join(timeout=5)
        assert done == [True]

    def test_try_transfer_needs_waiting_consumer(self, client):
        q = client.get_transfer_queue("tq3")
        assert q.try_transfer("x") is False
        got = []
        t = threading.Thread(target=lambda: got.append(q.poll(2.0)))
        t.start()
        _wait_for(q.has_waiting_consumer)
        assert q.try_transfer("y") is True
        t.join(timeout=5)
        assert got == ["y"]


class TestPriorityVariants(_ref3.TestPriorityVariants):
    def test_priority_blocking_take(self, client):
        q = client.get_priority_blocking_queue("pbq")
        got = []
        t = threading.Thread(target=lambda: got.append(q.take()))
        t.start()
        _wait_for(_parked(client))
        q.offer(5)
        t.join(timeout=5)
        assert got == [5]
        q.offer(3)
        q.offer(9)
        assert q.poll(1.0) == 3  # natural order


class TestScanIterators(_ref3.TestScanIterators):
    pass


class TestMapEntryListeners(_ref4.TestMapEntryListeners):
    pass


class TestShardedTopic(_ref4.TestShardedTopic):
    pass


class TestGridAsyncFacades(_ref_batch.TestGridAsyncFacades):
    def test_async_future_resolves_off_thread(self, client):
        """Grid *_async runs off the caller thread (real futures), and
        blocking async ops can't starve one another."""
        from redisson_tpu_torch.grid.base import _spawn_future

        caller = threading.current_thread().name
        threads = []

        def probe():
            threads.append(threading.current_thread().name)
            return "ok"

        fut = _spawn_future(probe, (), {})
        assert fut.result(timeout=10) == "ok"
        assert threads and threads[0] != caller
        b = client.get_bucket("ab2")
        f2 = b.set_async("v")
        assert f2.result(timeout=10) is None
        assert f2.done()
        assert b.get() == "v"
        q = client.get_blocking_queue("abq")
        takes = [q.poll_async(5.0) for _ in range(4)]
        for i in range(4):
            q.offer_async(i).result(timeout=10)
        got = sorted(t.result(timeout=10) for t in takes)
        assert got == [0, 1, 2, 3]


_DISPATCHES = ("bloom_mixed_keys_runs", "bloom_mixed_keys", "cms_update_estimate")


def test_interleaved_map_bloom_batch():
    """The reference's mixed-batch case on the port: a batch interleaving
    map (grid) and bloom (sketch) ops coalesces the sketch ops into <= 2
    executor dispatches (a spy in place of the JAX metrics), while the
    grid ops run off the caller thread, in order, on the batch worker."""
    from redisson_tpu_torch.grid.maps import Map

    client = _port_client(batch_window_us=5000)
    orig_put = Map.put
    ex = client._engine.executor
    try:
        bf = client.get_bloom_filter("mixb")
        bf.try_init(10_000, 0.01)
        bf.add("warm")
        dispatches = []

        def wrap(name):
            orig = getattr(ex, name)

            def spy(*a, **kw):
                dispatches.append(name)
                return orig(*a, **kw)

            return spy

        for name in _DISPATCHES:
            setattr(ex, name, wrap(name))
        caller = threading.current_thread().name
        grid_threads = []
        m = client.get_map("mixm")

        def traced_put(self, k, v):
            grid_threads.append(threading.current_thread().name)
            return orig_put(self, k, v)

        Map.put = traced_put
        batch = client.create_batch()
        bbf = batch.get_bloom_filter("mixb")
        bm = batch.get_map("mixm")
        for i in range(10):
            bbf.add(f"k{i}")
            bm.put(f"mk{i}", i)
            bbf.contains(f"k{i}")
        res = batch.execute()
        assert len(res) == 30
        adds = res.get_responses()[0::3]
        gets = res.get_responses()[2::3]
        assert all(isinstance(a, bool) for a in adds)
        assert all(g is True for g in gets)
        assert m.size() == 10
        assert len(grid_threads) == 10
        assert all(t != caller for t in grid_threads)
        assert all(t.startswith("rtpu-batch") for t in grid_threads)
        assert 1 <= len(dispatches) <= 2, dispatches
    finally:
        Map.put = orig_put
        for name in _DISPATCHES:
            ex.__dict__.pop(name, None)
        client.shutdown()


def test_batch_grid_ops_match_jax_in_order(clients):
    """A batch mixing sketch and grid calls (sync and async names) gives
    the JAX package's responses, in submission order."""

    def run(c):
        batch = c.create_batch()
        m = batch.get_map("bm")
        q = batch.get_queue("bq")
        b = batch.get_bucket("bb")
        bf = batch.get_bloom_filter("bbf")
        bf.try_init(1000, 0.01)
        m.put("a", 1)
        m.fast_put_async("b", 2)
        m.get("b")
        q.offer("x")
        q.offer_async("y")
        q.poll()
        b.set("v")
        b.get_async()
        bf.add("k")
        bf.contains("k")
        m.read_all_map()
        q.read_all()
        return batch.execute().get_responses()

    _trace(clients, run)


# -- differential traces: the JAX package and the port, call for call ---------


def test_map_and_map_cache_trace(clients, clock):
    def run(c):
        clock.reset()
        m = c.get_map("m")
        tr = [m.put("a", 1), m.put("a", 2), m.put_if_absent("a", 9),
              m.put_if_absent("b", {"x": [1]}), m.fast_put("c", 3.5),
              m.replace("c", 4), m.replace("zz", 1), m.add_and_get("n", 5),
              m.add_and_get("n", 0.5), m.contains_key("a"),
              m.contains_value(4), m.get_all(["a", "c", "ghost"]),
              sorted(m.key_set()), sorted(map(repr, m.values())),
              m.remove("a"), m.fast_remove("b", "ghost"), m.size(),
              m.read_all_map(), m.is_empty(), m.remove("c", 99),
              m.replace("c", 4, 5), m.get("c")]
        m.put_all({"p": 1, "q": 2})
        tr += [sorted(m.entry_set()), sorted(m.key_set("p*")),
               sorted(m.key_iterator(count=1))]
        mc = c.get_map_cache("mc")
        mc.put("t", "v", ttl_seconds=10)
        mc.put("i", "w", max_idle_seconds=5)
        mc.put("forever", 1)
        tr += [mc.remain_time_to_live_entry("t"),
               mc.remain_time_to_live_entry("forever"), mc.size()]
        clock.advance(6)
        tr += [mc.get("i"), mc.get("t"), mc.size()]
        clock.advance(5)
        tr += [mc.get("t"), mc.size(), sorted(mc.read_all_map())]
        return tr

    _trace(clients, run)


def test_multimap_trace(clients, clock):
    def run(c):
        clock.reset()
        lm = c.get_list_multimap("lm")
        for k, v in (("a", 1), ("a", 1), ("a", 2), ("b", 3)):
            lm.put(k, v)
        tr = [lm.get_all("a"), lm.size(), lm.key_size(), lm.remove("a", 1),
              lm.get_all("a"), lm.contains_entry("b", 3),
              sorted(lm.key_set()), lm.remove_all("a"), lm.size()]
        sm = c.get_set_multimap("sm")
        tr += [sm.put("k", 1), sm.put("k", 1), sm.put("k", 2),
               sorted(sm.get_all("k")), sm.fast_remove("k"), sm.size()]
        smc = c.get_set_multimap_cache("smc")
        smc.put("x", 1)
        smc.put("y", 2)
        tr += [smc.expire_key("y", 1.0), smc.remain_key_ttl_ms("y"),
               smc.remain_key_ttl_ms("x")]
        clock.advance(2)
        tr += [smc.contains_key("y"), smc.contains_key("x"),
               sorted(smc.key_set())]
        lmc = c.get_list_multimap_cache("lmc")
        lmc.put("k", "v")
        tr += [lmc.expire_key("k", 1.0), lmc.get_all("k")]
        clock.advance(2)
        tr.append(lmc.get_all("k"))
        return tr

    _trace(clients, run)


def test_sets_lists_and_sorted_sets_trace(clients, clock):
    def run(c):
        clock.reset()
        s = c.get_set("s")
        s2 = c.get_set("s2")
        tr = [s.add(1), s.add(1), s.add_all([2, 3]), s2.add_all([3, 4]),
              sorted(s.read_union("s2")), sorted(s.read_intersection("s2")),
              s.contains(2), s.move("s2", 1), s.remove(2),
              sorted(s.read_all()), sorted(s2.read_all()), s2.size(),
              s.union("s2"), sorted(s.read_all()), s.intersection("s2"),
              sorted(s.read_all()), s.diff("s2"), s.read_all()]
        sc = c.get_set_cache("sc")
        sc.add("a", ttl_seconds=1)
        sc.add("b")
        clock.advance(2)
        tr += [sc.contains("a"), sc.read_all(), sc.size()]
        lst = c.get_list("l")
        lst.add_all(["x", "y", "z", "y"])
        tr += [lst.get(1), lst.index_of("y"), lst.contains("z"),
               lst.set(0, "X"), lst.remove("y"), lst.read_all(),
               lst.sub_list(0, 2), lst.size(), lst.remove_at(0)]
        lst.insert(1, "ins")
        lst.trim(0, 2)
        tr.append(lst.read_all())
        ss = c.get_sorted_set("so")
        for v in (5, 1, 3):
            ss.add(v)
        tr += [ss.read_all(), ss.first(), ss.last(), ss.remove(3),
               ss.read_all()]
        z = c.get_scored_sorted_set("z")
        tr += [z.add(2.0, "b"), z.add(1.0, "a"), z.add(3.0, "c"),
               z.add_score("a", 5.0), z.get_score("a"), z.rank("a"),
               z.read_all(), z.value_range(0, 1), z.first(), z.last(),
               z.entry_range(0, -1), z.value_range_by_score(1.5, 3.0),
               z.count(2.0, 6.0), z.add_all({"d": 4.0, "e": 0.5}),
               z.remove_range_by_score(4.0, 4.0), z.poll_first(),
               z.poll_last(), z.contains("b"), z.size(), z.remove("b"),
               z.size()]
        lx = c.get_lex_sorted_set("lx")
        lx.add_all(["b", "a", "d", "c"])
        tr += [lx.read_all(), lx.range("b", True, "d", False),
               lx.range_head("c", True), lx.range_tail("c", False),
               lx.count("a", True, "c", True)]
        return tr

    _trace(clients, run)


def test_queue_family_trace(clients):
    def run(c):
        q = c.get_queue("q")
        tr = [q.offer(1), q.offer(2), q.add(3), q.peek(), q.poll(),
              q.read_all(), q.size(), q.poll_last_and_offer_first_to("q2"),
              c.get_queue("q2").read_all()]
        d = c.get_deque("d")
        d.add_first("f")
        d.add_last("l")
        d.offer_first("ff")
        tr += [d.peek_first(), d.peek_last(), d.poll_last(), d.read_all(),
               d.poll_first(), d.size()]
        bq = c.get_blocking_queue("bq")
        bq.put("x")
        bq.put("y")
        bq.put("z")
        sink = []
        tr += [bq.take(), bq.drain_to(sink, 1), sink, bq.poll(timeout_seconds=0),
               bq.poll(timeout_seconds=0)]
        bd = c.get_blocking_deque("bd")
        bd.add_first(1)
        bd.add_last(2)
        tr += [bd.poll_last(timeout_seconds=0), bd.poll_first(timeout_seconds=0),
               bd.poll_first(timeout_seconds=0)]
        pq = c.get_priority_queue("pq")
        for v in (5, 1, 4):
            pq.offer(v)
        tr += [pq.peek(), pq.poll(), pq.read_all()]
        pd = c.get_priority_deque("pd")
        for v in (3, 1, 2):
            pd.add(v)
        tr += [pd.poll_first(), pd.poll_last(), pd.read_all()]
        rb = c.get_ring_buffer("rb")
        tr += [rb.try_set_capacity(2), rb.try_set_capacity(3)]
        rb.offer_all([1, 2, 3])
        tr += [rb.read_all(), rb.remaining_capacity(), rb.capacity()]
        tq = c.get_transfer_queue("tq")
        tr += [tq.try_transfer("x"), tq.offer("y"), tq.poll()]
        return tr

    _trace(clients, run)


def test_stream_trace(clients, clock):
    def run(c):
        clock.reset()
        st = c.get_stream("st")
        ids = [st.add({"f": i}) for i in range(3)]
        ids.append(st.add({"f": "x"}, id="9999999999999-5"))
        tr = [ids, st.size(), st.range("-", "+"), st.rev_range("+", "-", 2),
              st.last_id()]
        st.create_group("g", from_id="0-0")
        tr += [st.read_group("g", "c1", count=2),
               st.pending("g"), st.pending_range("g")]
        clock.advance(1)
        tr += [st.ack("g", ids[0]), st.claim("g", "c2", 500, ids[1]),
               st.auto_claim("g", "c3", 0, count=5), st.pending_range("g")]
        tr += [st.read(from_id=ids[1]), st.get(ids[1]), st.list_groups(),
               st.list_consumers("g"), st.remove(ids[2]), st.trim(2),
               st.size(), st.range("-", "+", count=1)]
        tr.append(st.remove_group("g"))
        return tr

    _trace(clients, run)


def test_geo_and_time_series_trace(clients, clock):
    def run(c):
        clock.reset()
        g = c.get_geo("g")
        tr = [g.add(13.361389, 38.115556, "Palermo"),
              g.add(15.087269, 37.502669, "Catania"),
              g.add(2.349014, 48.864716, "Paris"),
              g.dist("Palermo", "Catania", "km"), g.dist("Palermo", "Paris"),
              g.pos("Palermo", "Nowhere"), g.hash("Palermo", "Catania"),
              g.search_radius(15.0, 37.0, 200, "km"),
              g.search_radius(15.0, 37.0, 200, "km", with_dist=True),
              g.search_radius_from_member("Palermo", 300, "km"),
              g.search(longitude=15.0, latitude=37.0, radius=200, unit="km",
                       order="DESC", with_coord=True, with_dist=True,
                       with_hash=True),
              g.search(member="Palermo", width=400, height=400, unit="km",
                       order="ASC", count=1),
              g.size(), g.remove("Paris"), g.size()]
        tr.append(g.search_and_store("near", longitude=15.0, latitude=37.0,
                                     radius=200, unit="km", store_dist=True))
        tr.append(c.get_scored_sorted_set("near").read_all())
        ts = c.get_time_series("ts")
        ts.add(10, "a")
        ts.add(20, "b", label="L")
        ts.add(30, "c", ttl_seconds=1)
        tr += [ts.size(), ts.range(0, 25), ts.range_reversed(0, 100),
               ts.entry_range(0, 100), ts.first(), ts.last(),
               ts.first_timestamp(), ts.last_timestamp()]
        clock.advance(2)
        tr += [ts.size(), ts.get(30), ts.poll_first(), ts.poll_last(),
               ts.remove_range(0, 100), ts.size()]
        return tr

    _trace(clients, run)


def test_topics_trace(clients):
    def run(c):
        got = []
        t = c.get_topic("news")
        lid = t.add_listener(lambda ch, m: got.append(("t", ch, m)))
        pt = c.get_pattern_topic("ne*")
        pt.add_listener(lambda p, ch, m: got.append(("p", p, ch, m)))
        sh = c.get_sharded_topic("shard")
        sh.add_listener(lambda ch, m: got.append(("s", ch, m)))
        n = [t.publish("hello"), t.count_subscribers(), sh.publish(1),
             c.get_topic("nobody").publish("x")]
        c._topic_bus.drain()
        t.remove_listener(lid)
        n.append(t.publish("again"))
        c._topic_bus.drain()
        return n, sorted(map(repr, got))

    _trace(clients, run)


# -- the grid snapshot with facades writing every kind -------------------------


def _fill_grid(c):
    """Every persisted kind, written through the facades."""
    c.get_bucket("str").set("hello")
    c.get_atomic_long("cnt").add_and_get(41)
    c.get_binary_stream("bin").set(b"\x00\x01raw")
    lst = c.get_list("lst")
    lst.add("a")
    lst.add("b")
    m = c.get_map("map")
    m.put("k1", "v1")
    m.put("k2", 2)
    c.get_map_cache("mc").put("k", "v", 100, 50)
    s = c.get_set("set")
    s.add("x")
    s.add("y")
    c.get_set_cache("sc").add("m", 100)
    z = c.get_scored_sorted_set("zs")
    z.add(1.5, "a")
    z.add(0.5, "b")
    c.get_lex_sorted_set("lex").add("alpha")
    c.get_queue("q").offer("job")
    c.get_deque("dq").add_first("front")
    c.get_ring_buffer("ring").try_set_capacity(3)
    c.get_ring_buffer("ring").add("r1")
    st = c.get_stream("st")
    sid = st.add({"f": "v"})
    st.add({"g": 2})
    st.create_group("g", from_id="0-0")
    st.read_group("g", "c1", count=1)
    st.remove(sid)
    geo = c.get_geo("geo")
    geo.add(13.361389, 38.115556, "Palermo")
    c.get_list_multimap("lmm").put("k", "v")
    c.get_set_multimap("smm").put("k", "v")
    c.get_time_series("ts").add(5, "five")
    c.get_bucket("ttl").set("t", ttl_seconds=500)


def test_facade_grid_store_byte_identical_both_ways(tmp_path, monkeypatch):
    """The same facade calls on each package write byte-identical
    ``grid_store.bin`` files; each package restores the other's file and
    writes it back byte for byte."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    jc = redisson_tpu.create(redisson_tpu.Config().use_tpu_sketch(min_bucket=64))
    tc = _port_client()
    try:
        _fill_grid(jc)
        _fill_grid(tc)
        jpath, tpath = str(tmp_path / "jax.bin"), str(tmp_path / "port.bin")
        n = jc._grid.snapshot_to(jpath)
        assert tc._grid.snapshot_to(tpath) == n
    finally:
        tc.shutdown()
        jc.shutdown()
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        jbytes = a.read()
        assert b.read() == jbytes
    for restore, kind in ((GridStore, "port"),):
        store = restore()
        assert store.restore_from(jpath)
        again = str(tmp_path / f"{kind}-again.bin")
        store.snapshot_to(again)
        store.shutdown()
        with open(again, "rb") as f:
            assert f.read() == jbytes
    # Through the port's facades: a JAX-written file serves every kind.
    tc = _port_client()
    jc = redisson_tpu.create(redisson_tpu.Config().use_tpu_sketch(min_bucket=64))
    try:
        assert tc._grid.restore_from(jpath)
        assert jc._grid.restore_from(tpath)

        def read(c):
            st = c.get_stream("st")
            return [c.get_list("lst").read_all(), c.get_map("map").read_all_map(),
                    c.get_map_cache("mc").get("k"), sorted(c.get_set("set").read_all()),
                    c.get_set_cache("sc").read_all(),
                    c.get_scored_sorted_set("zs").entry_range(0, -1),
                    c.get_lex_sorted_set("lex").read_all(),
                    c.get_queue("q").peek(), c.get_deque("dq").peek_first(),
                    c.get_ring_buffer("ring").read_all(), st.range("-", "+"),
                    st.pending_range("g"), c.get_geo("geo").pos("Palermo"),
                    c.get_list_multimap("lmm").get_all("k"),
                    c.get_time_series("ts").get(5)]

        assert read(tc) == read(jc)
        p2 = str(tmp_path / "port2.bin")
        tc._grid.snapshot_to(p2)
        with open(p2, "rb") as f:
            assert f.read() == jbytes
    finally:
        tc.shutdown()
        jc.shutdown()


def test_grid_kinds_round_trip_through_port_snapshot_dir(tmp_path):
    """The reference's ``test_grid_kinds_round_trip`` on the port: a
    client's shutdown snapshot carries every grid kind, and a client
    created on the directory reads them back."""
    d = str(tmp_path / "snap")
    cfg = rt.Config().use_gpu_sketch(device="cpu", min_bucket=64)
    cfg.snapshot_dir = d
    c1 = rt.create(cfg)
    c1.get_bucket("b").set(b"payload-\x00\xff")
    s = c1.get_set("s")
    s.add(b"m1")
    s.add(b"m2")
    z = c1.get_scored_sorted_set("z")
    z.add(1.5, b"one")
    z.add(2.5, b"two")
    c1.get_map("m").put(b"k1", b"v1")
    c1.get_map_cache("mc").put(b"k", b"v", ttl_seconds=300.0)
    lst = c1.get_list("l")
    lst.add(b"a")
    lst.add(b"b")
    lx = c1.get_lex_sorted_set("lx")
    lx.add("alpha")
    lx.add("beta")
    rb = c1.get_ring_buffer("rb")
    rb.try_set_capacity(3)
    rb.offer_all([b"r1", b"r2", b"r3", b"r4"])
    c1.get_stream("st").add({"f": 1}, id="5-1")
    c1.get_geo("g").add(1.0, 2.0, "m")
    c1.shutdown()
    c2 = rt.create(cfg)
    try:
        assert sorted(c2.get_set("s").read_all()) == [b"m1", b"m2"]
        assert c2.get_scored_sorted_set("z").get_score(b"two") == 2.5
        assert c2.get_map("m").get(b"k1") == b"v1"
        assert c2.get_map_cache("mc").get(b"k") == b"v"
        assert c2.get_list("l").read_all() == [b"a", b"b"]
        assert c2.get_lex_sorted_set("lx").read_all() == ["alpha", "beta"]
        assert c2.get_ring_buffer("rb").read_all() == [b"r2", b"r3", b"r4"]
        assert c2.get_stream("st").range("-", "+") == [("5-1", {"f": 1})]
        assert c2.get_geo("g").pos("m")["m"] == pytest.approx((1.0, 2.0), abs=1e-5)
    finally:
        c2.shutdown()


# -- near-cache reach of the stream and geo scalars ----------------------------


def test_stream_and_geo_scalars_ride_the_near_cache(tmp_path):
    """``tests/test_residency.py::test_stream_and_geo_scalars_ride_the_
    near_cache`` on the port: XLEN/GEODIST/GEOPOS answers install into the
    engine's near cache under a ``grid:`` tenant, mutations retire them,
    and a cached scalar carries the key's TTL deadline (the expiry is
    polled with a deadline here, never slept for)."""
    cl = _port_client(residency_dir=str(tmp_path))
    try:
        nc = cl._engine.nearcache
        st = cl.get_stream("s1")
        st.add({b"f": b"v"})
        assert st.size() == 1  # miss, installs
        base_hits = nc.hits
        assert st.size() == 1  # hit
        assert nc.hits == base_hits + 1
        st.add({b"f": b"v2"})  # bump retires the cached scalar
        assert st.size() == 2
        st.remove(st.last_id())
        assert st.size() == 1
        geo = cl.get_geo("g1")
        geo.add(13.361389, 38.115556, b"palermo")
        geo.add(15.087269, 37.502669, b"catania")
        d1 = geo.dist(b"palermo", b"catania", "km")
        hits0 = nc.hits
        assert geo.dist(b"palermo", b"catania", "km") == d1  # hit
        assert nc.hits == hits0 + 1
        geo.add(15.0, 37.0, b"catania")  # move: epoch bump
        d2 = geo.dist(b"palermo", b"catania", "km")
        assert d2 != d1
        p = geo.pos(b"palermo")
        p[b"palermo"] = (0.0, 0.0)  # caller mutation must not poison
        assert geo.pos(b"palermo")[b"palermo"] != (0.0, 0.0)
        st.delete()  # store-level delete invalidates the grid tenant
        assert st.size() == 0
        st2 = cl.get_stream("s2")
        st2.add({b"f": b"v"})
        assert st2.size() == 1  # installs (no TTL yet)
        st2.expire(0.05)  # EXPIRE invalidates the cached pair
        assert st2.size() in (0, 1)  # re-installs WITH the deadline
        _wait_for(lambda: st2.size() == 0)  # observed by the cached read
        assert not st2.is_exists()
    finally:
        cl.shutdown()


def test_wrongtype_between_grid_families_and_sketches(clients):
    def run(c):
        c.get_list("lst").add(1)
        bf = c.get_bloom_filter("bf")
        bf.try_init(100, 0.01)
        out = []
        for fn in (lambda: c.get_map("lst").put("k", 1),
                   lambda: c.get_stream("lst").add({"f": 1}),
                   lambda: c.get_geo("lst").add(1.0, 1.0, "m"),
                   lambda: c.get_list("bf").add(1),
                   lambda: c.get_bloom_filter("lst").try_init(100, 0.01)):
            try:
                fn()
                out.append("ok")
            except Exception as e:
                out.append(type(e).__name__)
        return out

    assert _both(clients, run) == ["TypeError"] * 5


def test_config_threads_sizes_the_topic_pool():
    cfg = rt.Config().set_threads(3).use_gpu_sketch(device="cpu")
    c = rt.create(cfg)
    try:
        assert c._topic_bus._pool._max_workers == 3
        assert rt.Config.from_dict({"threads": 2}).threads == 2
    finally:
        c.shutdown()
