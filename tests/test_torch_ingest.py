"""The RTopic -> CountMinSketch ingest bridge and the engine-shared CMS
top-K on the port, against the JAX package's.

Every test of ``tests/test_cms_topk_ingest.py`` runs here with a port
client (``device="cpu"``) and the port's ``TopicCmsBridge``: the shared
top-K table, the config-5 stream end to end, the deadline flush, the TTL
drop, the drain exactness of teardown (no event lost when ``close()``
races listeners still running), and array coalescing with its weight
alignment and dtype boundary.  Then the differential: the same seeded
stream, published as array messages through each package's bridge,
leaves a CMS row byte-identical to the JAX package's, and the same top-K.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
from redisson_tpu.serve import TopicCmsBridge as JaxTopicCmsBridge  # noqa: E402
from redisson_tpu_torch.serve import TopicCmsBridge  # noqa: E402


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


def zipf_stream(rng, n, n_keys=1000, a=1.3):
    keys = rng.zipf(a, size=n) % n_keys
    return keys.astype(np.uint64)


class TestSharedTopK:
    def test_two_handles_share_one_table(self, client):
        h1 = client.get_count_min_sketch("shared-cms")
        h1.try_init(4, 1 << 12, track_top_k=5)
        h2 = client.get_count_min_sketch("shared-cms")  # second handle
        h1.add_all(["a"] * 50 + ["b"] * 30 + ["c"] * 10)
        h2.add_all(["d"] * 80 + ["a"] * 25)
        # Both handles see the union of both handles' adds.
        for h in (h1, h2):
            top = h.top_k(2)
            assert [k for k, _ in top] == ["d", "a"]
            assert top[0][1] >= 80
            assert top[1][1] >= 75

    def test_topk_reestimates_current_counts(self, client):
        cms = client.get_count_min_sketch("re-est")
        cms.try_init(4, 1 << 12, track_top_k=3)
        cms.add_all(["x"] * 10 + ["y"] * 5)
        cms.add_all(["y"] * 20)  # y overtakes x
        top = cms.top_k(2)
        assert [k for k, _ in top] == ["y", "x"]

    def test_heavy_hitters_found_in_zipf_stream(self, client):
        cms = client.get_count_min_sketch("zipf")
        cms.try_init(5, 1 << 14, track_top_k=10)
        rng = np.random.default_rng(0)
        stream = zipf_stream(rng, 200_000)
        for i in range(0, len(stream), 8192):
            cms.add_all(stream[i : i + 8192])
        true_counts = np.bincount(stream.astype(np.int64))
        true_top = set(np.argsort(-true_counts)[:10].tolist())
        got = {int(k) for k, _ in cms.top_k(10)}
        # CMS overestimates slightly; demand >= 8/10 recall.
        assert len(got & true_top) >= 8, (got, true_top)

    def test_delete_drops_table(self, client):
        cms = client.get_count_min_sketch("drop-cms")
        cms.try_init(4, 1 << 10, track_top_k=3)
        cms.add_all(["k"] * 5)
        assert cms.top_k(1)
        cms.delete()
        assert client._engine.topk.candidates("drop-cms") == []


class TestTopicCmsBridge:
    def test_stream_topk_end_to_end(self, client):
        cms = client.get_count_min_sketch("stream-cms")
        cms.try_init(5, 1 << 14, track_top_k=10)
        bridge = TopicCmsBridge(
            client, "events", "stream-cms", batch_size=4096,
            flush_interval_s=0.01,
        )
        topic = client.get_topic("events")
        rng = np.random.default_rng(1)
        stream = zipf_stream(rng, 100_000)
        for key in stream[:2000]:  # publish one-by-one (listener path)
            topic.publish(int(key))
        # Bulk-feed the rest through the same listener callback (the
        # pub/sub delivery pool is the bottleneck for per-message publish
        # in-process; config-5's bench uses the same shortcut).
        for i in range(2000, len(stream), 4096):
            for key in stream[i : i + 4096]:
                bridge._on_message("events", int(key))
        client._topic_bus.drain()
        bridge.close()
        assert bridge.events_ingested == len(stream)
        true_counts = np.bincount(stream.astype(np.int64))
        true_top = set(np.argsort(-true_counts)[:10].tolist())
        got = {int(k) for k, _ in cms.top_k(10)}
        assert len(got & true_top) >= 8, (got, true_top)
        # Estimates are within CMS error of the true counts.
        heaviest = int(np.argmax(true_counts))
        est = cms.estimate(heaviest)
        assert est >= true_counts[heaviest]
        assert est <= true_counts[heaviest] + len(stream) // (1 << 12)

    def test_deadline_flush(self, client):
        cms = client.get_count_min_sketch("deadline-cms")
        cms.try_init(4, 1 << 10, track_top_k=3)
        bridge = TopicCmsBridge(
            client, "slow-events", "deadline-cms", batch_size=1 << 20,
            flush_interval_s=0.02,
        )
        topic = client.get_topic("slow-events")
        topic.publish("only-one")
        deadline = time.time() + 3.0
        while time.time() < deadline and cms.estimate("only-one") < 1:
            time.sleep(0.02)
        assert cms.estimate("only-one") == 1  # flushed by deadline, not size
        bridge.close()


def test_ttl_expiry_drops_topk_table():
    """A sketch's shared top-K table dies with its TTL — a successor under
    the same name must not inherit ghost candidates (expiry polled with a
    deadline)."""
    c = _port_client()
    try:
        cms = c.get_count_min_sketch("ttl-topk")
        cms.try_init(4, 1 << 10, track_top_k=3)
        cms.add_all(["ghost"] * 9)
        assert cms.top_k(1)[0][0] == "ghost"
        cms.expire(0.05)
        deadline = time.monotonic() + 5.0
        while cms.is_exists():
            assert time.monotonic() < deadline, "TTL never fired"
            time.sleep(0.01)
        assert c._engine.topk.candidates("ttl-topk") == []
    finally:
        c.shutdown()


class TestDrainExactness:
    """TopicBus.drain must be EXACT: the old pool-rendezvous barrier broke
    silently at its timeout, and teardown then dropped queued deliveries —
    caught in the full-geometry bench as a NEGATIVE signed CMS estimate
    error (a lossless pipe can never undercount)."""

    def test_no_event_loss_through_bridge_teardown(self, client):
        from redisson_tpu_torch.serve import TopicCmsBridge

        cms = client.get_count_min_sketch("drain-cms")
        cms.try_init(4, 1 << 12, track_top_k=5)
        bridge = TopicCmsBridge(
            client, "drain-ev", "drain-cms",
            batch_size=1 << 12, flush_interval_s=0.05,
        )
        topic = client.get_topic("drain-ev")
        rng = np.random.default_rng(4)
        n, chunk = 120_000, 1 << 12
        stream = (rng.zipf(1.2, size=n) % 500).astype(np.uint64)
        for i in range(0, n, chunk):
            topic.publish(stream[i : i + chunk])
        assert client._topic_bus.drain() is True
        bridge.close()
        true = np.bincount(stream.astype(np.int64), minlength=500)
        for key in np.argsort(-true)[:5]:
            est = cms.estimate(np.uint64(key))
            assert est >= true[key], (key, est, true[key])

    def test_drain_timeout_reports_pending(self, client):
        import threading
        import time

        release = threading.Event()
        topic = client.get_topic("drain-slow")
        topic.add_listener(lambda ch, m: release.wait(5.0))
        topic.publish(b"x")
        t0 = time.monotonic()
        assert client._topic_bus.drain(timeout=0.3) is False
        assert time.monotonic() - t0 < 2.0
        release.set()
        assert client._topic_bus.drain(timeout=10.0) is True

    def test_close_without_prior_drain_loses_nothing(self, client):
        # The teardown race the old close() had: deliveries queued on the
        # bus (targets snapshotted at publish) start AFTER flush() but
        # BEFORE _closed — close() now waits out its channel first.
        from redisson_tpu_torch.serve import TopicCmsBridge

        cms = client.get_count_min_sketch("close-cms")
        cms.try_init(4, 1 << 12)
        bridge = TopicCmsBridge(
            client, "close-ev", "close-cms",
            batch_size=1 << 14, flush_interval_s=5.0,  # no deadline help
        )
        topic = client.get_topic("close-ev")
        n, chunk = 64_000, 1 << 11
        stream = np.arange(n, dtype=np.uint64) % 97
        for i in range(0, n, chunk):
            topic.publish(stream[i : i + chunk])
        bridge.close()  # deliberately NO bus drain first
        for key in (0, 1, 96):
            assert cms.estimate(np.uint64(key)) >= int(
                np.sum(stream == key)
            ), key


class TestArrayCoalescing:
    """Array-message launch coalescing (max_launch_events): weights stay
    aligned, dtype boundaries split launches, sub-threshold buffers
    flush on their own deadline clock."""

    def test_weights_align_across_mixed_messages(self, client):
        from redisson_tpu_torch.serve import TopicCmsBridge

        cms = client.get_count_min_sketch("co-cms")
        cms.try_init(4, 1 << 12)
        # weight_fn: None for the first array (default-1), per-event for
        # the second, scalar for the third.
        state = {"n": 0}

        def wf(arr):
            state["n"] += 1
            if state["n"] == 1:
                return None
            if state["n"] == 2:
                return np.full(len(arr), 3, np.int64)
            return np.int64(5)

        bridge = TopicCmsBridge(
            client, "co-ev", "co-cms", weight_fn=wf,
            flush_interval_s=0.05, max_launch_events=1 << 20,
        )
        topic = client.get_topic("co-ev")
        topic.publish(np.array([1, 1], dtype=np.uint64))       # w=1 each
        topic.publish(np.array([2, 2], dtype=np.uint64))       # w=3 each
        topic.publish(np.array([3], dtype=np.uint64))          # w=5
        client._topic_bus.drain()
        bridge.close()
        assert cms.estimate(np.uint64(1)) == 2
        assert cms.estimate(np.uint64(2)) == 6
        assert cms.estimate(np.uint64(3)) == 5

    def test_subthreshold_arrays_flush_on_deadline(self, client):
        import time as _time

        from redisson_tpu_torch.serve import TopicCmsBridge

        cms = client.get_count_min_sketch("dl-cms")
        cms.try_init(4, 1 << 12)
        bridge = TopicCmsBridge(
            client, "dl-ev", "dl-cms",
            flush_interval_s=0.05, max_launch_events=1 << 20,
        )
        topic = client.get_topic("dl-ev")
        topic.publish(np.array([9, 9, 9], dtype=np.uint64))
        client._topic_bus.drain()
        deadline = _time.monotonic() + 5.0
        while _time.monotonic() < deadline:
            if cms.estimate(np.uint64(9)) == 3:
                break
            _time.sleep(0.05)
        assert cms.estimate(np.uint64(9)) == 3, "deadline flush starved"
        bridge.close()

    def test_dtype_boundary_splits_launches(self, client):
        from redisson_tpu_torch.serve import TopicCmsBridge

        cms = client.get_count_min_sketch("dt-cms")
        cms.try_init(4, 1 << 12)
        bridge = TopicCmsBridge(
            client, "dt-ev", "dt-cms",
            flush_interval_s=0.05, max_launch_events=1 << 20,
        )
        topic = client.get_topic("dt-ev")
        # uint64 then uint32: concatenating would upcast the uint32 keys
        # and change their codec encoding — they must launch separately.
        topic.publish(np.array([7, 7], dtype=np.uint64))
        topic.publish(np.array([7, 7, 7], dtype=np.uint32))
        client._topic_bus.drain()
        bridge.close()
        # Each dtype keeps ITS OWN codec encoding (np.uint32(7) and
        # np.uint64(7) are distinct keys under the default codec) — an
        # upcasting concat would have merged them into one phantom key.
        assert cms.estimate(np.uint64(7)) == 2
        assert cms.estimate(np.uint32(7)) == 3


# -- the differential: one seeded stream through each package's bridge --------


def _row(c, name):
    """The CMS row's table cells as the engine holds them (uint32 words)."""
    eng = c._engine
    eng._drain()
    e = eng.registry.lookup(name)
    if hasattr(eng.executor, "state_to_host"):
        u = e.pool.row_units
        return np.asarray(eng.executor.state_to_host(e.pool))[
            e.row * u : (e.row + 1) * u
        ].view(np.uint32)
    return np.asarray(eng.executor.read_row(e.pool, e.row)).view(np.uint32)


def _feed(c, bridge_cls, stream, chunk, **kw):
    cms = c.get_count_min_sketch("fed")
    cms.try_init(4, 1 << 12, track_top_k=8)
    bridge = bridge_cls(c, "feed", "fed", **kw)
    topic = c.get_topic("feed")
    for i in range(0, len(stream), chunk):
        topic.publish(stream[i : i + chunk])
    assert c._topic_bus.drain(timeout=60.0)
    bridge.close()
    assert bridge.events_ingested == len(stream)
    return _row(c, "fed"), cms.top_k(8)


def _golden_cms_row(jc, stream, d, w):
    """The golden count-min table of ``stream`` (the JAX package's golden
    model over its codec's hashes of the keys), as uint32 cells."""
    from redisson_tpu.ops.golden import GoldenCountMinSketch
    from redisson_tpu.utils import hashing as jhashing

    H1, H2 = jc.get_count_min_sketch("golden-keys")._hash128(stream)
    g = GoldenCountMinSketch(d, w)
    g.add_hashed(*jhashing.km_reduce_mod(H1, H2, w))
    return g.counts.reshape(-1)


@pytest.mark.parametrize("chunk,launch", [(1 << 11, 1 << 13), (3000, 1 << 18)])
def test_bridge_fed_cms_row_byte_identical_to_jax(chunk, launch):
    """The same seeded zipf stream, published as array messages through
    each package's bridge (array coalescing up to ``max_launch_events``,
    deadline flushes, the in-flight window), leaves the same CMS table
    bytes and the same top-K as the JAX package, and every row of the
    table counts every event once.  (The DUMP payload also carries the
    top-K table's stored offers, which depend on where the flushes fell,
    so it varies between two runs of the JAX package itself.)"""

    rng = np.random.default_rng(12)
    stream = (rng.zipf(1.2, size=40_000) % 2000).astype(np.uint64)
    kw = dict(batch_size=4096, flush_interval_s=0.01, max_launch_events=launch)
    d, w = 4, 1 << 12
    jc = redisson_tpu.create(redisson_tpu.Config().use_tpu_sketch(min_bucket=64))
    tc = _port_client()
    try:
        golden = _golden_cms_row(jc, stream, d, w)
        jrow, jtop = _feed(jc, JaxTopicCmsBridge, stream, chunk, **kw)
        trow, ttop = _feed(tc, TopicCmsBridge, stream, chunk, **kw)
        # The port's table is the golden count-min of the whole stream in
        # every run (a count-min add commutes, so where the flushes fell
        # cannot matter).
        assert trow[: d * w].tobytes() == golden.tobytes()
        sums = trow[: d * w].astype(np.uint64).reshape(d, w).sum(axis=1)
        assert sums.tolist() == [len(stream)] * d
        if jrow[: d * w].tobytes() != golden.tobytes():
            # The JAX bridge's close() can return while its deadline
            # thread still holds a taken batch (ROADMAP queue 3): that
            # run has nothing to compare the port with.
            return
        assert trow.tobytes() == jrow.tobytes()
        # The same top-K estimates; keys compared above the 8th estimate,
        # where no tie can reorder them (ties keep the candidates' arrival
        # order, which follows the flush timing).
        assert [e for _, e in ttop] == [e for _, e in jtop]
        floor = jtop[-1][1]
        assert {k for k, e in ttop if e > floor} == {k for k, e in jtop if e > floor}
    finally:
        tc.shutdown()
        jc.shutdown()


def test_scalar_messages_row_matches_jax():
    """Per-event (scalar) messages ride the listener path's batch buffer;
    the resulting row equals the JAX package's too."""
    keys = [f"k{i % 37}" for i in range(3000)]
    rows = []
    for mk, cls in ((lambda: redisson_tpu.create(
            redisson_tpu.Config().use_tpu_sketch(min_bucket=64)), JaxTopicCmsBridge),
            (_port_client, TopicCmsBridge)):
        c = mk()
        try:
            cms = c.get_count_min_sketch("sc")
            cms.try_init(4, 1 << 10, track_top_k=4)
            bridge = cls(c, "sc-ev", "sc", batch_size=256, flush_interval_s=0.01)
            topic = c.get_topic("sc-ev")
            for k in keys:
                topic.publish(k)
            bridge.close()
            assert bridge.events_ingested == len(keys)
            top = cms.top_k(4)
            floor = top[-1][1]
            rows.append((_row(c, "sc").tobytes(), [e for _, e in top],
                         {k for k, e in top if e > floor}))
        finally:
            c.shutdown()
    assert rows[0] == rows[1]  # ties at the 4th estimate compare by value
