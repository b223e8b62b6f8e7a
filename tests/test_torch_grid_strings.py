"""The port's host grid (strings, counters, RKeys) against the JAX
package's.

The same calls go through a JAX client (CPU backend) and a port client
(``device="cpu"``): RBucket, RBuckets, RAtomicLong, RAtomicDouble, the
adders, the id generator and RKeys must answer alike; one logical
keyspace spans the grid and the sketch engine, so reusing a name across
the two backends is WRONGTYPE on both.  The grid snapshot codec is whole:
a ``grid_store.bin`` the JAX package wrote — strings, counters, lists,
maps, sets, sorted sets, streams — restores into the port, which writes
it back byte for byte, and the reverse.  (Wall-clock time is frozen
around the snapshot round trips: map entries carry their elapsed idle
time, which would otherwise differ between two writes.)
"""

import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
from redisson_tpu_torch.grid.store import GridStore  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def clients():
    jc = redisson_tpu.create(redisson_tpu.Config().use_tpu_sketch(min_bucket=64))
    tc = rt.create(rt.Config().use_gpu_sketch(device="cpu", min_bucket=64))
    yield jc, tc
    tc.shutdown()
    jc.shutdown()


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


def test_bucket_and_buckets(clients):
    def run(c):
        b = c.get_bucket("b1")
        trace = [b.get(), b.is_exists()]
        b.set({"x": [1, 2]})
        trace += [b.get(), b.size() > 0, b.set_if_absent(5), b.set_if_exists("v2")]
        trace += [b.get(), b.get_and_set("v3"), b.compare_and_set("v3", "v4"),
                  b.compare_and_set("nope", "v5"), b.get()]
        b.set("ttl", ttl_seconds=100)
        trace += [90_000 <= b.remain_time_to_live() <= 100_000, b.clear_expire(),
                  b.remain_time_to_live()]
        bs = c.get_buckets()
        bs.set({"m1": 1, "m2": "two"})
        trace += [bs.get("m1", "m2", "m3"), bs.try_set({"m3": 3, "m1": 0}),
                  bs.try_set({"m4": 4, "m5": 5}), bs.get("m4", "m5")]
        trace += [b.get_and_delete(), b.is_exists()]
        return trace

    _both(clients, run)


def test_atomic_long_double_and_adders(clients):
    def run(c):
        al = c.get_atomic_long("al")
        tr = [al.get(), al.increment_and_get(), al.add_and_get(41),
              al.get_and_increment(), al.decrement_and_get(), al.get_and_add(-2),
              al.compare_and_set(40, 7), al.compare_and_set(1, 2), al.get_and_set(9),
              al.get(), c.get_atomic_long("never").compare_and_set(1, 2),
              c.get_keys().count_exists("never")]
        ad = c.get_atomic_double("ad")
        tr += [ad.get(), ad.add_and_get(1.5), ad.get_and_add(0.25), ad.get(),
               ad.compare_and_set(1.75, 3.0), ad.get()]
        la = c.get_long_adder("la")
        la.add(5)
        la.increment()
        la.decrement()
        da = c.get_double_adder("da")
        da.add(0.5)
        da.add(0.25)
        tr += [la.sum(), da.sum()]
        ig = c.get_id_generator("ig")
        tr += [ig.try_init(100, 3), ig.try_init(1, 1),
               [ig.next_id() for _ in range(5)]]
        tr += [al.get_and_delete(), al.is_exists()]
        return tr

    _both(clients, run)


def test_keys_span_both_backends(clients):
    def run(c):
        c.get_bucket("s1").set("a")
        c.get_atomic_long("n1").increment_and_get()
        bf = c.get_bloom_filter("bf1")
        bf.try_init(1000, 0.01)
        bf.add("x")
        c.get_hyper_log_log("h1").add("y")
        k = c.get_keys()
        tr = [sorted(k.get_keys()), sorted(k.get_keys("*1")), k.count(),
              k.count_exists("s1", "bf1", "ghost", "h1")]
        tr.append(k.expire("bf1", 100))
        tr.append(90_000 <= k.remain_time_to_live("bf1") <= 100_000)
        tr.append(k.remain_time_to_live("s1"))
        tr.append(k.remain_time_to_live("ghost"))
        k.rename("s1", "s2")
        k.rename("bf1", "bf2")
        tr.append(sorted(k.get_keys()))
        tr.append(k.random_key() in set(k.get_keys()))
        tr.append(k.delete("s2", "bf2", "ghost"))
        tr.append(k.delete_by_pattern("h*"))
        k.flushall()
        tr.append(k.count())
        return tr

    _both(clients, run)
    with pytest.raises(RuntimeError):
        clients[1].get_keys().rename("ghost", "x")


def test_wrongtype_across_the_two_backends(clients):
    def run(c):
        c.get_bucket("str").set("v")
        bf = c.get_bloom_filter("sk")
        bf.try_init(1000, 0.01)
        return None

    _both(clients, run)
    for fn in (
        lambda c: c.get_bloom_filter("str").try_init(100, 0.01),
        lambda c: c.get_hyper_log_log("str").add("a"),
        lambda c: c.get_bit_set("str").set(3),
        lambda c: c.get_count_min_sketch("str").try_init(2, 64),
        lambda c: c.get_bucket("sk").set("x"),
        lambda c: c.get_atomic_long("sk").increment_and_get(),
        lambda c: c.get_keys().rename("str", "sk"),
        lambda c: c.get_keys().rename("sk", "str"),
        lambda c: c.get_atomic_long("str").get(),
    ):
        _both(clients, fn)
    # Neither failed attempt made a shadow object.
    _both(clients, lambda c: sorted(c.get_keys().get_keys()))


def test_bucket_dump_restore_equal_bytes(clients):
    jc, tc = clients
    for c in clients:
        c.get_bucket("d").set(["payload", 3])
    jdump = jc.get_bucket("d").dump()
    assert tc.get_bucket("d").dump() == jdump
    tc.get_bucket("d2").restore(jdump)
    assert tc.get_bucket("d2").get() == ["payload", 3]


# -- the grid snapshot codec, both directions ---------------------------------


def _fill_jax_grid(jc):
    """Every persisted kind, written through the JAX package's facades."""
    jc.get_bucket("str").set("hello")
    jc.get_atomic_long("cnt").add_and_get(41)
    jc.get_atomic_double("dbl").add_and_get(2.5)
    jc.get_long_adder("la").add(7)
    jc.get_id_generator("ids").try_init(10, 4)
    jc.get_binary_stream("bin").set(b"\x00\x01raw")
    lst = jc.get_list("lst")
    lst.add("a")
    lst.add("b")
    m = jc.get_map("map")
    m.put("k1", "v1")
    m.put("k2", 2)
    jc.get_map_cache("mc").put("k", "v", 100)
    s = jc.get_set("set")
    s.add("x")
    s.add("y")
    jc.get_set_cache("sc").add("m", 100)
    z = jc.get_scored_sorted_set("zs")
    z.add(1.5, "a")
    z.add(0.5, "b")
    jc.get_lex_sorted_set("lex").add("alpha")
    q = jc.get_queue("q")
    q.offer("job")
    jc.get_ring_buffer("ring").try_set_capacity(3)
    jc.get_ring_buffer("ring").add("r1")
    st = jc.get_stream("st")
    st.add({"f": "v"})
    st.create_group("g")
    jc.get_bucket("ttl").set("t", ttl_seconds=500)


def test_jax_grid_store_restores_into_port_and_writes_back_byte_equal(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    jc = redisson_tpu.create(redisson_tpu.Config().use_tpu_sketch(min_bucket=64))
    try:
        _fill_jax_grid(jc)
        jpath = str(tmp_path / "jax.bin")
        n = jc._grid.snapshot_to(jpath)
    finally:
        jc.shutdown()
    assert n >= 15
    store = GridStore()
    assert store.restore_from(jpath)
    kinds = {e.kind for e in store._data.values()}
    assert {"bucket", "list", "map", "mapcache", "set", "setcache", "zset",
            "stream", "atomiclong", "ringbuffer"} <= kinds
    tpath = str(tmp_path / "port.bin")
    assert store.snapshot_to(tpath) == n
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    store.shutdown()
    # The port serves the restored strings and counters through its facades.
    tc = rt.create(rt.Config().use_gpu_sketch(device="cpu"))
    try:
        assert tc._grid.restore_from(jpath)
        assert tc.get_bucket("str").get() == "hello"
        assert tc.get_atomic_long("cnt").get() == 41
        assert tc.get_atomic_double("dbl").get() == 2.5
        assert tc.get_id_generator("ids").next_id() == 10
        assert tc.get_keys().remain_time_to_live("ttl") == 500_000
        with pytest.raises(TypeError):
            tc.get_bucket("lst").get()  # a list: WRONGTYPE, not a shadow
    finally:
        tc.shutdown()


def test_port_grid_store_restores_into_jax_and_writes_back_byte_equal(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    tc = rt.create(rt.Config().use_gpu_sketch(device="cpu"))
    try:
        tc.get_bucket("str").set({"nested": [1, 2]})
        tc.get_atomic_long("cnt").add_and_get(-5)
        tc.get_atomic_double("dbl").add_and_get(0.125)
        tc.get_double_adder("da").add(1.25)
        tc.get_id_generator("ids").try_init(3, 2)
        tc.get_binary_stream("bin").set(b"bytes")
        tc.get_bucket("ttl").set("t", ttl_seconds=50)
        tpath = str(tmp_path / "port.bin")
        n = tc._grid.snapshot_to(tpath)
    finally:
        tc.shutdown()
    jc = redisson_tpu.create(redisson_tpu.Config().use_tpu_sketch(min_bucket=64))
    try:
        assert jc._grid.restore_from(tpath)
        assert jc.get_bucket("str").get() == {"nested": [1, 2]}
        assert jc.get_atomic_long("cnt").get() == -5
        jpath = str(tmp_path / "jax.bin")
        assert jc._grid.snapshot_to(jpath) == n
    finally:
        jc.shutdown()
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    # And a JAX-restored list/map file goes back through the port too.
    store = GridStore()
    assert store.restore_from(jpath)
    again = str(tmp_path / "again.bin")
    store.snapshot_to(again)
    store.shutdown()
    with open(again, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()


def test_client_snapshot_carries_the_grid(tmp_path):
    """client.snapshot writes grid_store.bin beside the sketch pools, and
    a client created on that directory restores both halves."""
    d = str(tmp_path / "snap")
    cfg = rt.Config().use_gpu_sketch(device="cpu")
    cfg.snapshot_dir = d
    c = rt.create(cfg)
    c.get_bucket("s").set("v")
    c.get_bloom_filter("bf").try_init(100, 0.01)
    c.get_bloom_filter("bf").add("k")
    c.shutdown()  # the engine's final snapshot writes both halves
    assert sorted(os.listdir(d)) == ["grid_store.bin", "sketch_meta.json",
                                     "sketch_pools.npz"]
    c2 = rt.create(cfg)
    try:
        assert c2.get_bucket("s").get() == "v"
        assert c2.get_bloom_filter("bf").contains("k")
        assert np.asarray(c2.get_bloom_filter("bf").contains_each(["k", "z"])).tolist() == [True, False]
    finally:
        c2.shutdown()
