"""The JAX package's resharding suites, run again on the port:

* ``tests/test_online_reshard.py`` (live ``change_topology``, the
  retired executor, the failure monitor);
* ``tests/test_durability.py::TestResharding`` (snapshot restores across
  shard counts and m-shard thresholds);
* ``tests/test_warm_path.py::test_prewarm_rebinds_on_change_topology``.

``port_namespace`` (``tests/test_torch_cluster.py``) rebinds each
reference module — its tests, fixtures and helpers — to the port, so a
body that builds ``Config().use_tpu_sketch(num_shards=S)`` gets the
port's sharded engine on the CPU (``PortConfig``: ``device="cpu"``,
``use_tpu_sketch`` read as ``use_gpu_sketch``).

Methods not collected as they are, each with its reason:

* ``test_online_reshard.py::test_change_topology_failure_rolls_back``:
  the reference fails its swap by asking for more shards (64) than the
  8 virtual devices; the port's shards are logical, so 64 succeed.  The
  rollback runs in ``test_torch_sharded.py::test_failed_swap_rolls_back``
  with an injected install failure instead.
* ``test_online_reshard.py::test_reshard_under_concurrent_traffic_zero_lost_writes``,
  ``::test_bitset_writes_survive_concurrent_size_class_migration`` and
  ``::test_failure_monitor_restart_after_stop`` sleep a fixed 0.05-0.5 s
  to let traffic build or a thread start; each is replaced below by a
  port case of the same name that polls with a deadline instead.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu_torch as rt  # noqa: E402
import test_durability as _ref_dur  # noqa: E402
import test_online_reshard as _ref_reshard  # noqa: E402
import test_warm_path as _ref_warm  # noqa: E402
from redisson_tpu_torch.codecs import LongCodec  # noqa: E402
from test_torch_cluster import port_namespace  # noqa: E402
from test_torch_grid_coordination import PortConfig  # noqa: E402

DEADLINE_S = 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TestResharding = port_namespace(_ref_dur)["TestResharding"]

_RESHARD_REPLACED = (
    "test_change_topology_failure_rolls_back",
    "test_reshard_under_concurrent_traffic_zero_lost_writes",
    "test_bitset_writes_survive_concurrent_size_class_migration",
    "test_failure_monitor_restart_after_stop",
)
globals().update(port_namespace(_ref_reshard, skip=_RESHARD_REPLACED))

test_prewarm_rebinds_on_change_topology = port_namespace(_ref_warm)[
    "test_prewarm_rebinds_on_change_topology"]


# -- the reshard cases that poll where the reference sleeps ------------------------


def _client(**kw):
    kw.setdefault("min_bucket", 64)
    kw.setdefault("batch_window_us", 300)
    return rt.create(PortConfig().set_codec(LongCodec()).use_gpu_sketch(**kw))


def _wait(cond, what):
    deadline = time.monotonic() + DEADLINE_S
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


def test_reshard_under_concurrent_traffic_zero_lost_writes():
    """Reshard 1 -> 4 while producers keep writing; every acknowledged
    add must be present afterwards."""
    c = _client()
    try:
        n_threads = 4
        bfs = []
        for t in range(n_threads):
            bf = c.get_bloom_filter(f"cc-{t}")
            bf.try_init(50_000, 0.01)
            bfs.append(bf)
        errors = []
        acked = [[] for _ in range(n_threads)]
        stop = threading.Event()

        def producer(tid):
            base = tid << 32
            i = 0
            try:
                while not stop.is_set() and i < 8000:
                    ks = np.arange(base + i, base + i + 64, dtype=np.uint64)
                    bfs[tid].add_all_async(ks).result(timeout=120)
                    acked[tid].append((base + i, base + i + 64))
                    i += 64
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=producer, args=(t,), daemon=True)
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        _wait(lambda: all(len(a) >= 3 for a in acked) or errors, "traffic to build")
        before = [len(a) for a in acked]
        assert c.change_topology(4) is True
        # Traffic continues on the new topology.
        _wait(lambda: all(len(a) >= b + 3 for a, b in zip(acked, before)) or errors,
              "traffic after the swap")
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        for t in range(n_threads):
            for lo, hi in acked[t]:
                got = int(np.sum(bfs[t].contains_each(np.arange(lo, hi, dtype=np.uint64))))
                assert got == hi - lo, (t, lo, hi, got)
    finally:
        c.shutdown()


def test_bitset_writes_survive_concurrent_size_class_migration():
    """Coalesced bitset sets racing an auto-grow (size-class migration)
    must all land: flush-time row resolution."""
    c = _client(batch_window_us=2000, num_shards=4)
    try:
        bs = c.get_bit_set("grow")
        bs.set(10)
        errors, acked = [], []
        stop = threading.Event()

        def writer():
            i = 0
            try:
                while not stop.is_set() and i < 3000:
                    bs.set(100 + i)
                    acked.append(100 + i)
                    i += 1
            except Exception as e:  # pragma: no cover
                errors.append(e)

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        _wait(lambda: len(acked) >= 5 or errors, "writes to start")
        bs.set(5_000)
        bs.set(50_000)
        bs.set(500_000)
        stop.set()
        t.join(timeout=60)
        assert not errors, errors
        arr = bs.as_bit_array()
        missing = [i for i in acked if not arr[i]]
        assert not missing, f"{len(missing)} acknowledged sets lost: {missing[:5]}"
        assert arr[5_000] and arr[50_000] and arr[500_000]
    finally:
        c.shutdown()


def test_failure_monitor_restart_after_stop():
    c = _client(num_shards=2)
    try:
        mon = c.get_failure_monitor(interval_s=0.05)
        mon.start()
        mon.stop()
        mon.start()  # must resume sweeping (a fresh stop event)
        sweeps = []
        mon.add_listener(sweeps.append)
        mon._ng = type("_Group", (), {"get_nodes": lambda self: [_FlakyNode()]})()
        _wait(lambda: sweeps, "a sweep of the restarted monitor")
        assert mon._thread is not None and mon._thread.is_alive()
        mon.stop()
    finally:
        c.shutdown()


class _FlakyNode:
    shard = 0
    address = "cpu:0"

    def ping(self, timeout=None):
        return False


def test_reclaim_skips_a_row_quarantined_before_a_reshard(tmp_path):
    """A row demoted to the host before a live reshard goes back on the
    rebuilt free list; the residency reclaim that comes after must not
    zero or free it again (the quarantine carries the topology epoch)."""
    c = _client(num_shards=8, residency_dir=str(tmp_path))
    try:
        eng = c._engine
        for i in range(4):
            bf = c.get_bloom_filter(f"q{i}")
            bf.try_init(1000, 0.01)
            bf.add_all(np.arange(i * 10, i * 10 + 10, dtype=np.uint64))
        victim = eng.registry.lookup("q0")
        pool, row = victim.pool, victim.row
        assert eng.residency.demote("q0")
        assert c.change_topology(4)
        assert row in pool._free
        keys = np.arange(1_000, 1_050, dtype=np.uint64)
        for n in range(pool.capacity):
            bf = c.get_bloom_filter(f"n{n}")
            bf.try_init(1000, 0.01)
            bf.add_all(keys + n)
            reuser = eng.registry.lookup(f"n{n}")
            if reuser.row == row:
                break
        assert reuser.pool is pool and reuser.row == row
        before = np.asarray(eng._host_row(reuser)).copy()
        assert before.any()
        assert eng.residency.reclaim() == 0
        assert np.array_equal(np.asarray(eng._host_row(reuser)), before)
        assert bool(np.all(bf.contains_each(keys + n)))
        assert len(pool._free) == len(set(pool._free))
        assert row not in pool._free
        # The demoted tenant still serves from the host tier.
        q0 = c.get_bloom_filter("q0")
        assert bool(np.all(q0.contains_each(np.arange(10, dtype=np.uint64))))
    finally:
        c.shutdown()
