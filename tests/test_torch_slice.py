"""The port's whole slice against the JAX package at a small size: one
JAX client (``use_tpu_sketch()``) and one port client
(``use_gpu_sketch(device="cpu")``) run the same calls; every per-op
result must be identical and the tenant rows byte-equal."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
from redisson_tpu_torch.interop import load_sketch_rows  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The tests run several pytest workers side by side; one intra-op
    # thread per worker avoids oversubscribing the CPU.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _row(client, name):
    eng = client._engine
    eng._drain()
    e = eng.registry.lookup(name)
    u = e.pool.row_units
    return eng.executor.state_to_host(e.pool)[e.row * u : (e.row + 1) * u]


def _pool_bytes(client, name):
    eng = client._engine
    eng._drain()
    return eng.executor.state_to_host(eng.registry.lookup(name).pool)


@pytest.fixture(scope="module")
def clients():
    # One padded batch size for every launch here keeps the JAX side to a
    # few compiles; padding never changes a result.
    knobs = dict(min_bucket=8192)
    jc = redisson_tpu.create(redisson_tpu.Config().use_tpu_sketch(**knobs))
    tc = rt.create(rt.Config().use_gpu_sketch(device="cpu", **knobs))
    yield jc, tc
    tc.shutdown()
    jc.shutdown()


def test_config1_flow(clients):
    """try_init(20k, 1%) -> add_all_async x4 -> contains_many ->
    contains_each on keys outside the loaded range (the measured FPP)."""
    rng = np.random.default_rng(0)
    n = 20_000
    batches = [rng.integers(0, 2 * n, 6000).astype(np.uint64) for _ in range(3)]
    outside = rng.integers(3 * n, 8 * n, 4096).astype(np.uint64)
    out = []
    for c in clients:
        bf = c.get_bloom_filter("cfg1")
        assert bf.try_init(n, 0.01)
        adds = [bf.add_all_async(np.arange(i * 5000, (i + 1) * 5000, dtype=np.uint64))
                for i in range(4)]
        added = [a.result() for a in adds]
        hits = bf.contains_many(batches)
        fp = bf.contains_each(outside)
        out.append((added, hits, fp, _row(c, "cfg1")))
    (ja, jh, jf, jrow), (ta, th, tf, trow) = out
    for x, y in zip(ja + jh + [jf], ta + th + [tf]):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    assert 0.97 * n <= sum(int(a.sum()) for a in ta) <= n
    assert tf.mean() <= 0.02
    assert np.array_equal(jrow, trow)


def _tenant_traffic(bf, seed):
    rng = np.random.default_rng(seed)
    results = []
    for i in range(4):
        keys = rng.integers(0, 1500, 400).astype(np.uint64)
        if i == 3:
            flags = rng.random(400) < 0.5
            results.append(bf.mixed_async(keys, flags))
        elif i % 2:
            results.append(bf.contains_all_async(keys))
        else:
            results.append(bf.add_all_async(keys))
    return [r.result() for r in results]


def test_multitenant_threaded_mixed_runs(clients):
    """Four threads, each owning two tenants, interleave adds, contains
    and mixed runs; the coalescer merges them into multi-run launches."""
    names = [f"mt{i}" for i in range(8)]
    out = []
    for c in clients:
        for name in names:
            assert c.get_bloom_filter(name).try_init(2000, 0.01)
        res: dict = {}

        def worker(t):
            for name in names[t::4]:
                res[name] = _tenant_traffic(c.get_bloom_filter(name), int(name[2:]))

        threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        out.append((res, _pool_bytes(c, names[0])))
    (jres, jpool), (tres, tpool) = out
    for name in names:
        for x, y in zip(jres[name], tres[name]):
            assert np.array_equal(x, y)
    assert np.array_equal(jpool, tpool)


def test_cms_stream_topk(clients):
    rng = np.random.default_rng(2)
    events = (rng.zipf(1.2, 1500) % 400).astype(np.uint64)
    more = (rng.zipf(1.2, 500) % 400).astype(np.uint64)
    out = []
    for c in clients:
        cms = c.get_count_min_sketch("stream")
        assert cms.try_init(4, 2048, track_top_k=5)
        seq = cms.add_all_seq(events)
        vec = cms.add_all(more)
        est = cms.estimate_all(np.arange(50, dtype=np.uint64))
        out.append((seq, vec, est, cms.top_k(5), cms.total_count(), _row(c, "stream")))
    (js, jv, je, jt, jn, jrow), (ts, tv, te, tt, tn, trow) = out
    assert np.array_equal(js, ts) and np.array_equal(jv, tv) and np.array_equal(je, te)
    assert jt == tt and jn == tn == 2000
    assert np.array_equal(jrow, trow)
    # Streaming semantics: the first key's k-th occurrence reads >= k.
    first = events == events[0]
    assert np.all(ts[first] >= np.arange(1, first.sum() + 1))


def test_fallback_gate_geometry(clients):
    """d*w % 128 != 0: both packages take the vectorized path, whose
    estimates are batch-final."""
    events = np.array([7, 7, 7, 9], np.uint64)
    out = [(c.get_count_min_sketch("odd").try_init(3, 1000),
            c.get_count_min_sketch("odd").add_all_seq(events)) for c in clients]
    assert out[0][0] and out[1][0]
    assert np.array_equal(out[0][1], out[1][1])
    assert list(out[1][1]) == [3, 3, 3, 1]


def test_load_sketch_rows_carries_jax_state(clients):
    jc, tc = clients
    rng = np.random.default_rng(5)
    jbf = jc.get_bloom_filter("carried")
    jbf.try_init(20_000, 0.01)  # cfg1's pool: no new pool shape
    jbf.add_all(rng.integers(0, 10_000, 3000).astype(np.uint64))
    jcms = jc.get_count_min_sketch("carried_cms")
    jcms.try_init(4, 2048)
    jcms.add_all((rng.zipf(1.3, 2000) % 100).astype(np.uint64))
    eng = jc._engine
    tbf = load_sketch_rows(tc, "carried", "bloom", eng.params("carried"), _row(jc, "carried"))
    tcms = load_sketch_rows(tc, "carried_cms", "cms", eng.params("carried_cms"),
                            _row(jc, "carried_cms"))
    probe = rng.integers(0, 20_000, 5000).astype(np.uint64)
    assert np.array_equal(jbf.contains_each(probe), tbf.contains_each(probe))
    assert np.array_equal(jcms.estimate_all(np.arange(100, dtype=np.uint64)),
                          tcms.estimate_all(np.arange(100, dtype=np.uint64)))
    more = rng.integers(0, 10_000, 500).astype(np.uint64)
    assert np.array_equal(jbf.add_all_async(more).result(), tbf.add_all_async(more).result())
    assert np.array_equal(_row(jc, "carried"), _row(tc, "carried"))
    with pytest.raises(ValueError):
        load_sketch_rows(tc, "short", "bloom", eng.params("carried"), np.zeros(3, np.uint32))


def test_direct_dispatch_and_fast_add():
    """coalesce=False + exact_add_semantics=False: single-tenant keyed
    adds (flags against the state before the call) and contains."""
    knobs = dict(coalesce=False, exact_add_semantics=False)
    jc = redisson_tpu.create(redisson_tpu.Config().use_tpu_sketch(**knobs))
    tc = rt.create(rt.Config().use_gpu_sketch(device="cpu", **knobs))
    try:
        rng = np.random.default_rng(6)
        keys = rng.integers(0, 2000, 3000).astype(np.uint64)  # duplicates
        probe = rng.integers(0, 4000, 2000).astype(np.uint64)
        out = []
        for c in (jc, tc):
            bf = c.get_bloom_filter("direct")
            bf.try_init(4000, 0.01)
            out.append((bf.add_all_async(keys).result(), bf.contains_each(probe),
                        _row(c, "direct")))
        for x, y in zip(*out):
            assert np.array_equal(x, y)
    finally:
        tc.shutdown()
        jc.shutdown()


def test_port_imports_neither_jax_nor_the_reference():
    """The package and chip_smoke.py import with jax and redisson_tpu
    blocked, and run every object of the port on the CPU, with a
    DUMP/RESTORE and a batch."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['redisson_tpu'] = None\n"
        "import numpy as np\n"
        "import chip_smoke\n"
        "import redisson_tpu_torch as rt\n"
        "c = rt.create(rt.Config().use_gpu_sketch(device='cpu'))\n"
        "bf = c.get_bloom_filter('b')\n"
        "bf.try_init(1000, 0.01)\n"
        "assert bf.add('k') and bf.contains('k')\n"
        "cms = c.get_count_min_sketch('c')\n"
        "cms.try_init(2, 128)\n"
        "assert list(cms.add_all_seq(np.array([3, 3, 3], np.uint64))) == [1, 2, 3]\n"
        "h = c.get_hyper_log_log('h')\n"
        "assert h.add_all(['a', 'b', 'c']) and h.count() == 3\n"
        "bs = c.get_bit_set('s')\n"
        "assert not bs.set(70000) and bs.get(70000) and not bs.get(3)\n"
        "c.get_bloom_filter('b2').restore(bf.dump())\n"
        "batch = c.create_batch()\n"
        "batch.get_bloom_filter('b2').contains('k')\n"
        "assert batch.execute()[0] is True\n"
        "c.shutdown()\n"
    )  # a blocked module raises ImportError on any import of it
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
