"""The port's sketch near cache against the JAX package's.

Counterparts of ``TestShardedLRUStore``, ``TestEpochDiscipline``,
``TestEngineIntegration`` and the sketch part of ``TestDifferentialSoak``
in ``tests/test_nearcache.py``, and of ``TestNearCacheChaos`` in
``tests/test_chaos.py``.  The store and epoch tests run one scenario on
both packages' classes and require the same trace of answers; the engine
tests send the same ops through a port client (``device="cpu"``) and a
JAX client (CPU backend), both with the near cache on (the default of
both), and require equal per-op results, equal hit/miss counts and,
where the test ends healthy, equal pool bytes.  Waits poll with a 5 s
deadline; a breaker window is wound forward instead of slept through.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
from redisson_tpu import cache as jcache, chaos as jchaos  # noqa: E402
from redisson_tpu_torch import cache, chaos  # noqa: E402

DEADLINE_S = 5.0
KNOBS = dict(batch_window_us=100)
PACKAGES = {"torch": cache, "jax": jcache}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _chaos_off():
    for mod in (chaos, jchaos):
        mod.clear()
        mod.reset_counts()
    yield
    for mod in (chaos, jchaos):
        mod.clear()
        mod.reset_counts()


def make_client(**kw):
    cfg = rt.Config().use_gpu_sketch(device="cpu", **{**KNOBS, **kw})
    cfg.retry_attempts = 2
    cfg.retry_interval_ms = 5
    return rt.create(cfg)


def make_jax_client(**kw):
    cfg = redisson_tpu.Config().use_tpu_sketch(**{**KNOBS, **kw})
    cfg.retry_attempts = 2
    cfg.retry_interval_ms = 5
    return redisson_tpu.create(cfg)


def wait_until(cond, what: str) -> None:
    deadline = time.monotonic() + DEADLINE_S
    while not cond():
        assert time.monotonic() < deadline, f"{what} within {DEADLINE_S} s"
        time.sleep(0.01)


def both(scenario):
    """Run ``scenario(cache_module)`` on both packages; equal traces."""
    traces = {name: scenario(mod) for name, mod in PACKAGES.items()}
    assert traces["torch"] == traces["jax"]
    return traces["torch"]


def norm(v):
    """A comparable form of a read's answer (MISS as a marker)."""
    if v is cache.MISS or v is jcache.MISS:
        return "MISS"
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


# -- shared sharded-LRU store -------------------------------------------------


class TestShardedLRUStore:
    def test_put_get_miss_and_lru_promotion(self):
        def run(m):
            s = m.ShardedLRUStore(max_bytes=1 << 20, nshards=1)
            s.set_tenant_limits("t", max_entries=2)
            out = [norm(s.get("t", "a"))]
            s.put("t", "a", 1, 100)
            s.put("t", "b", 2, 100)
            out.append(s.get("t", "a"))  # promotes a to MRU
            s.put("t", "c", 3, 100)  # entry bound 2: evicts LRU = b
            out += [norm(s.get("t", k)) for k in "bac"]
            return out

        assert both(run) == ["MISS", 1, "MISS", 1, 3]

    def test_tenant_byte_quota_is_fair(self):
        def run(m):
            s = m.ShardedLRUStore(max_bytes=10_000, nshards=2, tenant_quota_bytes=1_000)
            for i in range(5):
                s.put("cold", f"c{i}", i, 100)
            for i in range(50):
                s.put("hot", f"h{i}", i, 100)
            assert s.tenant_bytes("hot") <= 1_000
            assert s.tenant_entry_count("cold") == 5
            assert all(s.get("cold", f"c{i}") == i for i in range(5))
            return [s.tenant_bytes("hot"), s.evictions, sorted(s.tenant_keys("hot"))]

        both(run)

    def test_global_budget_bounds_total(self):
        def run(m):
            s = m.ShardedLRUStore(max_bytes=1_000, nshards=2, tenant_quota_bytes=1_000)
            for i in range(40):
                s.put(f"t{i % 4}", f"k{i}", i, 100)
            assert s.bytes() <= 1_000
            return [s.bytes(), s.entries(), s.evictions]

        both(run)

    def test_oversized_entry_refused_and_replace_discards(self):
        def run(m):
            s = m.ShardedLRUStore(max_bytes=500, nshards=1, tenant_quota_bytes=500)
            out = [s.put("t", "big", 1, 600), s.entries()]
            s.put("t", "k", "old", 100)
            out += [s.put("t", "k", "new-but-huge", 600), norm(s.get("t", "k"))]
            return out

        assert both(run) == [False, 0, False, "MISS"]

    def test_discard_and_invalidate_tenant(self):
        def run(m):
            s = m.ShardedLRUStore(max_bytes=1 << 20, nshards=4)
            for i in range(10):
                s.put("a", i, i, 50)
                s.put("b", i, i, 50)
            s.discard("a", 3)
            out = [norm(s.get("a", 3)), s.invalidate_tenant("a")]
            out += [s.tenant_entry_count("a"), s.tenant_bytes("a"), s.tenant_entry_count("b")]
            return out

        assert both(run) == ["MISS", 9, 0, 0, 10]

    def test_on_evict_hook_and_stats(self):
        def run(m):
            evicted = []
            s = m.ShardedLRUStore(max_bytes=300, nshards=1, tenant_quota_bytes=300,
                                  on_evict=lambda t, nb: evicted.append((t, nb)))
            for i in range(5):
                s.put("t", i, i, 100)
            assert s.evictions >= 2 and len(evicted) == s.evictions
            st = s.stats()
            assert st["bytes"] <= 300 and st["entries"] <= 3
            return [evicted, st]

        both(run)

    def test_eviction_rotates_and_keeps_recent_keys(self):
        def run(m):
            s = m.ShardedLRUStore(max_bytes=1 << 20, nshards=8, tenant_quota_bytes=10_000)
            for i in range(1000):
                s.put("hot", f"k{i}", i, 100)
            per_shard = [len(sh.entries) for sh in s._shards]
            assert sum(1 for n in per_shard if n > 0) >= 4, per_shard
            alive = sum(1 for i in range(990, 1000) if s.get("hot", f"k{i}") is not m.MISS)
            assert alive >= 8, alive
            return [per_shard, alive]

        both(run)

    def test_resize_live_and_defaulted_quota(self):
        def run(m):
            s = m.ShardedLRUStore(max_bytes=1 << 20, nshards=1)
            s.put("t", "k", 1, 100)
            s.resize(max_bytes=400)  # trims lazily on the next put
            s.put("t", "k2", 2, 40)
            out = [s.bytes()]
            s.resize(max_bytes=120)
            s.put("t", "k3", 3, 10)
            out.append(s.bytes())
            q = m.ShardedLRUStore(max_bytes=64 << 20)  # quota defaults to /8
            out.append(q.tenant_quota_bytes)
            q.resize(max_bytes=1 << 30)
            out.append(q.tenant_quota_bytes)
            q.resize(tenant_quota_bytes=123456)  # explicit: sticks
            q.resize(max_bytes=64 << 20)
            out.append(q.tenant_quota_bytes)
            q.resize(tenant_quota_bytes=0)  # back to defaulted
            out.append(q.tenant_quota_bytes)
            return out

        out = both(run)
        assert out[0] <= 400 and out[1] <= 120
        assert out[2:] == [8 << 20, (1 << 30) // 8, 123456, 8 << 20]


# -- epoch discipline ---------------------------------------------------------


def _nc(m, **kw):
    return m.SketchNearCache(m.ShardedLRUStore(max_bytes=1 << 20, nshards=2), **kw)


class TestEpochDiscipline:
    def test_tagged_entry_dies_on_write(self):
        def run(m):
            nc = _nc(m)
            nc.install("o", "k", 7, captured=nc.epochs("o"), monotone=False)
            out = [norm(nc.probe("o", "k"))]
            nc.note_write("o")
            return out + [norm(nc.probe("o", "k"))]

        assert both(run) == [7, "MISS"]

    def test_monotone_positive_survives_writes_dies_structural(self):
        def run(m):
            nc = _nc(m)
            nc.install("o", "k", True, captured=nc.epochs("o"), monotone=True)
            nc.note_write("o")
            out = [norm(nc.probe("o", "k"))]  # adds never retire a positive
            nc.note_structural("o")
            return out + [norm(nc.probe("o", "k"))]

        assert both(run) == [True, "MISS"]

    def test_monotone_negative_is_write_tagged(self):
        def run(m):
            nc = _nc(m)
            nc.install("o", "k", False, captured=nc.epochs("o"), monotone=True)
            nc.note_write("o")
            return [norm(nc.probe("o", "k"))]

        assert both(run) == ["MISS"]

    def test_install_blocked_when_capture_stale(self):
        def run(m):
            nc = _nc(m)
            cap = nc.epochs("o")
            nc.note_write("o")  # a write landed after the reader captured
            nc.install("o", "k", 5, captured=cap, monotone=False)
            return [norm(nc.probe("o", "k"))]

        assert both(run) == ["MISS"]

    def test_monotone_positive_installs_across_write_not_structural(self):
        def run(m):
            nc = _nc(m)
            cap = nc.epochs("o")
            nc.note_write("o")  # ordinary write: a positive still installs
            nc.install("o", "k", True, captured=cap, monotone=True)
            out = [norm(nc.probe("o", "k"))]
            nc.note_structural("o")
            nc.install("o", "k2", True, captured=cap, monotone=True)
            return out + [norm(nc.probe("o", "k2"))]

        assert both(run) == [True, "MISS"]

    def test_drop_object_advances_epochs_forever(self):
        def run(m):
            nc = _nc(m)
            cap = nc.epochs("o")
            nc.install("o", "k", 1, captured=cap, monotone=False)
            nc.drop_object("o")
            out = [norm(nc.probe("o", "k"))]
            # A successor under the same name continues the sequence.
            nc.install("o", "k", 1, captured=cap, monotone=False)
            return out + [norm(nc.probe("o", "k")), nc.epochs("o")]

        assert both(run)[:2] == ["MISS", "MISS"]

    def test_invalidate_all_retires_never_mutated_names(self):
        def run(m):
            nc = _nc(m)
            cap = nc.epochs("restored-only")  # the floor pair
            nc.invalidate_all()
            nc.install("restored-only", "k", 7, captured=cap, monotone=False)
            nc.install("restored-only", "p", True, captured=cap, monotone=True)
            return [norm(nc.probe("restored-only", "k")),
                    norm(nc.probe("restored-only", "p"))]

        assert both(run) == ["MISS", "MISS"]

    def test_invalidate_all_and_set_enabled(self):
        def run(m):
            nc = _nc(m)
            nc.install("o", "k", 1, captured=nc.epochs("o"), monotone=False)
            nc.invalidate_all()
            out = [norm(nc.probe("o", "k"))]
            nc.install("o", "k", 2, captured=nc.epochs("o"), monotone=False)
            nc.set_enabled(False)
            out.append(nc.store.entries())
            nc.set_enabled(True)
            return out + [norm(nc.probe("o", "k"))]

        assert both(run) == ["MISS", 0, "MISS"]

    def test_active_respects_max_batch(self):
        def run(m):
            nc = _nc(m, max_batch=8)
            return [nc.active(8), nc.active(9), nc.active(0)]

        assert both(run) == [True, False, False]

    def test_disabled_cache_refuses_installs(self):
        def run(m):
            nc = _nc(m)
            captured = nc.epochs("o")
            nc.set_enabled(False)
            nc.install("o", "k", 1, captured=captured, monotone=False)
            nc.install("o", "p", True, captured=captured, monotone=True)
            out = [nc.store.entries(), nc.store.bytes()]
            nc.set_enabled(True)
            return out + [norm(nc.probe("o", "k"))]

        assert both(run) == [0, 0, "MISS"]

    def test_epoch_dict_bounded_under_name_churn(self):
        def run(m):
            nc = _nc(m)
            nc._epoch_cap = nc._epoch_prune_at = 32
            nc.note_write("live")
            nc.install("live", "k", 7, captured=nc.epochs("live"), monotone=False)
            live_epochs = nc.epochs("live")
            for i in range(1000):
                name = f"ephemeral-{i}"
                nc.note_write(name)
                nc.drop_object(name)
            assert len(nc._epochs) <= 2 * 32 + 2
            assert nc.epochs("ephemeral-0") == nc._floor
            assert nc._floor > (1, 1)
            assert nc.epochs("live") == live_epochs
            assert nc.probe("live", "k") == 7
            return [len(nc._epochs), nc._floor]

        both(run)

    def test_cache_keys(self):
        blocks = np.arange(12, dtype=np.uint32).reshape(3, 4)
        lengths = np.array([4, 9, 16], np.uint32)

        def run(m):
            nc = m.SketchNearCache
            return [nc.encoded_keys(blocks, lengths), nc.encoded_keys(blocks, 5),
                    nc.hashed_keys(np.array([1, 2], np.uint64), np.array([3, 4], np.uint64))]

        out = both(run)
        assert out[0][0] == blocks[0].tobytes()[:4] and len(out[1][2]) == 5


# -- engine integration -------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    port, jax_c = make_client(), make_jax_client()
    yield port, jax_c
    port.shutdown()
    jax_c.shutdown()


def on_both(pair, fn):
    """fn(client) -> list of answers, run on the port and the JAX client;
    also returns each engine's near cache, after the run."""
    mine, ref = fn(pair[0]), fn(pair[1])
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert np.array_equal(np.asarray(a), np.asarray(b)), (mine, ref)
    return mine, pair[0]._engine.nearcache, pair[1]._engine.nearcache


def same_counts(nc, jnc):
    assert (nc.hits, nc.misses) == (jnc.hits, jnc.misses)


class TestEngineIntegration:
    def test_bloom_negative_invalidated_by_add(self, pair):
        def run(c):
            bf = c.get_bloom_filter("nc-bf")
            bf.try_init(10_000, 0.01)
            out = [bf.contains("ghost")]  # cached negative
            bf.add("ghost")  # submit-time bump: the negative dies NOW
            return out + [bf.contains("ghost")]

        assert on_both(pair, run)[0] == [False, True]

    def test_bloom_positive_survives_other_adds_and_hits(self, pair):
        def run(c):
            bf = c.get_bloom_filter("nc-bf2")
            bf.try_init(10_000, 0.01)
            bf.add("hot")
            out = [bf.contains("hot")]
            h0 = c._engine.nearcache.hits
            bf.add("other-key")  # ordinary write: the positive survives
            out.append(bf.contains("hot"))
            return out + [c._engine.nearcache.hits - h0]

        assert on_both(pair, run)[0] == [True, True, 1]

    def test_bloom_partial_hit_split(self, pair):
        keys = [f"k{i}" for i in range(10)]

        def run(c):
            bf = c.get_bloom_filter("nc-bf3")
            bf.try_init(10_000, 0.01)
            bf.add_all(keys[:5])
            warm = bf.contains_each(keys[:5])  # caches 5 positives
            nc = c._engine.nearcache
            nc.hits = nc.misses = 0
            got = bf.contains_each(keys)
            counts = [nc.hits, nc.misses]
            nc.store.clear()
            want = bf.contains_each(keys)  # uncached, from the device
            return [warm, got, counts, want]

        out, nc, jnc = on_both(pair, run)
        assert out[2] == [5, 5] and np.array_equal(out[1], out[3])

    def test_bitset_get_cached_and_clear_is_structural(self, pair):
        def run(c):
            bs = c.get_bit_set("nc-bs")
            bs.set(5)
            out = [bs.get(5)]
            h0 = c._engine.nearcache.hits
            out.append(bs.get(5))
            out.append(c._engine.nearcache.hits - h0)
            bs.set(5, False)  # structural: retires the monotone positive
            out.append(bs.get(5))
            bs.flip(5)
            return out + [bs.get(5)]

        assert on_both(pair, run)[0] == [True, True, 1, False, True]

    def test_bitset_scalars_invalidate_on_write(self, pair):
        def run(c):
            bs = c.get_bit_set("nc-bs2")
            bs.set_many(np.array([1, 3, 5]))
            out = [bs.cardinality(), bs.cardinality()]  # the second is cached
            bs.set(7)
            return out + [bs.cardinality(), bs.length(), bs.first_set_bit(),
                          bs.first_clear_bit()]

        assert on_both(pair, run)[0] == [3, 3, 4, 8, 1, 0]

    def test_cms_estimate_and_total_invalidated_by_add(self, pair):
        def run(c):
            cms = c.get_count_min_sketch("nc-cms")
            cms.try_init(4, 256)
            cms.add("k", 3)
            out = [cms.estimate("k"), cms.estimate("k"), cms.total_count(),
                   cms.total_count()]
            cms.add("k", 2)
            return out + [cms.estimate("k"), cms.total_count()]

        out, nc, jnc = on_both(pair, run)
        assert out == [3, 3, 3, 3, 5, 5]

    def test_hll_count_invalidated_by_add(self, pair):
        def run(c):
            h = c.get_hyper_log_log("nc-hll")
            h.add_all([f"v{i}" for i in range(100)])
            n = h.count()
            out = [n, h.count()]
            h.add_all([f"w{i}" for i in range(100)])
            return out + [h.count()]

        out = on_both(pair, run)[0]
        assert out[0] == out[1] < out[2]

    def test_delete_drops_cached_entries(self, pair):
        def run(c):
            bf = c.get_bloom_filter("nc-del")
            bf.try_init(10_000, 0.01)
            bf.add("x")
            out = [bf.contains("x")]
            bf.delete()
            bf.try_init(10_000, 0.01)
            return out + [bf.contains("x")]  # successor: no stale positive

        assert on_both(pair, run)[0] == [True, False]

    def test_rename_drops_both_names(self, pair):
        def run(c):
            bf = c.get_bloom_filter("nc-rn")
            bf.try_init(10_000, 0.01)
            bf.add("x")
            out = [bf.contains("x")]
            bf.rename("nc-rn2")
            return out + [c.get_bloom_filter("nc-rn2").contains("x"),
                          c.get_bloom_filter("nc-rn").is_exists()]

        assert on_both(pair, run)[0] == [True, True, False]

    def test_expire_drops_cached_entries(self, pair):
        def run(c):
            bf = c.get_bloom_filter("nc-ttl")
            bf.try_init(10_000, 0.01)
            bf.add("x")
            out = [bf.contains("x")]
            c._engine.expire_at("nc-ttl", time.time() - 1.0)
            out.append(bf.is_exists())
            bf.try_init(10_000, 0.01)
            return out + [bf.contains("x")]

        assert on_both(pair, run)[0] == [True, False, False]

    def test_bitset_grow_is_structural(self, pair):
        def run(c):
            bs = c.get_bit_set("nc-grow")
            bs.set(1)
            out = [bs.get(1)]
            s_before = c._engine.nearcache.epochs("nc-grow")[1]
            bs.set(300_000)  # size-class migration
            out.append(c._engine.nearcache.epochs("nc-grow")[1] > s_before)
            return out + [bs.get(1), bs.get(300_000)]

        assert on_both(pair, run)[0] == [True, True, True, True]

    def test_big_batches_bypass(self, pair):
        keys = np.arange(2048, dtype=np.uint64)  # > nearcache_max_batch

        def run(c):
            bf = c.get_bloom_filter("nc-bulk")
            bf.try_init(100_000, 0.01)
            bf.add_all(keys)
            return [bf.contains_each(keys), c._engine.nearcache.store.tenant_entry_count("nc-bulk")]

        assert on_both(pair, run)[0][1] == 0

    def test_disabled_never_populates(self):
        port, jax_c = make_client(nearcache=False), make_jax_client(nearcache=False)
        try:
            for c in (port, jax_c):
                bf = c.get_bloom_filter("nc-off")
                bf.try_init(10_000, 0.01)
                bf.add("x")
                assert bf.contains("x") is True
                nc = c._engine.nearcache
                assert nc.store.entries() == 0 and nc.hits == 0
        finally:
            port.shutdown()
            jax_c.shutdown()

    def test_metrics_counters_and_gauges(self, pair):
        def run(c):
            bf = c.get_bloom_filter("nc-met")
            bf.try_init(10_000, 0.01)
            bf.add("x")
            bf.contains("x")
            bf.contains("x")
            return [c._engine.nearcache.stats()["entries"] >= 1]

        on_both(pair, run)
        text = pair[0]._engine.obs.registry.render_prometheus()
        for fam in ("rtpu_nearcache_hits", "rtpu_nearcache_misses",
                    "rtpu_nearcache_bytes", "rtpu_nearcache_entries"):
            assert fam in text, fam
        # Evictions render once the store evicts (a labelless counter).
        assert pair[0]._engine.obs.registry.family("rtpu_nearcache_evictions_total") is not None
        st = pair[0]._engine.nearcache.stats()
        assert st["hits"] >= 1 and st["entries"] >= 1 and st["enabled"]

    def test_hit_and_miss_counts_equal_across_packages(self, pair):
        """The whole module's traffic so far, counted by both packages'
        caches, hit for hit."""
        same_counts(pair[0]._engine.nearcache, pair[1]._engine.nearcache)


# -- differential soak, sketch part -------------------------------------------

BLOOM_POINTS = {"torch": ("dispatch.bloom_mixed_keys", "dispatch.bloom_mixed_keys_runs"),
                "jax": ("dispatch.bloom_mixed", "dispatch.bloom_mixed_keys",
                        "dispatch.bloom_mixed_keys_runs")}
BITSET_POINTS = ("dispatch.bitset_mixed", "dispatch.bitset_mixed_runs")


def heal(eng, chaos_mod) -> None:
    """Clear the schedule, wind every open breaker's window forward and
    wake the health monitor; poll until the mirrors reconciled."""
    chaos_mod.clear()
    board = eng.health.board
    with board._lock:
        for b in board._breakers.values():
            if b.state != "closed":
                b.opened_at -= board.open_s
                b.probe_at = None
    eng.health._monitor_wake.set()
    wait_until(lambda: not eng.health.any_degraded and board.open_count() == 0,
               "reconcile")


def degrade(eng, op) -> None:
    for _ in range(8):
        try:
            op()
        except Exception:
            pass  # typed failure while the breaker counts
        if eng.health.any_degraded:
            return
    raise AssertionError("no breaker opened")


class _Soak:
    """One client's soak objects; ``step`` draws the same op from the
    same seeded stream on both packages."""

    def __init__(self, c):
        self.c = c
        self.bf = c.get_bloom_filter("soak-bf")
        self.bf.try_init(20_000, 0.01)
        self.bs = c.get_bit_set("soak-bs")
        self.cms = c.get_count_min_sketch("soak-cms")
        self.cms.try_init(4, 512)
        self.hll = c.get_hyper_log_log("soak-hll")

    def write(self, rng, keyspace):
        op = int(rng.integers(0, 6))
        if op == 0:
            return self.bf.add_all(rng.integers(0, keyspace, 8).astype(np.uint64))
        if op == 1:
            idx = rng.integers(0, 4096, 8)
            return self.bs.set_many(idx, bool(rng.integers(0, 2)))
        if op == 2:
            return self.bs.flip(int(rng.integers(0, 4096)))
        if op == 3:
            ks = rng.integers(0, keyspace, 8).astype(np.uint64)
            return self.cms.add_all(ks, rng.integers(1, 5, 8))
        if op == 4:
            return self.hll.add_all(rng.integers(0, keyspace, 16).astype(np.uint64))
        lo = int(rng.integers(0, 2048))
        hi = lo + int(rng.integers(1, 64))
        if rng.integers(0, 2):
            self.bs.set_range(lo, hi)
        else:
            self.bs.clear_range(lo, hi)
        return None

    def read(self, rng, keyspace):
        ks = rng.integers(0, keyspace, int(rng.integers(1, 24))).astype(np.uint64)
        idx = rng.integers(0, 4096, int(rng.integers(1, 16)))
        return [self.bf.contains_each(ks), self.bs.get_many(idx),
                self.cms.estimate_all(ks), self.hll.count(), self.bs.cardinality()]


def _soak_pass(soaks, seed, n, keyspace):
    """n mixed write/read steps with the same stream on both packages;
    every result equal."""
    rngs = [np.random.default_rng(seed) for _ in soaks]
    for i in range(n):
        outs = [s.write(r, keyspace) for s, r in zip(soaks, rngs)]
        assert np.array_equal(np.asarray(outs[0]), np.asarray(outs[1])), (i, outs)
        if i % 3 == 0:
            reads = [s.read(r, keyspace) for s, r in zip(soaks, rngs)]
            for a, b in zip(*reads):
                assert np.array_equal(np.asarray(a), np.asarray(b)), (i, reads)


class TestDifferentialSoak:
    def test_zero_stale_reads_across_chaos(self):
        """Cached reads vs the JAX package's through healthy writes, a
        size-class migration, a CMS reset, a breaker-open degradation
        (mirror writes must keep bumping epochs) and its reconcile."""
        port = make_client(breaker_failure_threshold=2, breaker_open_ms=60_000)
        jax_c = make_jax_client(breaker_failure_threshold=2, breaker_open_ms=60_000)
        clients = ((port, chaos, "torch"), (jax_c, jchaos, "jax"))
        try:
            soaks = [_Soak(port), _Soak(jax_c)]
            _soak_pass(soaks, 7, 45, 2000)
            for s in soaks:  # migration and reset (both structural)
                s.bs.set(300_000)
                s.cms.add("reset-probe", 3)
                s.c._engine.cms_reset("soak-cms")
                assert s.cms.estimate("reset-probe") == 0
            _soak_pass(soaks, 8, 15, 2000)
            for c, mod, name in clients:
                for p in BLOOM_POINTS[name] + BITSET_POINTS:
                    mod.inject(p, "error", 1.0)
                eng = c._engine
                degrade(eng, lambda c=c: c.get_bloom_filter("soak-bf").add(np.uint64(900_001)))
                degrade(eng, lambda c=c: c.get_bit_set("soak-bs").set(4097))
                # The sacrificial ops, on the mirror now (idempotent).
                assert c.get_bloom_filter("soak-bf").add(np.uint64(900_001)) in (True, False)
                c.get_bit_set("soak-bs").set(4097)
            assert port._engine.health.degraded_kind("bloom")
            _soak_pass(soaks, 9, 24, 2000)
            for c, mod, _ in clients:
                heal(c._engine, mod)
            _soak_pass(soaks, 10, 24, 2000)
            probe = np.arange(0, 2000, 7, dtype=np.uint64)
            idx = np.arange(4096)
            for lo in range(0, len(probe), 512):
                a, b = (s.bf.contains_each(probe[lo:lo + 512]) for s in soaks)
                assert np.array_equal(a, b)
            for lo in range(0, 4096, 1024):
                a, b = (s.bs.get_many(idx[lo:lo + 1024]) for s in soaks)
                assert np.array_equal(a, b)
            assert soaks[0].hll.count() == soaks[1].hll.count()
            for kind in ("bloom", "bitset", "cms", "hll"):
                for a, b in zip(*(pools(c, kind) for c in (port, jax_c))):
                    assert np.array_equal(a, b), kind
        finally:
            port.shutdown()
            jax_c.shutdown()


def pools(client, kind):
    eng = client._engine
    eng._drain()
    return [np.asarray(eng.executor.state_to_host(p)) for p in eng.registry.pools()
            if p.spec.kind == kind]


# -- near cache x chaos -------------------------------------------------------


class TestNearCacheChaos:
    """Under breaker-open degradation every MIRROR write bumps the write
    epoch — a cached pre-degradation read never serves stale — and
    reconcile-on-close leaves cache and device identical."""

    def test_mirror_writes_bump_epochs_no_stale_negative(self):
        for c, mod, name in ((make_client(breaker_failure_threshold=2,
                                          breaker_open_ms=60_000), chaos, "torch"),
                             (make_jax_client(breaker_failure_threshold=2,
                                              breaker_open_ms=60_000), jchaos, "jax")):
            eng = c._engine
            try:
                bf = c.get_bloom_filter("ncc-bf")
                bf.try_init(20_000, 0.01)
                bf.add("pre")
                assert bf.contains("late-add") is False  # cached negative
                assert bf.contains("pre") is True  # cached positive
                assert eng.nearcache.store.entries() >= 2
                for p in BLOOM_POINTS[name]:
                    mod.inject(p, "error", 1.0)
                degrade(eng, lambda: bf.add("open"))
                # The mirror write bumps the epoch at submit: the cached
                # negative must NOT answer this read.
                assert bf.add("late-add") is True
                assert bf.contains("late-add") is True
                assert bf.contains("pre") is True
            finally:
                mod.clear()
                c.shutdown()

    def test_reconcile_leaves_cache_and_device_identical(self):
        out = {}
        for c, mod, name in ((make_client(breaker_failure_threshold=2,
                                          breaker_open_ms=60_000), chaos, "torch"),
                             (make_jax_client(breaker_failure_threshold=2,
                                              breaker_open_ms=60_000), jchaos, "jax")):
            eng = c._engine
            nc = eng.nearcache
            try:
                bf = c.get_bloom_filter("ncc-rec")
                bf.try_init(20_000, 0.01)
                pre = [f"pre{i}" for i in range(20)]
                bf.add_all(pre)
                for p in BLOOM_POINTS[name]:
                    mod.inject(p, "error", 1.0)
                degrade(eng, lambda: bf.add("open"))
                during = [f"during{i}" for i in range(20)]
                added = [bf.add(k) for k in during]
                cached_during = [bf.contains(k) for k in during]  # mirror-served
                heal(eng, mod)
                assert not eng._mirrors
                probe = pre + during + [f"ghost{i}" for i in range(20)]
                cached = [bf.contains(k) for k in probe]  # may serve from cache
                nc.store.clear()  # force the next pass to the device
                device = [bf.contains(k) for k in probe]
                assert cached == device
                out[name] = (added, cached_during, device, pools(c, "bloom"))
            finally:
                mod.clear()
                c.shutdown()
        for a, b in zip(out["torch"][:3], out["jax"][:3]):
            assert a == b
        for a, b in zip(out["torch"][3], out["jax"][3]):
            assert np.array_equal(a, b)
