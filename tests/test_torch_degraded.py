"""Degraded-mode serving on the port against the JAX package.

Counterparts of ``TestDegradedServe`` and ``TestDegradedKinds`` in
``tests/test_chaos.py``.  For each sketch kind, one port client and one
JAX client (CPU; the JAX side runs K1 as Pallas ``interpret=True``) get
the same numpy-seeded ops under the same fault schedule: the kind's
dispatch methods fail until its breaker opens, the same ops are then
served by the host golden mirrors, and once the schedule is cleared and
the breaker's window is wound forward the mirrors reconcile back.  Every
per-op result must be equal in both packages, and so must every pool's
bytes after the reconcile.

Breakers open for 60 s here, so no probe closes them in the middle of a
degraded window; ``heal`` winds the window forward instead of sleeping.
Every wait polls with a 5 s deadline.  Also here: a snapshot taken while
degraded keeps the mirror's writes and restores into the JAX package, no
future is lost while a breaker opens, and a dispatch that fails after an
in-place pool write is not retried (its ops land exactly once).
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
from redisson_tpu import chaos as jchaos  # noqa: E402
from redisson_tpu.codecs import LongCodec as JaxLongCodec  # noqa: E402
from redisson_tpu_torch import chaos  # noqa: E402
from redisson_tpu_torch.codecs import LongCodec  # noqa: E402
from redisson_tpu_torch.executor.failures import (  # noqa: E402
    NonRetryableDispatchError,
    RedissonTpuError,
    RetryExhaustedError,
)
from redisson_tpu_torch.ops import golden  # noqa: E402
from redisson_tpu_torch.utils import hashing  # noqa: E402

DEADLINE_S = 5.0
KNOBS = dict(min_bucket=64, batch_window_us=100, breaker_failure_threshold=2,
             breaker_open_ms=60_000)

POINTS = {
    "bloom": ("dispatch.bloom_mixed", "dispatch.bloom_mixed_keys",
              "dispatch.bloom_mixed_keys_runs"),
    "bitset": ("dispatch.bitset_mixed", "dispatch.bitset_mixed_runs"),
    "hll": ("dispatch.hll_add_changed", "dispatch.hll_add_single",
            "dispatch.hll_add", "dispatch.hll_add_keys_single"),
    "cms": ("dispatch.cms_update_estimate", "dispatch.cms_update_estimate_seq",
            "dispatch.cms_update", "dispatch.cms_estimate"),
}


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


def make_client(snapshot_dir=None, **kw):
    cfg = rt.Config().set_codec(LongCodec()).use_gpu_sketch(
        device="cpu", **{**KNOBS, **kw})
    cfg.retry_attempts = 2
    cfg.retry_interval_ms = 5
    if snapshot_dir is not None:
        cfg.snapshot_dir = str(snapshot_dir)
    return rt.create(cfg)


def make_jax_client(snapshot_dir=None, **kw):
    cfg = redisson_tpu.Config().set_codec(JaxLongCodec()).use_tpu_sketch(
        nearcache=False, **{**KNOBS, **kw})
    cfg.retry_attempts = 2
    cfg.retry_interval_ms = 5
    if snapshot_dir is not None:
        cfg.snapshot_dir = str(snapshot_dir)
    return redisson_tpu.create(cfg)


@pytest.fixture(scope="module")
def pair():
    """(port client, JAX client), shared by the kind tests (each uses its
    own object names and ends healthy)."""
    port, jax_c = make_client(), make_jax_client()
    yield port, jax_c
    port.shutdown()
    jax_c.shutdown()


def wait_until(cond, what: str) -> None:
    deadline = time.monotonic() + DEADLINE_S
    while not cond():
        assert time.monotonic() < deadline, f"{what} within {DEADLINE_S} s"
        time.sleep(0.01)


def degrade(eng, op) -> None:
    """Drive ``op`` (failing under the installed schedule) until a breaker
    opens and the engine reports a degraded kind."""
    for _ in range(6):
        try:
            op()
        except Exception:
            pass  # typed failure while the breaker counts
        if eng.health.any_degraded:
            return
    raise AssertionError("no breaker opened")


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
    wait_until(lambda: not eng.health.any_degraded and not eng._mirrors
               and board.open_count() == 0, "reconcile")


def pools_of(client, kind):
    eng = client._engine
    eng._drain()
    return [eng.executor.state_to_host(p) for p in eng.registry.pools()
            if p.spec.kind == kind]


def run_both(pair, kind, setup, opener, window):
    """setup(client) -> handle; opener(handle); window(handle) -> list
    of per-op results.  Runs the flow on both packages and returns
    ((results, degraded_ops) of the port, the same of the JAX package)."""
    out = {}
    for client, mod in ((pair[0], chaos), (pair[1], jchaos)):
        eng = client._engine
        h = setup(client)
        for p in POINTS[kind]:
            mod.inject(p, "error", 1.0)
        degrade(eng, lambda: opener(h))
        assert eng.health.degraded_kind(kind)
        res = window(h)
        assert eng._mirrors, "the window was not served by a mirror"
        served = eng.obs.degraded_ops.get((kind,))
        fired = mod.counts()
        heal(eng, mod)
        out[mod] = (res, served, fired)
    # The schedule fired on the same points, as often, in both packages.
    assert out[chaos][2] == out[jchaos][2]
    return out[chaos][:2], out[jchaos][:2]


def assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert np.array_equal(np.asarray(x), np.asarray(y))
        else:
            assert x == y


def _keys(a, b):
    return np.arange(a, b, dtype=np.uint64)


class TestDegradedKinds:
    def test_bloom(self, pair):
        rng = np.random.default_rng(1)
        mixed_keys = rng.integers(0, 800, 300).astype(np.uint64)
        flags = rng.random(300) < 0.5

        def setup(c):
            bf = c.get_bloom_filter("deg-bf")
            bf.try_init(20_000, 0.01)
            bf.add_all(_keys(0, 200))
            return bf

        def window(bf):
            return [bf.add_all(_keys(150, 400)), bf.contains_each(_keys(0, 600)),
                    bf.mixed_async(mixed_keys, flags).result(), bf.add(10**7),
                    bf.add(10**7), bf.contains(10**7 + 1), bf.count()]

        (mine, served), (ref, _) = run_both(
            pair, "bloom", setup, lambda bf: bf.add(10**6), window)
        assert_same(mine, ref)
        assert mine[3] is True and mine[4] is False
        assert served >= 250 + 600 + 300
        for a, b in zip(pools_of(pair[0], "bloom"), pools_of(pair[1], "bloom")):
            assert np.array_equal(a, b)

    def test_bitset_with_a_degraded_window_grow(self, pair):
        rng = np.random.default_rng(2)
        idx = rng.integers(0, 4000, 500).astype(np.uint32)

        def setup(c):
            bs = c.get_bit_set("deg-bs")
            bs.set_many(np.array([3, 77, 500], np.uint32))
            return bs

        def window(bs):
            row_bits = bs.size()
            return [bs.set_many(idx), bs.get_many(idx[::-1].copy()), bs.flip(3),
                    bs.clear_bit(77), bs.set(100), bs.get(100), bs.cardinality(),
                    bs.length(), bs.first_set_bit(), bs.to_byte_array(),
                    # a grow while degraded: the mirror grows, and reconcile
                    # writes it at the NEW row size
                    bs.set(row_bits + 513), bs.get(row_bits + 513), bs.length()]

        (mine, _), (ref, _) = run_both(
            pair, "bitset", setup, lambda bs: bs.set(5), window)
        assert_same(mine, ref)
        for a, b in zip(pools_of(pair[0], "bitset"), pools_of(pair[1], "bitset")):
            assert np.array_equal(a, b)
        bs = pair[0].get_bit_set("deg-bs")
        assert bs.get(100) and not bs.get(77) and bs.get(bs.length() - 1)

    def test_hll(self, pair):
        def setup(c):
            h = c.get_hyper_log_log("deg-hll")
            h.add_all(_keys(0, 500))
            return h

        def window(h):
            return [h.add_all(_keys(400, 1400)), h.count(), h.add(5), h.count()]

        (mine, _), (ref, _) = run_both(
            pair, "hll", setup, lambda h: h.add(10**6), window)
        assert_same(mine, ref)
        assert mine[2] is False
        for a, b in zip(pools_of(pair[0], "hll"), pools_of(pair[1], "hll")):
            assert np.array_equal(a, b)
        assert pair[0].get_hyper_log_log("deg-hll").count() == mine[3]

    def test_cms_streaming_estimates_are_whole_call_while_degraded(self, pair):
        rng = np.random.default_rng(3)
        ev1, ev2, ev3 = (rng.zipf(1.3, 700).astype(np.uint64) % 200 for _ in range(3))
        d, w = 4, 256

        def setup(c):
            cms = c.get_count_min_sketch("deg-cms")
            cms.try_init(d, w)
            return cms, cms.add_all_seq(ev1)

        def window(h):
            cms, _ = h
            return [cms.add_all_seq(ev2), cms.estimate_all(_keys(0, 50)),
                    cms.add_all(ev3[:64]), cms.total_count()]

        (mine, _), (ref, _) = run_both(
            pair, "cms", setup, lambda h: h[0].add(10**6), window)
        assert_same(mine, ref)
        # The degraded add_all_seq has whole-call estimates (the JAX
        # degraded contract): every op sees the whole call applied.
        h1w, h2w = hashing.km_reduce_mod(
            *hashing.hash128_np(*hashing.encode_uint64_batch(ev1)), w)
        g = golden.GoldenCountMinSketch(d, w)
        g.add_hashed(h1w, h2w)
        h1w, h2w = hashing.km_reduce_mod(
            *hashing.hash128_np(*hashing.encode_uint64_batch(ev2)), w)
        g.add_hashed(h1w, h2w)
        assert np.array_equal(mine[0], g.estimate_hashed(h1w, h2w))
        for a, b in zip(pools_of(pair[0], "cms"), pools_of(pair[1], "cms")):
            assert np.array_equal(a, b)
        # K1 streams on the reconciled table in both packages.
        after = [c.get_count_min_sketch("deg-cms").add_all_seq(ev3) for c in pair]
        assert np.array_equal(after[0], after[1])

    def test_bloom_fast_add_path_degrades_too(self, pair):
        """exact_add_semantics=False routes adds through the single-tenant
        device path; once the kind degrades it serves from the mirror."""
        c = make_client(exact_add_semantics=False)
        eng = c._engine
        try:
            bf = c.get_bloom_filter("fast-bf")
            bf.try_init(10_000, 0.01)
            bf.add(1)
            for p in POINTS["bloom"]:
                chaos.inject(p, "error", 1.0)
            degrade(eng, lambda: bf.contains(2))
            assert bf.add(99) is True and "fast-bf" in eng._mirrors
            assert bf.contains(99) and bf.contains(1)
            heal(eng, chaos)
            assert bf.contains(99) and bf.contains(1)
        finally:
            c.shutdown()


def setup_params(client, name):
    p = client._engine.params(name)
    return p["size"], p["hash_iterations"]


class TestDegradedServe:
    def test_degrade_serve_reconcile_bloom_against_golden(self):
        c = make_client()
        eng = c._engine
        try:
            bf = c.get_bloom_filter("gold-bf")
            bf.try_init(50_000, 0.01)
            pre = _keys(0, 50)
            bf.add_all(pre)
            for p in POINTS["bloom"]:
                chaos.inject(p, "error", 1.0)
            degrade(eng, lambda: bf.add(10**6))
            assert eng.health.state() == "degraded"
            assert bf.add(777) is True and bf.add(777) is False
            assert bf.contains_all(pre) == len(pre) and not bf.contains(10**6)
            mirror_bits = eng._mirrors["gold-bf"].model.bits.copy()
            heal(eng, chaos)
            entry = eng.registry.lookup("gold-bf")
            from redisson_tpu_torch.objects.degraded import _bits_from_words

            row = eng.executor.read_row(entry.pool, entry.row)
            assert np.array_equal(_bits_from_words(row, entry.params["size"]), mirror_bits)
            # And the golden model of every acked add agrees.
            m, k = setup_params(c, "gold-bf")
            g = golden.GoldenBloomFilter(m, k)
            h1m, h2m = hashing.km_reduce_mod(*hashing.hash128_np(
                *hashing.encode_uint64_batch(np.append(pre, np.uint64(777)))), m)
            g.add_hashed(h1m, h2m)
            assert np.array_equal(g.bits, mirror_bits)
            assert bf.contains(777) and eng.health.summary()["recoveries"] >= 1
            assert eng.obs.degraded_ops.get(("bloom",)) >= 2 + len(pre) + 1
        finally:
            c.shutdown()

    def test_snapshot_while_degraded_keeps_mirror_writes(self, tmp_path):
        """A snapshot taken mid-degradation persists mirror-acked writes,
        and restores into the JAX package and into the port."""
        c = make_client()
        eng = c._engine
        try:
            bf = c.get_bloom_filter("snap-bf")
            bf.try_init(50_000, 0.01)
            bf.add(1)
            for p in POINTS["bloom"]:
                chaos.inject(p, "error", 1.0)
            degrade(eng, lambda: bf.add(2))
            assert bf.add(3) is True  # mirror-only
            assert "snap-bf" in eng._mirrors
            eng.snapshot(str(tmp_path))
            dump = bf.dump()
        finally:
            chaos.clear()
            c.shutdown()
        for restored in (make_jax_client(), make_client()):
            try:
                assert restored._engine.restore_snapshot(str(tmp_path))
                bf2 = restored.get_bloom_filter("snap-bf")
                assert bf2.contains(1) and bf2.contains(3) and not bf2.contains(2)
                restored.get_bloom_filter("dumped").restore(dump)
                assert restored.get_bloom_filter("dumped").contains(3)
            finally:
                restored.shutdown()

    def test_no_lost_futures_while_breaker_opens(self):
        """Every op across the failure window resolves, with a value or a
        typed error; none hangs."""
        c = make_client()
        eng = c._engine
        try:
            bf = c.get_bloom_filter("nl-bf")
            bf.try_init(10_000, 0.01)
            bf.add(0)
            for p in POINTS["bloom"]:
                chaos.inject(p, "error", 1.0)
            futs = [bf.add_all_async(_keys(10 * i, 10 * i + 10)) for i in range(12)]
            outcomes = []
            for f in futs:
                try:
                    outcomes.append(("ok", int(np.sum(f.result(DEADLINE_S)))))
                except RedissonTpuError as e:
                    outcomes.append(("err", type(e).__name__))
            assert len(outcomes) == 12
            assert all(kind == "err" for kind, _ in outcomes)
            assert eng.health.any_degraded
            assert bf.add(10**6) is True  # served by the mirror
        finally:
            chaos.clear()
            c.shutdown()


# -- a failure after an in-place write is not retried ------------------------


def _fail_once(monkeypatch, module, name, after_write: bool):
    """Wrap ``module.name`` so its first call raises — after running the
    real op (the pool written) or before it; returns the call log."""
    real = getattr(module, name)
    calls = []

    def wrapped(*a, **k):
        calls.append(1)
        if len(calls) == 1 and not after_write:
            raise RuntimeError("fault before the pool write")
        out = real(*a, **k)
        if len(calls) == 1:
            raise RuntimeError("fault after the pool write")
        return out

    monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("path", ["cms_coalesced", "bitset_flip", "cms_seq_direct"])
def test_failure_after_pool_write_is_not_retried(monkeypatch, path):
    """The pool shows the launch's ops applied exactly once and the
    caller gets a typed error; a retry would have applied them twice."""
    from redisson_tpu_torch.ops import bitops, cms as cms_ops, cms_seq

    c = make_client()  # retry_attempts=2: a retryable failure is retried
    try:
        if path == "bitset_flip":
            bs = c.get_bit_set("pw-bs")
            bs.set_many(np.array([1, 2], np.uint32))
            calls = _fail_once(monkeypatch, bitops, "pack_bool_u32", after_write=True)
            fut = c._engine.bitset_flip("pw-bs", np.array([2, 9, 9, 9], np.uint32))
            with pytest.raises(RetryExhaustedError) as ei:
                fut.result(DEADLINE_S)
            assert isinstance(ei.value.__cause__, NonRetryableDispatchError)
            assert len(calls) == 1  # launched once, never retried
            monkeypatch.undo()
            # Flips applied exactly once: 2 cleared, 9 flipped three times.
            assert bs.get_many(np.array([1, 2, 9], np.uint32)).tolist() == [True, False, True]
            return
        cms = c.get_count_min_sketch("pw-cms")
        cms.try_init(4, 256)
        keys = np.array([5, 5, 7], np.uint64)
        weights = np.array([3, 4, 10], np.uint32)
        if path == "cms_coalesced":
            calls = _fail_once(monkeypatch, cms_ops, "cms_update_and_estimate", True)
            with pytest.raises(RetryExhaustedError) as ei:
                cms.add_all(keys, weights)
            assert isinstance(ei.value.__cause__, NonRetryableDispatchError)
        else:
            calls = _fail_once(monkeypatch, cms_seq, "cms_seq_plain", True)
            with pytest.raises(NonRetryableDispatchError):
                cms.add_all_seq(keys, weights)
        assert len(calls) == 1
        monkeypatch.undo()
        assert cms.total_count() == 17  # weights applied exactly once
    finally:
        c.shutdown()


def test_failure_before_pool_write_is_retried_once_applied(monkeypatch):
    from redisson_tpu_torch.ops import cms as cms_ops

    c = make_client()
    try:
        cms = c.get_count_min_sketch("pre-cms")
        cms.try_init(4, 256)
        calls = _fail_once(monkeypatch, cms_ops, "cms_update_and_estimate", False)
        est = cms.add_all(np.array([5, 7], np.uint64), np.array([3, 4], np.uint32))
        assert len(calls) == 2  # failed untouched, retried, applied
        assert est.tolist() == [3, 4] and cms.total_count() == 7
    finally:
        c.shutdown()
