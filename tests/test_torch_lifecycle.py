"""The port's RObject lifecycle against the JAX package on the CPU:
exists/delete/rename/names, ``BloomFilter.count()``, CMS merge (past 2**31
and wrapping past 2**32) and reset, the merge/clear ops, and the Batch
facade.  The same numpy-seeded calls go through one JAX client
(``use_tpu_sketch(min_bucket=64)``) and one port client
(``use_gpu_sketch(device="cpu")``); answers must be equal and pool rows
byte-equal.  The Batch cases of ``tests/test_batch_pipelining.py`` count
the executor's dispatches with a spy in place of the JAX metrics."""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
from redisson_tpu.codecs import LongCodec as JaxLongCodec  # noqa: E402
from redisson_tpu.executor.tpu_executor import (  # noqa: E402
    bloom_count_from_bitcount as jax_bloom_count,
)
from redisson_tpu.ops import bloom as jax_bloom, cms as jax_cms  # noqa: E402
from redisson_tpu_torch.codecs import LongCodec  # noqa: E402
from redisson_tpu_torch.executor.torch_executor import bloom_count_from_bitcount  # noqa: E402
from redisson_tpu_torch.ops import bloom as bloom_ops, cms as cms_ops  # noqa: E402

# A batch window long enough for a whole batch to queue before its first
# flush, as tests/test_batch_pipelining.py's interleaved case sets one.
BATCH_WINDOW_US = 500_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_client(codec=True, **kw):
    cfg = rt.Config().set_codec(LongCodec()) if codec else rt.Config()
    return rt.create(cfg.use_gpu_sketch(device="cpu", min_bucket=64, **kw))


@pytest.fixture(scope="module")
def both():
    jc = redisson_tpu.create(
        redisson_tpu.Config().set_codec(JaxLongCodec()).use_tpu_sketch(min_bucket=64))
    tc = make_client()
    yield jc, tc
    tc.shutdown()
    jc.shutdown()


def _row(c, name):
    eng = c._engine
    eng._drain()
    e = eng.registry.lookup(name)
    u = e.pool.row_units
    return eng.executor.state_to_host(e.pool)[e.row * u : (e.row + 1) * u]


def _pool(c, name):
    eng = c._engine
    eng._drain()
    return eng.executor.state_to_host(eng.registry.lookup(name).pool)


# -- exists / delete / rename / names ------------------------------------------


def test_exists_delete_rename_names_match_jax(both):
    out = []
    for c in both:
        got = []
        hs = [c.get_hyper_log_log(f"ks-h{i}") for i in range(4)]
        for i, h in enumerate(hs):
            h.add_all(list(range(i * 10, i * 10 + 5)))
        bf = c.get_bloom_filter("ks-bf")
        bf.try_init(1000, 0.01)
        got.append([h.is_exists() for h in hs] + [bf.is_exists()])
        got.append(hs[1].delete())
        got.append(hs[1].delete())  # already gone
        got.append(c.get_hyper_log_log("ks-missing").is_exists())
        hs[2].rename("ks-h2b")
        got.append((hs[2].name, hs[2].count(), c.get_hyper_log_log("ks-h2").is_exists()))
        got.append(sorted(n for n in c._engine.names() if n.startswith("ks-")))
        got.append(sorted(n for n in c._engine.names("hll") if n.startswith("ks-")))
        got.append(c._engine.params("ks-bf"))
        # A deleted row is reused by the next object, zeroed.
        h5 = c.get_hyper_log_log("ks-h5")
        h5.add(77)
        got.append(h5.count())
        out.append((got, _pool(c, "ks-h0")))
    (jgot, jpool), (tgot, tpool) = out
    assert jgot == tgot
    assert np.array_equal(jpool, tpool)


def test_rename_onto_live_destination_zeroes_displaced_row(both):
    out = []
    for c in both:
        src = c.get_bit_set("rn-src")
        src.set_many(np.arange(0, 900, 3, dtype=np.uint32))
        dst = c.get_bit_set("rn-dst")
        dst.set_many(np.arange(1, 900, 5, dtype=np.uint32))
        displaced = c._engine.registry.lookup("rn-dst")
        pool, row = displaced.pool, displaced.row
        src.rename("rn-dst")
        assert src.name == "rn-dst"
        assert not c.get_bit_set("rn-src").is_exists()
        u = pool.row_units
        freed = c._engine.executor.state_to_host(pool)[row * u : (row + 1) * u]
        assert not freed.any()
        out.append((src.cardinality(), src.to_byte_array(), _pool(c, "rn-dst")))
    (jc, jb, jp), (tc_, tb, tp) = out
    assert jc == tc_ == 300 and jb == tb
    assert np.array_equal(jp, tp)


def test_failed_rename_leaves_handle_alone(both):
    for c in both:
        live = c.get_hyper_log_log("fr-live")
        live.add(1)
        ghost = c.get_hyper_log_log("fr-ghost")
        with pytest.raises(RuntimeError, match="does not exist"):
            ghost.rename("fr-live")
        assert ghost.name == "fr-ghost"
        assert live.count() == 1 and live.is_exists()
        assert not c._engine.rename("fr-live", "fr-live")


def test_rename_drains_queued_bitset_ops():
    """Queued bitset ops resolve their row at flush time by entry: the
    rename drains them first, so they land in the object they were
    issued on, not in the displaced destination's freed row."""
    c = make_client(batch_window_us=BATCH_WINDOW_US)
    try:
        c.get_bit_set("q-dst").set(3)
        src = c.get_bit_set("q-src")
        src.set(0)
        fut = src.set_many_async(np.array([10, 20, 30], np.uint32))
        src.rename("q-dst")
        assert fut.result().tolist() == [False, False, False]
        assert c.get_bit_set("q-dst").as_bit_array().nonzero()[0].tolist() == [0, 10, 20, 30]
        fresh = c.get_bit_set("q-fresh")
        fresh.set(1)  # takes the displaced, zeroed row
        assert fresh.cardinality() == 1
    finally:
        c.shutdown()


def test_rename_drops_the_displaced_topk_table():
    """The displaced destination's heavy-hitter table dies with it (the
    JAX engine keeps it as a ghost under the new name: ROADMAP queue 3)."""
    c = make_client()
    try:
        a = c.get_count_min_sketch("tk-a")
        a.try_init(4, 1024, track_top_k=3)
        for _ in range(5):
            a.add(9)
        b = c.get_count_min_sketch("tk-b")
        b.try_init(4, 1024)
        b.add(7)
        b.rename("tk-a")
        assert c._engine.topk.candidates("tk-a") == []
        assert b.top_k(3) == []
    finally:
        c.shutdown()


# -- Bloom count ------------------------------------------------------------------


@pytest.mark.parametrize("n_keys", [0, 1, 700, 5000, 60_000])
def test_bloom_count_matches_jax(both, n_keys):
    counts = []
    for c in both:
        bf = c.get_bloom_filter(f"cnt-{n_keys}")
        assert bf.try_init(2000, 0.05)
        if n_keys:
            bf.add_all(np.arange(n_keys, dtype=np.uint64) * 7919)
        counts.append(bf.count())
    assert counts[0] == counts[1]
    if n_keys == 60_000:  # saturated: every bit set, count() is m
        assert counts[1] == both[1].get_bloom_filter("cnt-60000").get_size()


def test_bloom_count_from_bitcount_matches_jax():
    for m, k in ((100, 3), (9586, 7), (1 << 20, 10)):
        for x in list(range(0, 64)) + [m // 3, m // 2, m - 2, m - 1, m, m + 5]:
            assert bloom_count_from_bitcount(x, m, k) == jax_bloom_count(x, m, k)


# -- CMS merge / reset ---------------------------------------------------------------


def _crafted_cms(c, name, rows):
    """A 4 x 4096 CMS holding ``rows`` (restored from a port dump, so both
    packages start from the same bytes)."""
    src = make_client()
    try:
        cms = src.get_count_min_sketch("crafted")
        cms.try_init(4, 4096)
        e = src._engine.registry.lookup("crafted")
        src._engine.executor.write_row(e.pool, e.row, rows)
        blob = cms.dump()
    finally:
        src.shutdown()
    obj = c.get_count_min_sketch(name)
    obj.restore(blob)
    return obj


@pytest.mark.parametrize("regime", ["past_2_31", "wrap_2_32"])
def test_cms_merge_matches_jax_and_wraps(both, regime):
    rng = np.random.default_rng(5 if regime == "past_2_31" else 6)
    lo, hi = ((1 << 30, 1 << 31) if regime == "past_2_31" else (1 << 31, 1 << 32))
    rows = [rng.integers(lo, hi, 4 * 4096, dtype=np.uint64).astype(np.uint32)
            for _ in range(3)]
    want = rows[0].copy()
    with np.errstate(over="ignore"):
        for r in rows[1:]:
            want += r  # numpy uint32: wraps mod 2**32
    out = []
    for c in both:
        dst = _crafted_cms(c, f"m-dst-{regime}", rows[0])
        for i, r in enumerate(rows[1:]):
            _crafted_cms(c, f"m-src{i}-{regime}", r)
        dst.merge(f"m-src0-{regime}", f"m-src1-{regime}")
        out.append(_row(c, dst.name))
    assert np.array_equal(out[0], out[1])
    assert np.array_equal(out[1], want)
    if regime == "wrap_2_32":
        assert (want.astype(np.uint64) < rows[0].astype(np.uint64)).any()


def test_cms_merge_geometry_and_self(both):
    for c in both:
        a = c.get_count_min_sketch("g-a")
        a.try_init(4, 1024)
        a.add_all([1, 2, 2, 3])
        b = c.get_count_min_sketch("g-b")
        b.try_init(3, 1024)
        with pytest.raises(ValueError, match="geometry"):
            a.merge("g-b")
        with pytest.raises(RuntimeError, match="not initialized"):
            a.merge("g-missing")
        a.merge("g-a")  # merging itself doubles every counter
        assert a.estimate(2) == 4
    assert np.array_equal(_row(both[0], "g-a"), _row(both[1], "g-a"))


def test_cms_reset_matches_jax_and_keeps_topk(both):
    out = []
    for c in both:
        cms = c.get_count_min_sketch("rs")
        cms.try_init(4, 2048, track_top_k=4)
        cms.add_all(np.array([5, 5, 5, 6, 7], np.uint64))
        c._engine.cms_reset("rs")
        assert c._engine.topk.track("rs") == 4
        assert cms.total_count() == 0
        cms.add_all(np.array([8, 8], np.uint64))
        out.append((cms.estimate(8), cms.estimate(5), _row(c, "rs")))
    assert out[0][:2] == out[1][:2] == (2, 0)
    assert np.array_equal(out[0][2], out[1][2])


def test_merge_count_and_clear_ops_match_jax_ops():
    rng = np.random.default_rng(8)
    u, T = 1024, 6
    flat = rng.integers(0, 1 << 32, T * u + 1, dtype=np.uint64).astype(np.uint32)
    srcs = np.array([1, 4, 4, 0], np.int32)

    def port(fn, *args, **kw):
        t = torch.from_numpy(flat.view(np.int32).copy())
        res = fn(t, *args, **kw)
        return t.numpy().view(np.uint32), res

    got, _ = port(cms_ops.cms_merge, 2, torch.as_tensor(srcs, dtype=torch.int64),
                  cells_per_row=u)
    want = jax_cms.cms_merge(jnp.asarray(flat), 2, jnp.asarray(srcs), cells_per_row=u)
    assert np.array_equal(got, np.asarray(want))
    src_counts = flat[:-1].reshape(T, u)[[3, 5]]
    got, _ = port(cms_ops.cms_merge_rows, 0,
                  torch.from_numpy(src_counts.view(np.int32).copy()), cells_per_row=u)
    want = jax_cms.cms_merge_rows(jnp.asarray(flat), 0, jnp.asarray(src_counts),
                                  cells_per_row=u)
    assert np.array_equal(got, np.asarray(want))
    got, _ = port(cms_ops.cms_clear_row, 3, cells_per_row=u)
    assert np.array_equal(got, np.asarray(jax_cms.cms_clear_row(jnp.asarray(flat), 3,
                                                                cells_per_row=u)))
    got, _ = port(bloom_ops.bloom_clear_row, 5, words_per_row=u)
    assert np.array_equal(got, np.asarray(jax_bloom.bloom_clear_row(jnp.asarray(flat), 5,
                                                                    words_per_row=u)))
    for row in range(T):
        _, x = port(bloom_ops.bloom_cardinality, row, words_per_row=u)
        want = jax_bloom.bloom_cardinality(jnp.asarray(flat), row, m=0, k=0,
                                           words_per_row=u)
        assert int(x) == int(want)


def test_replication_is_off_on_one_card(both):
    for c in both:
        bf = c.get_bloom_filter("repl")
        bf.try_init(1000, 0.01)
        assert bf.set_replicated() is False
        assert bf.is_replicated() is False


# -- the Batch facade --------------------------------------------------------------

_DISPATCHES = ("bloom_mixed_keys_runs", "bloom_mixed_keys", "hll_add_changed",
               "cms_update_estimate", "cms_estimate", "bitset_mixed_runs", "bitset_mixed")


@contextlib.contextmanager
def dispatch_spy(client):
    """Counts the executor's coalesced dispatches (one per launch)."""
    ex = client._engine.executor
    calls = []

    def wrap(name):
        orig = getattr(ex, name)

        def spy(*a, **kw):
            calls.append(name)
            return orig(*a, **kw)

        return spy

    for name in _DISPATCHES:
        setattr(ex, name, wrap(name))
    try:
        yield calls
    finally:
        for name in _DISPATCHES:
            delattr(ex, name)


class TestBatchPipelinesSketchOps:
    def test_sync_named_calls_coalesce_into_few_dispatches(self):
        client = make_client(batch_window_us=BATCH_WINDOW_US)
        try:
            bf = client.get_bloom_filter("pb")
            bf.try_init(10_000, 0.01)
            bf.add_all(np.arange(64, dtype=np.uint64))
            batch = client.create_batch()
            b_bf = batch.get_bloom_filter("pb")
            for i in range(16):  # natural SYNC calls, queued
                b_bf.add(np.uint64(1000 + i))
                b_bf.contains(np.uint64(1000 + i))
            with dispatch_spy(client) as calls:
                res = batch.execute()
            adds = res.get_responses()[0::2]
            conts = res.get_responses()[1::2]
            assert all(isinstance(a, bool) for a in adds)
            assert all(c is True for c in conts)  # same-batch read-your-write
            assert len(calls) <= 2, calls
        finally:
            client.shutdown()

    def test_mixed_object_batch(self):
        client = make_client(codec=False)
        try:
            batch = client.create_batch()
            h = batch.get_hyper_log_log("ph")
            c = batch.get_count_min_sketch("pc")
            client.get_count_min_sketch("pc").try_init(4, 1 << 10)
            f1 = h.add_all([1, 2, 3])
            f2 = c.add("hot", 5)
            f3 = c.estimate("hot")
            with pytest.raises(RuntimeError, match="not been executed"):
                f1.result()
            res = batch.execute()
            assert res[0] is True
            assert f2.result() == 5
            assert f3.result() == 5
            assert res.get_responses() == [True, 5, 5]
            with pytest.raises(RuntimeError, match="already executed"):
                batch.execute()
        finally:
            client.shutdown()


def _disjoint_cms_keys(rng, n: int, d: int, w: int) -> list:
    """``n`` keys whose d CMS cells (KM expansion of their murmur hashes)
    share no cell with one another."""
    from redisson_tpu_torch.utils import hashing

    cand = rng.integers(0, 1 << 40, 20 * n).astype(np.uint64)
    h1w, h2w = hashing.km_reduce_mod(
        *hashing.hash128_np(*hashing.encode_uint64_batch(cand)), w)
    r = np.arange(d, dtype=np.uint64)
    cells = (h1w[:, None].astype(np.uint64) + r * h2w[:, None]) % np.uint64(w) + r * np.uint64(w)
    used, out = set(), []
    for key, c in zip(cand.tolist(), cells.tolist()):
        if used.isdisjoint(c):
            used.update(c)
            out.append(key)
            if len(out) == n:
                return out
    raise AssertionError("not enough keys with disjoint cells")


def _batch_calls(rng):
    """(kind, method, args) queued across the four kinds.  A coalesced CMS
    launch returns batch-final estimates, so the batch's CMS keys (each
    added once, or only estimated) share no cell: batch-final and
    one-call-at-a-time estimates are then equal."""
    cms_keys = _disjoint_cms_keys(rng, 24 + 24 + 50 + 100, 4, 1 << 14)
    calls = []
    for i in range(24):
        key = int(rng.integers(0, 1 << 40))
        calls += [
            ("bloom", "add", (key,)),
            ("bloom", "contains", (key,)),
            ("bloom", "contains", (key + 1,)),
            ("hll", "add", (key,)),
            ("cms", "add", (cms_keys[i], 3)),
            ("cms", "estimate", (cms_keys[24 + i],)),
            ("bitset", "set_many", (rng.integers(0, 4096, 8).astype(np.uint32),)),
            ("bitset", "get_many", (rng.integers(0, 4096, 8).astype(np.uint32),)),
        ]
    keys = rng.integers(0, 1 << 40, 200).astype(np.uint64)
    calls += [
        ("bloom", "addAll", (keys[:100],)),
        ("bloom", "contains_all", (keys,)),
        ("bloom", "contains_each", (keys,)),
        ("hll", "add_all", (keys,)),
        ("cms", "add_all", (np.array(cms_keys[48:98], np.uint64),)),
        ("cms", "estimate_all", (np.array(cms_keys[98:], np.uint64),)),
    ]
    return calls


def _batch_objects(factory, tag):
    bf = factory.get_bloom_filter(f"bt-bf-{tag}")
    return {
        "bloom": bf,
        "hll": factory.get_hyper_log_log(f"bt-h-{tag}"),
        "cms": factory.get_count_min_sketch(f"bt-c-{tag}"),
        "bitset": factory.get_bit_set(f"bt-b-{tag}"),
    }


def _prepare(client, tag):
    objs = _batch_objects(client, tag)
    objs["bloom"].try_init(5000, 0.01)
    objs["cms"].try_init(4, 1 << 14)
    objs["cms"].add_all(np.random.default_rng(10).integers(0, 1 << 40, 3000).astype(np.uint64))


def _same(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    return type(a) is type(b) and a == b


def test_batch_responses_match_direct_calls_and_jax(both):
    """One batch per package over the four kinds; each response equals
    the same call made directly on a twin object, and the port's batch
    equals the JAX package's."""
    calls = _batch_calls(np.random.default_rng(9))
    jc, _ = both
    tc = make_client(batch_window_us=BATCH_WINDOW_US)
    try:
        responses = []
        for c in (jc, tc):
            _prepare(c, "batch")
            _prepare(c, "twin")
            batch = c.create_batch()
            queued = _batch_objects(batch, "batch")
            for kind, meth, args in calls:
                getattr(queued[kind], meth)(*args)
            if c is tc:
                with dispatch_spy(tc) as dispatches:
                    res = batch.execute().get_responses()
            else:
                res = batch.execute().get_responses()
            twins = _batch_objects(c, "twin")
            direct = [getattr(twins[kind], meth)(*args) for kind, meth, args in calls]
            assert len(res) == len(direct) == len(calls)
            for (kind, meth, _), x, y in zip(calls, res, direct):
                assert _same(x, y), (kind, meth, x, y)
            responses.append(res)
        for x, y in zip(*responses):
            assert _same(x, y)
        assert len(dispatches) < len(calls) // 10, dispatches
        for obj in _batch_objects(tc, "batch").values():
            assert np.array_equal(_row(tc, obj.name), _row(jc, obj.name))
    finally:
        tc.shutdown()


def test_batch_discard_runs_nothing():
    client = make_client()
    try:
        batch = client.create_batch()
        batch.get_hyper_log_log("disc").add(1)
        batch.discard()
        assert not client.get_hyper_log_log("disc").is_exists()
        with pytest.raises(RuntimeError, match="already executed"):
            batch.execute()
    finally:
        client.shutdown()


def test_batch_add_of_a_tuple_key_matches_sync():
    """A batched HyperLogLog add of ONE tuple key adds that key, as the
    sync add does (the JAX deferred form hashes the tuple's elements as
    separate keys: ROADMAP queue 3)."""
    client = make_client(codec=False)
    try:
        batch = client.create_batch()
        batch.get_hyper_log_log("tup-b").add((1, 2))
        assert batch.execute()[0] is True
        sync = client.get_hyper_log_log("tup-s")
        assert sync.add((1, 2)) is True
        assert client.get_hyper_log_log("tup-b").count() == sync.count() == 1
    finally:
        client.shutdown()
