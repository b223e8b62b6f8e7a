"""The pre-hashed Bloom path on the port against the JAX package.

Callers that hash on the host hand the engine the two 64-bit murmur
halves of each key (``hashing.hash128_np``): the engine's
``bloom_add(name, H1, H2)`` / ``bloom_contains(name, H1, H2)`` reduce
them mod the filter's m and dispatch the reduced pair.  Held here, with
a tolerance of zero, on the same numpy-seeded inputs:

* ``ops/fastpath.py``: ``mod64_bits`` (edge values and random m, and the
  int64 bound its one split relies on), ``bloom_add_fast_st`` (flags
  against the state before the batch, duplicates and padding included)
  and ``bloom_contains_st``, on pool bytes and flags;
* the five executor methods through the engine: ``bloom_add`` /
  ``bloom_contains`` on one, four and eight shards, with
  ``exact_add_semantics`` both ways, coalesced and direct; the near
  cache, the degraded mirror, read replication and the journal record;
* ``tests/test_fastpath.py`` rebound on the port: each of its kernel
  tests has a port twin here; its two client-level tests run rebound in
  ``tests/test_torch_host_engine.py``, since they compare with the host
  engine.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
from redisson_tpu.ops import fastpath as jfast  # noqa: E402
from redisson_tpu.utils import hashing as jhashing  # noqa: E402
from redisson_tpu_torch import chaos  # noqa: E402
from redisson_tpu_torch.ops import bloom as tbloom  # noqa: E402
from redisson_tpu_torch.ops import fastpath as tfast  # noqa: E402
from redisson_tpu_torch.ops import golden  # noqa: E402
from redisson_tpu_torch.utils import hashing  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy -> the port's int32 bit-view tensor."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _hashes(n, seed, m):
    """(H1, H2) uint64 of n random LongCodec-width keys, and their
    reduction mod m — the reference test's ``_hashes``."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    blocks, lengths = hashing.encode_uint64_batch(keys)
    H1, H2 = hashing.hash128_np(blocks, lengths)
    return (H1, H2), hashing.km_reduce_mod(H1, H2, m)


# -- mod64_bits -----------------------------------------------------------------

_EDGE_M = [1, 2, 3, 17, 9585059, (1 << 31) - 1, 1 << 31]


@pytest.mark.parametrize("m", _EDGE_M + [int(x) for x in np.random.default_rng(7).integers(
    1, (1 << 31) + 1, 4)])
def test_mod64_bits_matches_the_reference(m):
    rng = np.random.default_rng(m % 1000)
    hi = rng.integers(0, 1 << 32, 256, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, 256, dtype=np.uint64).astype(np.uint32)
    hi[:3] = [0, 0xFFFFFFFF, 0xFFFFFFFF]
    lo[:3] = [0, 0xFFFFFFFF, 0]
    want = ((hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)) % np.uint64(m)
    ref = np.asarray(jax.jit(lambda h, l: jfast.mod64_bits(h, l, np.uint32(m)))(
        jnp.asarray(hi), jnp.asarray(lo)))
    got = tfast.mod64_bits(_t(hi), _t(lo), m).numpy()
    # Per-op m as a tensor too (the mixed path's m column).
    got_t = tfast.mod64_bits(_t(hi), _t(lo), _t(np.full(256, m, np.uint32))).numpy()
    np.testing.assert_array_equal(ref, want.astype(np.uint32))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(got_t, want.astype(np.int64))


def test_mod64_one_split_stays_inside_int64():
    """The claim the closed form rests on: for every m <= 2**31 and
    hi, lo < 2**32, ``(hi % m) << 32 | lo`` is at most 2**63 - 1 — its
    largest value is at m = 2**31, hi % m = 2**31 - 1, lo = 2**32 - 1."""
    worst = max(((min(m - 1, (1 << 32) - 1)) << 32) | ((1 << 32) - 1) for m in _EDGE_M)
    assert worst == (1 << 63) - 1
    hi = np.array([(1 << 31) - 1, (1 << 32) - 1], np.uint32)
    lo = np.array([(1 << 32) - 1] * 2, np.uint32)
    got = tfast.mod64_bits(_t(hi), _t(lo), 1 << 31).numpy()
    want = ((hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)) % np.uint64(1 << 31)
    np.testing.assert_array_equal(got, want.astype(np.int64))


# -- bloom_add_fast_st / bloom_contains_st ---------------------------------------------


def _fast_add_both(h1m, h2m, m, k, W, rows, row, valid):
    """The same batch through both packages' fast add: (JAX pool, JAX
    flags), (port pool, port flags)."""
    jpool = jnp.zeros((rows * W + 1,), jnp.uint32)
    jpool, jn = jfast.bloom_add_fast_st(
        jpool, np.int32(row), jnp.asarray(h1m), jnp.asarray(h2m), np.uint32(m),
        None if valid is None else jnp.asarray(valid), k=k, words_per_row=W)
    tpool = torch.zeros(rows * W + 1, dtype=torch.int32)
    tn = tfast.bloom_add_fast_st(
        tpool, row, _t(h1m), _t(h2m), m,
        None if valid is None else torch.from_numpy(valid), k=k, words_per_row=W)
    return (np.asarray(jpool), np.asarray(jn)), (tpool.numpy().view(np.uint32), tn.numpy())


@pytest.mark.parametrize("case", ["unique", "duplicates", "padding", "dup-and-padding"])
def test_fast_add_pool_bytes_and_flags_match_the_reference(case):
    M, K, W = 1 << 16, 7, (1 << 16) // 32
    _, (h1m, h2m) = _hashes(700, 3, M)
    valid = None
    if "dup" in case:  # in-batch duplicates: both read newly (pre-batch flags)
        h1m[100:200], h2m[100:200] = h1m[:100], h2m[:100]
    if "padding" in case:
        valid = np.arange(700) < 640
    (jp, jn), (tp, tn) = _fast_add_both(h1m, h2m, M, K, W, 3, 1, valid)
    np.testing.assert_array_equal(jp, tp)  # scratch word included
    np.testing.assert_array_equal(jn, tn)
    if "dup" in case:
        assert tn[100:200].all() and tn[:100].all()
    jc = jfast.bloom_contains_st(jnp.asarray(jp), np.int32(1), jnp.asarray(h1m),
                                 jnp.asarray(h2m), np.uint32(M), k=K, words_per_row=W)
    tc = tfast.bloom_contains_st(_t(tp), 1, _t(h1m), _t(h2m), M, k=K, words_per_row=W)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())


# -- tests/test_fastpath.py, the kernel half, on the port ------------------------------


def test_fast_add_bit_exact_vs_exact_kernel():
    M, K, W = 1 << 16, 7, (1 << 16) // 32
    pool_a = torch.zeros(2 * W + 1, dtype=torch.int32)
    pool_b = torch.zeros(2 * W + 1, dtype=torch.int32)
    _, (h1m, h2m) = _hashes(700, 3, M)
    rows = torch.ones(700, dtype=torch.int32)
    h1, h2 = hashing.u32(_t(h1m)), hashing.u32(_t(h2m))
    newly_a = tbloom.bloom_add(pool_a, rows, h1, h2, m=M, k=K, words_per_row=W)
    newly_b = tfast.bloom_add_fast_st(pool_b, 1, h1, h2, M, None, k=K, words_per_row=W)
    assert torch.equal(pool_a[:-1], pool_b[:-1])
    assert torch.equal(newly_a, newly_b)  # unique random keys: flags agree too
    assert tfast.bloom_contains_st(pool_b, 1, h1, h2, M, k=K, words_per_row=W).all()


def test_fast_add_snapshot_duplicate_semantics():
    M, K, W = 1 << 16, 5, (1 << 16) // 32
    pool = torch.zeros(W + 1, dtype=torch.int32)
    h1m, h2m = _t(np.array([9, 9], np.uint32)), _t(np.array([3, 3], np.uint32))
    newly = tfast.bloom_add_fast_st(pool, 0, h1m, h2m, M, None, k=K, words_per_row=W)
    assert newly.tolist() == [True, True]  # both duplicates read newly
    newly2 = tfast.bloom_add_fast_st(pool, 0, h1m, h2m, M, None, k=K, words_per_row=W)
    assert newly2.tolist() == [False, False]


def test_fast_add_padding_mask():
    M, K, W = 1 << 16, 5, (1 << 16) // 32
    pool = torch.zeros(W + 1, dtype=torch.int32)
    tfast.bloom_add_fast_st(
        pool, 0, _t(np.array([0, 0], np.uint32)), _t(np.array([1, 0], np.uint32)), M,
        torch.tensor([True, False]), k=K, words_per_row=W)
    g = golden.GoldenBloomFilter(M, K)
    g.add_hashed(np.array([0], np.uint32), np.array([1], np.uint32))
    bits = np.unpackbits(pool[:-1].numpy().view(np.uint8), bitorder="little")
    np.testing.assert_array_equal(bits.astype(bool), g.bits)


def test_mod64_bits_exact():
    rng = np.random.default_rng(5)
    hi = rng.integers(0, 1 << 32, 512).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, 512).astype(np.uint32)
    for m in (3, 17, 9585059, (1 << 31) - 1, 1 << 31):
        got = tfast.mod64_bits(_t(hi), _t(lo), m).numpy()
        h64 = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
        np.testing.assert_array_equal(got, (h64 % np.uint64(m)).astype(np.int64))


def test_keyed_st_paths_take_the_hashed_pair():
    """``bloom_add_keys_st`` / ``bloom_contains_keys_st`` are the device
    hash followed by the two functions above: same pool and flags as
    hashing on the host first."""
    M, K, W = 95851, 7, 4096
    keys = np.random.default_rng(11).integers(0, 1 << 40, 900).astype(np.uint64)
    keys[50:60] = keys[:10]
    blocks, lengths = hashing.encode_uint64_batch(keys)
    h1m, h2m = hashing.km_reduce_mod(*hashing.hash128_np(blocks, lengths), M)
    a = torch.zeros(W + 1, dtype=torch.int32)
    b = torch.zeros(W + 1, dtype=torch.int32)
    na = tfast.bloom_add_keys_st(a, 0, _t(blocks), _t(lengths), M, None, k=K,
                                 words_per_row=W, target_lanes=blocks.shape[1])
    nb = tfast.bloom_add_fast_st(b, 0, _t(h1m), _t(h2m), M, None, k=K, words_per_row=W)
    assert torch.equal(a, b) and torch.equal(na, nb)
    ca = tfast.bloom_contains_keys_st(a, 0, _t(blocks), _t(lengths), M, k=K,
                                      words_per_row=W, target_lanes=blocks.shape[1])
    assert ca.all()


# -- the engine's hashed bloom_add / bloom_contains, both packages ---------------------


def _pool_bytes(client, name):
    eng = client._engine
    eng._drain()
    return eng.executor.state_to_host(eng.registry.lookup(name).pool)


def _pair(**kw):
    kw.setdefault("min_bucket", 1024)
    jc = redisson_tpu.create(redisson_tpu.Config().use_tpu_sketch(**kw))
    tc = rt.create(rt.Config().use_gpu_sketch(device="cpu", **kw))
    return jc, tc


def _traffic(seed):
    """Three add batches (the second repeats keys of the first, the third
    holds in-batch duplicates) and a contains batch half inside."""
    (H1, H2), _ = _hashes(900, seed, 1 << 20)
    a = (H1[:300], H2[:300])
    b = (np.concatenate([H1[250:400], H1[:50]]), np.concatenate([H2[250:400], H2[:50]]))
    c = (np.concatenate([H1[400:600], H1[400:450]]), np.concatenate([H2[400:600], H2[400:450]]))
    q = (H1[::2], H2[::2])
    return [a, b, c], q


@pytest.mark.parametrize("shards", [1, 4, 8])
@pytest.mark.parametrize("mode", ["exact-coalesced", "exact-direct", "fast-direct",
                                  "fast-coalesced"])
def test_engine_hashed_bloom_matches_the_reference(shards, mode):
    kw = dict(exact_add_semantics=mode.startswith("exact"),
              coalesce=mode.endswith("coalesced"))
    if shards > 1:
        kw["num_shards"] = shards
    adds, q = _traffic(shards)
    out = []
    for c in _pair(**kw):
        try:
            eng = c._engine
            for i in range(3):  # tenants on three rows of one pool
                c.get_bloom_filter(f"hb{i}").try_init(20_000, 0.01)
            flags = [eng.bloom_add("hb1", *a).result() for a in adds]
            flags.append(eng.bloom_add("hb2", *adds[0]).result())
            flags.append(eng.bloom_contains("hb1", *q).result())
            flags.append(eng.bloom_contains("hb0", *q).result())
            out.append((flags, _pool_bytes(c, "hb1")))
        finally:
            c.shutdown()
    (jf, jpool), (tf, tpool) = out
    for a, b in zip(jf, tf):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(jpool, tpool)
    if mode == "fast-direct" and shards == 1:
        # Pre-batch flags: the in-batch duplicates of batch 3 read newly.
        assert np.asarray(tf[2])[200:].all()
    elif mode.startswith("exact"):
        assert not np.asarray(tf[2])[200:].any()  # exact sequential


def test_mixed_add_and_contains_share_one_segment():
    """Adds and contains of one pool coalesce into one ``bloom_mix``
    segment with exact arrival-order results (a contains after an add of
    the same key in one flush reads True)."""
    jc, tc = _pair(batch_window_us=50_000)
    (H1, H2), _ = _hashes(64, 5, 1 << 20)
    out = []
    for c in (jc, tc):
        try:
            eng = c._engine
            c.get_bloom_filter("mx").try_init(10_000, 0.01)
            futs = [eng.bloom_contains("mx", H1[:32], H2[:32]),
                    eng.bloom_add("mx", H1[:40], H2[:40]),
                    eng.bloom_contains("mx", H1, H2)]
            out.append([np.asarray(f.result()) for f in futs] + [_pool_bytes(c, "mx")])
        finally:
            c.shutdown()
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    assert not out[1][0].any() and out[1][2][:40].all()


def test_contains_rides_the_near_cache():
    """A small hashed read is cached by its (H1, H2) pair: the second
    identical read scores hits, and an add retires the cached negative."""
    c = rt.create(rt.Config().use_gpu_sketch(device="cpu", min_bucket=64))
    try:
        eng = c._engine
        c.get_bloom_filter("nc").try_init(1000, 0.01)
        (H1, H2), _ = _hashes(8, 9, 1 << 20)
        first = eng.bloom_contains("nc", H1, H2).result()
        hits0 = eng.nearcache.stats()["hits"]
        again = eng.bloom_contains("nc", H1, H2).result()
        assert eng.nearcache.stats()["hits"] > hits0
        np.testing.assert_array_equal(first, again)
        assert not np.asarray(first).any()
        eng.bloom_add("nc", H1[:1], H2[:1]).result()
        assert bool(np.asarray(eng.bloom_contains("nc", H1[:1], H2[:1]).result())[0])
    finally:
        c.shutdown()


def test_degraded_hashed_ops_serve_from_the_mirror():
    """With the mixed path's breaker open the hashed ops fail over to the
    golden mirror (counted as degraded), answering as the card did."""
    c = rt.create(rt.Config().use_gpu_sketch(
        device="cpu", min_bucket=64, batch_window_us=100, nearcache=False,
        breaker_failure_threshold=2, breaker_open_ms=60_000))
    c.config.retry_attempts = 2
    c.config.retry_interval_ms = 5
    try:
        eng = c._engine
        c.get_bloom_filter("dg").try_init(5000, 0.01)
        (H1, H2), _ = _hashes(200, 13, 1 << 20)
        eng.bloom_add("dg", H1[:100], H2[:100]).result()
        want = golden.GoldenBloomFilter(eng.params("dg")["size"], eng.params("dg")["hash_iterations"])
        want.add_hashed(*hashing.km_reduce_mod(H1[:100], H2[:100], want.size))
        chaos.install(chaos.ChaosSchedule(seed=0, rate=1.0, points=("dispatch.bloom_mixed",)))
        try:
            for _ in range(6):
                try:
                    eng.bloom_contains("dg", H1[:3], H2[:3]).result()
                except Exception:
                    pass
                if eng.health.any_degraded:
                    break
            assert eng.health.any_degraded
            before = sum(int(v.value) for _, v in eng.obs.degraded_ops.items())
            newly = eng.bloom_add("dg", H1[100:], H2[100:]).result()
            hits = eng.bloom_contains("dg", H1, H2).result()
        finally:
            chaos.clear()
        assert sum(int(v.value) for _, v in eng.obs.degraded_ops.items()) > before
        exp_newly = want.add_hashed(*hashing.km_reduce_mod(H1[100:], H2[100:], want.size))
        np.testing.assert_array_equal(newly, exp_newly)
        assert np.asarray(hits).all()
    finally:
        c.shutdown()


def test_replicated_filter_broadcasts_hashed_adds():
    """On a replicated filter hashed adds reach every copy and hashed
    reads rotate over them, with the same answers as unreplicated."""
    c = rt.create(rt.Config().use_gpu_sketch(device="cpu", min_bucket=64, num_shards=4))
    try:
        eng = c._engine
        c.get_bloom_filter("rep").try_init(5000, 0.01)
        assert c.get_bloom_filter("rep").set_replicated()
        (H1, H2), _ = _hashes(300, 17, 1 << 20)
        newly = eng.bloom_add("rep", H1[:200], H2[:200]).result()
        assert np.asarray(newly).sum() >= 195
        entry = eng.registry.lookup("rep")
        rows = [eng.executor.read_row(entry.pool, r) for r in entry.replica_rows]
        for r in rows[1:]:
            np.testing.assert_array_equal(rows[0], r)
        for _ in range(4):  # every replica answers alike
            hits = np.asarray(eng.bloom_contains("rep", H1, H2).result())
            assert hits[:200].all()
    finally:
        c.shutdown()


def test_hashed_add_journals_the_raw_twins(tmp_path):
    """``bloom.add`` records carry the raw H1/H2 (before the reduction);
    a crash-free reopen replays them into the same row."""
    def cfg():
        c = rt.Config().use_gpu_sketch(device="cpu", min_bucket=64)
        c.journal_dir = str(tmp_path / "journal")
        c.journal_fsync = "always"
        return c

    (H1, H2), _ = _hashes(100, 19, 1 << 20)
    c1 = rt.create(cfg())
    c1.get_bloom_filter("jb").try_init(1000, 0.01)
    c1._engine.bloom_add("jb", H1, H2).result()
    row1 = _pool_bytes(c1, "jb")
    recs = [r for _seq, r in c1._engine.journal.records_after(0)]
    c1.shutdown()
    (add,) = [r for r in recs if r.get("op") == "bloom.add"]
    np.testing.assert_array_equal(np.asarray(add["h1"], np.uint64), H1)
    np.testing.assert_array_equal(np.asarray(add["h2"], np.uint64), H2)
    c2 = rt.create(cfg())
    try:
        np.testing.assert_array_equal(_pool_bytes(c2, "jb"), row1)
        assert np.asarray(c2._engine.bloom_contains("jb", H1, H2).result()).all()
    finally:
        c2.shutdown()


def test_hashed_reduction_is_the_reference_pipeline():
    """``_bloom_reduce`` is ``km_reduce_mod`` of the filter's m, equal to
    the JAX package's host reduction."""
    (H1, H2), _ = _hashes(50, 23, 1 << 20)
    for m in (1, 95851, 9585059, 1 << 31):
        a = hashing.km_reduce_mod(H1, H2, m)
        b = jhashing.km_reduce_mod(H1, H2, m)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
