"""Kernel K1 on the card against its plain PyTorch version (bit-identical
tables and estimates), and the HyperLogLog and BitSet ops, Bloom count,
CMS merge and a whole-keyspace snapshot round trip on the card against
the same calls on the CPU.  Needs a CUDA device and nvcc; run with
``pytest -m gpu tests/test_torch_gpu.py`` on the machine with the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from redisson_tpu_torch.ops import _build, cms_seq  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels run only there)")
    return torch.device("cuda")


# (d, w, B, stream, pool words before the table)
_CASES = {
    "small": (4, 4096, 1000, "zipf", 0),
    "main_path": (5, 65536, 32768, "zipf", 0),
    "one_op": (5, 65536, 1, "zipf", 0),
    "33_ops": (5, 65536, 33, "zipf", 0),
    "ragged_last_tile": (3, 10_007, 5000, "zipf", 0),
    "one_key": (5, 65536, 32768, "one_key", 0),
    "uniform": (5, 65536, 32768, "uniform", 0),
    "weights_wrap": (5, 65536, 32768, "wrap", 0),
    "pool_view": (5, 65536, 32768, "zipf", 4 * 65536 * 5 + 128),
    "8_mib": (2, 1 << 20, 32768, "zipf", 0),
}


def _inputs(d, w, B, stream, rng):
    if stream == "one_key":
        keys = np.full(B, 12345)
    elif stream == "uniform":
        keys = rng.integers(0, 1 << 30, B)
    else:
        keys = rng.zipf(1.2, B) % 100_000
    h1 = (keys * 2654435761 % w).astype(np.uint32)
    h2 = (keys * 40503 % w).astype(np.uint32)
    wt = (rng.random(B) < 0.9).astype(np.uint32)
    table = rng.integers(0, 1 << 20, d * w).astype(np.uint32)
    if stream == "wrap":
        wt = rng.integers(0, 1 << 32, B, dtype=np.uint64).astype(np.uint32)
        table = rng.integers(0, 1 << 32, d * w, dtype=np.uint64).astype(np.uint32)
    return table, h1, h2, wt


@pytest.mark.parametrize("case", list(_CASES))
def test_k1_matches_plain_version(cuda, case):
    d, w, B, stream, before_words = _CASES[case]
    rng = np.random.default_rng(B + d)
    table, h1, h2, wt = _inputs(d, w, B, stream, rng)
    pool = rng.integers(0, 1 << 32, before_words + d * w + 96, dtype=np.uint64).astype(np.uint32)
    pool[before_words : before_words + d * w] = table
    cols = [torch.from_numpy(a.view(np.int32).copy()) for a in (pool, h1, h2, wt)]
    plain_pool = cols[0].clone()
    view = slice(before_words, before_words + d * w)
    plain_est = cms_seq.cms_seq_plain(plain_pool[view], *cols[1:], d=d, w=w)
    dev = [c.to(cuda) for c in cols]
    before = cms_seq.LAUNCHES
    est = cms_seq.cms_update_estimate_seq(dev[0][view], *dev[1:], d=d, w=w)
    torch.cuda.synchronize()
    assert cms_seq.LAUNCHES == before + 1
    assert torch.equal(dev[0].cpu(), plain_pool)  # words around the view unchanged
    assert torch.equal(est.cpu(), plain_est)


def test_k1_shared_memory_matches_plan(cuda):
    lib = _build.load("cms_seq", cms_seq._bind)
    for d, w in ((5, 65536), (2, 1 << 20), (3, 10_007), (1, 1)):
        plan = cms_seq._plan(d, w)
        assert lib.cms_seq_smem_bytes(plan.tile_w) == plan.smem


# -- HyperLogLog and BitSet: plain PyTorch, the same calls on the card and
# on the CPU must agree bit for bit.


def _both(cuda, *arrays):
    """Each numpy array as a (cpu, cuda) pair of tensors (uint32 as int32
    bit-views)."""
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        t = torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32 else a).copy())
        out.append((t, t.to(cuda, copy=True)))
    return out


def test_uint8_amax_scatter_matches_cpu(cuda):
    from redisson_tpu_torch.ops import bitops

    rng = np.random.default_rng(1)
    n = 4 * 16384 + 1
    (flat_c, flat_g), (idx_c, idx_g), (val_c, val_g) = _both(
        cuda, rng.integers(0, 30, n).astype(np.uint8),
        rng.integers(0, n - 1, 1 << 21), rng.integers(0, 52, 1 << 21).astype(np.uint8))
    bitops.scatter_max_onehot(flat_c, idx_c, val_c)
    bitops.scatter_max_onehot(flat_g, idx_g, val_g)
    assert torch.equal(flat_g.cpu(), flat_c)


@pytest.mark.parametrize("density", [0.5, 1e-3, 1e-6])
def test_segmented_scans_match_cpu(cuda, density):
    from redisson_tpu_torch.ops import bitops

    rng = np.random.default_rng(2)
    n = 1 << 21
    first = rng.random(n) < density
    first[0] = True
    (f_c, f_g), (v_c, v_g), (b_c, b_g), (a_c, a_g) = _both(
        cuda, first, rng.integers(0, 52, n).astype(np.int32),
        (rng.random(n) < 0.6).astype(np.int64), (rng.random(n) < 0.5).astype(np.int64))
    assert torch.equal(bitops.segmented_exclusive_max(f_g, v_g).cpu(),
                       bitops.segmented_exclusive_max(f_c, v_c))
    for g, c in zip(bitops._segmented_affine_scan(f_g, b_g, a_g),
                    bitops._segmented_affine_scan(f_c, b_c, a_c)):
        assert torch.equal(g.cpu(), c)


def test_hll_add_changed_matches_cpu(cuda):
    from redisson_tpu_torch.ops import hll

    rng = np.random.default_rng(3)
    B = 1 << 21
    (flat_c, flat_g), (r_c, r_g), (c0_c, c0_g), (c1_c, c1_g), (c2_c, c2_g) = _both(
        cuda, rng.integers(0, 20, 3 * 16384 + 1).astype(np.uint8),
        rng.integers(0, 3, B).astype(np.int32),
        *(rng.integers(0, 1 << 32, B, dtype=np.uint64).astype(np.uint32) for _ in range(3)))
    valid = torch.arange(B) < B - 1000
    ch_c = hll.hll_add_changed(flat_c, r_c, c0_c, c1_c, c2_c, valid=valid)
    ch_g = hll.hll_add_changed(flat_g, r_g, c0_g, c1_g, c2_g, valid=valid.to(cuda))
    assert torch.equal(ch_g.cpu(), ch_c) and torch.equal(flat_g.cpu(), flat_c)
    hist = hll.hll_histogram(flat_g, 1)
    assert torch.equal(hist.cpu(), hll.hll_histogram(flat_c, 1))
    assert torch.equal(hll.ertl_estimate_device(hist).cpu(),
                       hll.ertl_estimate_device(hist.cpu()))


@pytest.mark.parametrize("n_runs", [700, 3000])
def test_bitset_mixed_dispatch_matches_cpu(cuda, n_runs):
    """The executor's run-length form (up to 1024 runs) and its per-op
    form above that, on pools of the two devices."""
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.executor.torch_executor import TorchCommandExecutor
    from redisson_tpu_torch.tenancy import TenantRegistry

    rng = np.random.default_rng(n_runs)
    sizes = rng.integers(1, 300, n_runs)
    run_rows = rng.integers(0, 8, n_runs).astype(np.int32)
    run_ops = rng.integers(0, 4, n_runs).astype(np.uint32)
    starts = np.zeros(n_runs + 1, np.int32)
    starts[1:] = np.cumsum(sizes)
    idx = rng.integers(0, 1 << 15, int(starts[-1])).astype(np.uint32)
    seed_state = rng.integers(0, 1 << 32, 8 * 1024 + 1, dtype=np.uint64).astype(np.uint32)
    out = []
    for dev in ("cpu", cuda.type):
        ex = TorchCommandExecutor(rt.Config().use_gpu_sketch(device=dev))
        reg = TenantRegistry(ex, dispatch_lock=ex._dispatch_lock)
        for i in range(8):
            e, _ = reg.try_create(f"b{i}", "bitset", (1024,), {"nbits": 0})
        ex.state_from_host(e.pool, seed_state)
        if n_runs <= 1024:
            res = ex.bitset_mixed_runs(e.pool, idx, run_rows, run_ops, starts)
        else:
            res = ex.bitset_mixed(e.pool, np.repeat(run_rows, sizes), idx,
                                  np.repeat(run_ops, sizes))
        out.append((res.result(), ex.state_to_host(e.pool)))
    assert np.array_equal(out[0][0], out[1][0])
    assert np.array_equal(out[0][1], out[1][1])


@pytest.mark.parametrize("fill", ["sparse", "empty", "full"])
def test_giant_row_reductions_match_cpu(cuda, fill):
    """popcount, bit length and bit positions over a 2**25-word row."""
    from redisson_tpu_torch.ops import bitset

    rng = np.random.default_rng(4)
    W = 1 << 25
    row = np.zeros(2 * W + 1, np.uint32)
    if fill == "sparse":
        row[W + rng.integers(0, W, 5000)] = rng.integers(1, 1 << 32, 5000, dtype=np.uint64)
    elif fill == "full":
        row[W:-1] = 0xFFFFFFFF
        row[W + 12345] = 0xFFFF7FFF
    ((flat_c, flat_g),) = _both(cuda, row)
    for name, kw in (("bitset_cardinality", {}), ("bitset_length", {}),
                     ("bitset_bitpos", {"target_bit": 1}),
                     ("bitset_bitpos", {"target_bit": 0})):
        fn = getattr(bitset, name)
        g = fn(flat_g, 1, words_per_row=W, **kw)
        c = fn(flat_c, 1, words_per_row=W, **kw)
        assert int(g) == int(c), (name, kw)


def _executor_pool(dev, kind, class_key, state):
    """A one-pool executor on ``dev`` holding ``state``."""
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.executor.torch_executor import TorchCommandExecutor
    from redisson_tpu_torch.tenancy import TenantRegistry

    ex = TorchCommandExecutor(rt.Config().use_gpu_sketch(device=dev))
    reg = TenantRegistry(ex, dispatch_lock=ex._dispatch_lock)
    e, _ = reg.try_create("t0", kind, class_key, {})
    ex.state_from_host(e.pool, state)
    return ex, e.pool


@pytest.mark.parametrize("fill", [0.0, 0.3, 0.999, 1.0])
def test_bloom_count_matches_cpu(cuda, fill):
    """popcount of a config-1 row (2**19 words) and its inversion."""
    rng = np.random.default_rng(int(fill * 1000))
    W = 1 << 19
    m, k = 9_585_059, 7
    state = np.zeros(8 * W + 1, np.uint32)
    bits = rng.random(m) < fill
    state[3 * W : 4 * W] = np.packbits(np.concatenate(
        [bits, np.zeros(32 * W - m, bool)]), bitorder="little").view(np.uint32)
    got = []
    for dev in ("cpu", cuda.type):
        ex, pool = _executor_pool(dev, "bloom", (W,), state)
        got.append(ex.bloom_count(pool, 3, m, k).result())
    assert got[0] == got[1]
    if fill == 1.0:
        assert got[1] == m


def test_cms_merge_matches_cpu(cuda):
    """CMS.MERGE of two 5 x 65536 rows into a third, counters past 2**31
    so the sum wraps mod 2**32."""
    rng = np.random.default_rng(6)
    u = 5 * 65536
    state = rng.integers(1 << 31, 1 << 32, 8 * u + 1, dtype=np.uint64).astype(np.uint32)
    want = state[2 * u : 3 * u].copy()
    with np.errstate(over="ignore"):
        want += state[5 * u : 6 * u]
        want += state[7 * u : 8 * u]
    got = []
    for dev in ("cpu", cuda.type):
        ex, pool = _executor_pool(dev, "cms", (5, 65536), state)
        ex.cms_merge(pool, 2, [5, 7])
        got.append(ex.state_to_host(pool))
    assert np.array_equal(got[0], got[1])
    assert np.array_equal(got[1][2 * u : 3 * u], want)


def test_snapshot_round_trip_of_a_giant_row_matches_cpu(cuda, tmp_path):
    """The same calls on a CPU and a card client, a 2**30-bit bitset (one
    2**25-word row) among them; both snapshots hold byte-equal pools and
    equal metadata, and each restores into a card client byte for byte."""
    import json

    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec

    rng = np.random.default_rng(7)
    idx = rng.integers(0, 1 << 30, 1 << 16).astype(np.uint32)
    keys = rng.integers(0, 1 << 40, 1 << 14).astype(np.uint64)

    def client(dev, snapshot_dir=None):
        cfg = rt.Config().set_codec(LongCodec()).use_gpu_sketch(device=dev)
        cfg.snapshot_dir = snapshot_dir
        return rt.create(cfg)

    dirs, metas, pools = {}, {}, {}
    for dev in ("cpu", cuda.type):
        c = client(dev)
        try:
            c.get_bit_set("big").set_many(idx)
            c.get_bit_set("big").set((1 << 30) - 1)
            bf = c.get_bloom_filter("bf")
            bf.try_init(100_000, 0.01)
            bf.add_all(keys)
            cms = c.get_count_min_sketch("cms")
            cms.try_init(5, 65536, track_top_k=4)
            cms.add_all_seq(keys % 1000)
            dirs[dev] = str(tmp_path / dev)
            c.snapshot(dirs[dev])
        finally:
            c.shutdown()
        with open(f"{dirs[dev]}/sketch_meta.json") as f:
            metas[dev] = json.load(f)
        metas[dev].pop("pools_crc")
        with np.load(f"{dirs[dev]}/sketch_pools.npz") as z:
            pools[dev] = {k: z[k] for k in z.files}
    assert metas["cpu"] == metas[cuda.type]
    for k, arr in pools["cpu"].items():
        assert np.array_equal(arr, pools[cuda.type][k]), k
    for dev in ("cpu", cuda.type):
        c = client(cuda.type, dirs[dev])
        try:
            eng = c._engine
            for i, p in enumerate(eng.registry.pools()):
                assert np.array_equal(eng.executor.state_to_host(p), pools["cpu"][f"pool_{i}"])
            assert c.get_bit_set("big").cardinality() == len(np.unique(
                np.append(idx, (1 << 30) - 1)))
        finally:
            c.config.snapshot_dir = None  # no shutdown snapshot
            c.shutdown()


# (kind, class_key, params) of each kind's mirror at its config size.
_MIRROR_KINDS = {
    "bloom": ("bloom", (1 << 19,), {"size": 9_585_059, "hash_iterations": 7}),
    "bitset": ("bitset", (1 << 25,), {"nbits": 1 << 30}),
    "hll": ("hll", (), {}),
    "cms": ("cms", (5, 65536), {"depth": 5, "width": 65536}),
}


def _random_pool(kind, class_key, rng):
    from redisson_tpu_torch.tenancy.registry import spec_for

    u = spec_for(kind, class_key).row_units
    if kind == "hll":
        return rng.integers(0, 52, 2 * u + 1).astype(np.uint8)
    return rng.integers(0, 1 << 32, 2 * u + 1, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("kind", list(_MIRROR_KINDS))
def test_mirror_seed_encode_round_trip_matches_cpu(cuda, kind):
    """A degraded mirror seeded from a card row decodes to the same model
    as one seeded from the CPU row, encodes back to the row's bytes, and a
    reconcile write_row of it leaves the card row equal to those words."""
    from redisson_tpu_torch.objects.degraded import mirror_for_entry
    from redisson_tpu_torch.tenancy import TenantEntry

    pool_kind, class_key, params = _MIRROR_KINDS[kind]
    state = _random_pool(pool_kind, class_key, np.random.default_rng(8))
    encoded = []
    for dev in ("cpu", cuda.type):
        ex, pool = _executor_pool(dev, pool_kind, class_key, state)
        entry = TenantEntry("t0", pool_kind, pool, 1, dict(params))
        row = ex.read_row(pool, 1)
        mirror = mirror_for_entry(entry, row)
        enc = mirror.encode(pool.row_units)
        if kind == "bloom":  # bits past m are not part of the filter
            m = params["size"]
            want = np.unpackbits(row.view(np.uint8), bitorder="little")[:m]
            assert np.array_equal(np.unpackbits(enc.view(np.uint8), bitorder="little")[:m], want)
        else:
            assert np.array_equal(enc, row)
        ex.zero_row(pool, 1)
        ex.write_row(pool, 1, enc)  # reconcile's write-back
        after = ex.state_to_host(pool)
        u = pool.row_units
        assert np.array_equal(after[u : 2 * u], enc)
        assert np.array_equal(after[:u], state[:u])  # the neighbour row untouched
        encoded.append(enc)
    assert np.array_equal(encoded[0], encoded[1])


def test_stalled_launch_times_out_and_lands(cuda):
    """A sleep kernel ahead of one launch on the executor's stream
    outlasts fetch_timeout_ms: DispatchTimeoutError, a fetch timeout and a
    breaker failure are recorded, and the op still lands."""
    import time

    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec
    from redisson_tpu_torch.executor.failures import DispatchTimeoutError
    from redisson_tpu_torch.obs import total

    c = rt.create(rt.Config().set_codec(LongCodec()).use_gpu_sketch(
        device=cuda.type, fetch_timeout_ms=50))
    try:
        eng = c._engine
        bf = c.get_bloom_filter("stall")
        bf.try_init(10_000, 0.01)
        bf.add_all_async(np.arange(512, dtype=np.uint64)).result()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(1 << 20)
        end.record()
        torch.cuda.synchronize()
        torch.cuda._sleep(int((1 << 20) * 500.0 / start.elapsed_time(end)))  # ~0.5 s
        keys = np.arange(1000, 1512, dtype=np.uint64)
        fut = bf.add_all_async(keys)
        with pytest.raises(DispatchTimeoutError):
            fut.result()
        assert total(eng.obs.fetch_timeouts) == 1
        assert max(b.failures for b in eng.health.board._breakers.values()) == 1
        torch.cuda.synchronize()
        deadline = time.monotonic() + 5.0
        while not fut.done():
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert bf.contains_all(keys) == len(keys)
    finally:
        c.shutdown()


# -- the residency ladder, pre-warm and the BitSet past 2**31, on the card ----


def _client(**kw):
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec

    return rt.create(rt.Config().set_codec(LongCodec()).use_gpu_sketch(**kw))


def test_residency_ladder_on_the_card_matches_cpu(cuda, tmp_path):
    """Phase 10a at a small size: Bloom tenants born cold past a device
    budget, a zipf stream, forced demote → spill → load → promote of a
    CMS, an HLL and a BitSet, then K1 on the promoted CMS row — every
    answer and every row equal to the same run on the CPU."""
    rng = np.random.default_rng(10)
    n_bf, budget = 64, 8
    stream = rng.zipf(1.1, 600) % n_bf
    keys = rng.integers(0, 1 << 40, (600, 16)).astype(np.uint64)
    ev = (rng.zipf(1.2, 5000) % 3000).astype(np.uint64)
    out = {}
    for dev in ("cuda", "cpu"):
        c = _client(device=dev, residency_device_rows=budget,
                    residency_dir=str(tmp_path / dev))
        try:
            eng, rm = c._engine, c._engine.residency
            # The other kinds first: they hold device rows to move.
            cms = c.get_count_min_sketch("cms")
            cms.try_init(5, 65536)
            cms.add_all(ev[:1000])
            hll = c.get_hyper_log_log("hll")
            hll.add_all(ev)
            bs = c.get_bit_set("bs")
            bs.set_many(ev.astype(np.int64) * 7, True)
            for i in range(n_bf):
                c.get_bloom_filter(f"t{i}").try_init(10_000, 0.01)
            answers = []
            for j, t in enumerate(stream):
                bf = c.get_bloom_filter(f"t{t}")
                res = bf.add_all_async(keys[j]) if j % 3 == 0 else bf.contains_all_async(keys[j])
                answers.append(np.asarray(res.result()).tolist())
            rm.shutdown()  # transitions by hand from here on
            for n in ("cms", "hll", "bs"):
                if eng.registry.lookup(n).row < 0:  # the thread demoted it
                    rm.load(n)
                    assert rm.promote(n), n
                assert rm.demote(n) and rm.spill(n) and rm.load(n) and rm.promote(n), n
            before = cms_seq.LAUNCHES
            seq = cms.add_all_seq(ev)
            launched = cms_seq.LAUNCHES - before
            rm.maintain()
            rm.maintain()  # the second reclaims what the first quarantined
            assert rm.device_rows_used() <= budget
            assert rm.errors == 0
            rows = {n: np.asarray(eng._host_row(eng.registry.lookup(n)))
                    for n in ("cms", "hll", "bs", "t0")}
            out[dev] = (answers, np.asarray(seq), rows, launched)
        finally:
            c.shutdown()
    assert out["cuda"][0] == out["cpu"][0]
    assert np.array_equal(out["cuda"][1], out["cpu"][1])
    for n in out["cpu"][2]:
        assert np.array_equal(out["cuda"][2][n], out["cpu"][2][n]), n
    assert out["cuda"][3] >= 1  # K1 ran on the promoted row


def test_no_first_launch_after_prewarm_on_the_card(cuda):
    from redisson_tpu_torch.executor import prewarm

    c = _client(prewarm=True, max_batch=4096)
    try:
        bf = c.get_bloom_filter("pw-bf")
        bf.try_init(100_000, 0.01)
        bf.add_all(np.arange(64, dtype=np.uint64))
        hll = c.get_hyper_log_log("pw-hll")
        hll.add(1)
        bs = c.get_bit_set("pw-bs")
        bs.set((1 << 16) - 1)  # its size class before the window (a grow is a new pool)
        cms = c.get_count_min_sketch("pw-cms")
        cms.try_init(4, 4096)
        assert c.prewarm_wait(300)
        before = prewarm.first_launch_count()
        rng = np.random.default_rng(2)
        for b in c._engine.prewarmer.ladder():
            keys = rng.integers(0, 1 << 40, b).astype(np.uint64)
            bf.add_all(keys)
            bf.contains_all(keys)
            hll.add_all(keys)
            bs.set_many(rng.integers(0, 1 << 16, b), True)
            cms.add_all(keys)
        c._engine._drain()
        torch.cuda.synchronize()
        assert prewarm.first_launch_count() == before
    finally:
        c.shutdown()


def test_bitset_past_2_31_on_the_card(cuda):
    """The BitSet contract past 2**31 bits, in int64 end to end, on a
    fresh 2**32-bit BitSet (512 MiB on the card)."""
    c = _client()
    try:
        bs = c.get_bit_set("big")
        bs.set(2**31)
        assert bs.length() == 2147483649
        bs.set(2**32 - 1)
        assert bs.length() == 4294967296
        bs2 = c.get_bit_set("big2")
        bs2.set(3 * 2**30)
        assert bs2.first_set_bit() == 3221225472
        bs3 = c.get_bit_set("big3")
        bs3.set_range(2**31 - 64, 2**31 + 64)
        assert bs3.cardinality() == 128
        assert bs3.first_set_bit() == 2**31 - 64 and bs3.length() == 2**31 + 64
    finally:
        c.shutdown()


# -- the RESP front door on the card (chip_smoke.py phase 11 at a small size) --


@pytest.fixture
def p11_small(cuda, monkeypatch):
    import chip_smoke as cs

    monkeypatch.setenv("RTPU_REQUIRE_NATIVE_RESP", "1")
    monkeypatch.setattr(cs, "P11_DEVICE", "cuda")
    monkeypatch.setattr(cs, "P11", dict(cs.P11, keys=1 << 16, madd=512, read=8192,
                                        mexists=512, capacity=60_000))
    return cs


def test_wire_bloom_on_the_card(p11_small):
    """11a's checks at 65,536 keys: BF.MADD flags within the golden
    bounds, the row equal to the golden bitmap, BF.MEXISTS equal to
    golden, the FPP within 3 sigma, no op served degraded."""
    p11_small.phase_wire_bloom(np.random.default_rng(1), "test")


def test_entry_point_restart_on_the_card(p11_small):
    """11d's checks: ``python -m redisson_tpu_torch --device cuda`` with a
    snapshot directory, SIGTERM exits 0, the reboot answers every read as
    before, and INFO server names the card."""
    p11_small.phase_entry_point("test")


# -- the data grid on the card (chip_smoke.py phase 12 at a small size) --------


@pytest.fixture
def p12_small(cuda, monkeypatch):
    import chip_smoke as cs

    monkeypatch.setattr(cs, "P11_DEVICE", "cuda")
    monkeypatch.setattr(cs, "P12_DEVICE", "cuda")
    monkeypatch.setattr(cs, "P12", dict(cs.P12, events=1 << 20, msg=1 << 14))
    return cs


def test_bridge_fed_cms_on_the_card_equals_golden(p12_small):
    """12a's checks at 2**20 events: a CMS(5, 65536) fed through
    RTopic -> TopicCmsBridge -> cms_add on the card equals the golden
    count-min over every event, loses none, finds the top 10, and no op
    is served degraded; the bridge does not take K1."""
    before = cms_seq.LAUNCHES
    out = p12_small.phase_config5_pipe("test")
    assert out["table_equals_golden"] and out["top10_recall"] == 1.0
    assert cms_seq.LAUNCHES == before


def test_grid_wire_on_the_card_equals_cpu(p12_small):
    """12b's checks: the grid session on a card server equals a CPU
    server's replies byte for byte, pub/sub frames, and a parked BLPOP
    while 1000 pipelined commands are answered."""
    p12_small.phase_grid_wire("test")


# -- the coordination and services half on the card (phase 13, small) ---------


@pytest.fixture
def p13_small(cuda, monkeypatch):
    import chip_smoke as cs

    monkeypatch.setattr(cs, "P13_DEVICE", "cuda")
    monkeypatch.setattr(cs, "P13", dict(
        cs.P13, keys=1 << 16, add_chunk=1 << 14, contains=1 << 16,
        capacity=65_536, cms_events=1 << 16, lock_threads=4, lock_rounds=50,
        sem_threads=4, sem_keys=1 << 12, lcm_entries=5000, pings=20,
        monitor_s=0.3, prof_keys=1 << 14))
    return cs


def test_node_ping_and_info_on_the_card(cuda):
    """The node is the card: info names it, ping runs a tensor op on it."""
    client = _client(device="cuda")
    try:
        nodes = client.get_nodes_group().get_nodes()
        assert len(nodes) == 1 and nodes[0].address == "gpu:0"
        info = nodes[0].info()
        assert info["device_kind"] == torch.cuda.get_device_name(0)
        assert info["bytes_limit"] == torch.cuda.get_device_properties(0).total_memory
        assert client.get_nodes_group().ping_all()
    finally:
        client.shutdown()


def test_profiler_trace_holds_a_cuda_kernel_event(p13_small):
    """13f at a small size: the Bloom pass's kernels, launched by the
    coalescer's thread, are in the trace; the op count is exact."""
    client = p13_small.p13_client()
    try:
        out = p13_small.p13f_profiler_metrics(client, "test")
        assert out["trace_kernel_events"] > 0
    finally:
        client.shutdown()


def test_reactive_bloom_on_the_card_equals_sync_client(p13_small):
    """13a at a small size: reactive awaits against a sync client's run of
    the same keys and the golden model."""
    out = p13_small.p13a_reactive_bloom("test")
    assert out["row_equals_golden_and_sync"]


def test_executor_tasks_launch_k1_on_the_card(p13_small):
    """13b at a small size: K1 launched from executor workers equals
    golden_seq."""
    client = p13_small.p13_client()
    try:
        before = cms_seq.LAUNCHES
        out = p13_small.p13b_executor_k1(client, np.random.default_rng(13), "test")
        assert out["k1_launches"] == cms_seq.LAUNCHES - before > 0
    finally:
        client.shutdown()


def _journaled(device, d):
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec

    cfg = rt.Config().set_codec(LongCodec()).use_gpu_sketch(device=device, min_bucket=64)
    cfg.snapshot_dir = str(d / "snap")
    cfg.journal_dir = str(d / "journal")
    cfg.journal_fsync = "always"
    return rt.create(cfg)


def _abandon(client):
    """Drop a client without its shutdown snapshot: the journal tail is
    what the next boot recovers."""
    eng = client._engine
    j, eng.journal = eng.journal, None
    if j is not None:
        j.close()
    eng.config.snapshot_dir = client.config.snapshot_dir = None
    client.shutdown()


def _journal_rows(client):
    eng = client._engine
    eng._drain()
    return {e.name: np.asarray(eng.executor.read_row(e.pool, e.row)).copy()
            for e in eng.registry.entries()}


def test_journal_recovery_writes_back_into_card_rows(cuda, tmp_path):
    """Journaled writes on the card (keyed Bloom lanes hashed on the card,
    K1 on the CMS), a snapshot mid-way, then a kill: a fresh card client
    restores, replays on the host and writes every touched row back to
    the card — equal to the live card rows and to the same recovery on
    the CPU, with every pool on the card."""
    import shutil

    rng = np.random.default_rng(14)
    c = _journaled("cuda", tmp_path / "live")
    bf = c.get_bloom_filter("bf")
    bf.try_init(100_000, 0.01)
    cms = c.get_count_min_sketch("cms")
    cms.try_init(5, 1 << 12)
    bs = c.get_bit_set("bs")
    bf.add_all(rng.integers(0, 1 << 40, 5000).tolist())
    cms.add_all_seq(list(rng.zipf(1.2, 3000) % 1000))
    c._engine.snapshot(c.config.snapshot_dir)
    bf.add_all(rng.integers(0, 1 << 40, 5000).tolist())
    c.get_hyper_log_log("h").add_all(rng.integers(0, 1 << 40, 4000).tolist())
    bs.set_many(rng.integers(0, 1 << 16, 3000).tolist(), True)
    cms.add_all_seq(list(rng.zipf(1.2, 3000) % 1000))
    want = _journal_rows(c)
    _abandon(c)
    shutil.copytree(tmp_path / "live", tmp_path / "cpu")
    card, cpu = _journaled("cuda", tmp_path / "live"), _journaled("cpu", tmp_path / "cpu")
    try:
        assert card._engine.obs.journal_replayed.get(()) > 0
        assert all(p.state.is_cuda for p in card._engine.registry.pools())
        got, ref = _journal_rows(card), _journal_rows(cpu)
        assert set(got) == set(want) == set(ref)
        for n in want:
            assert np.array_equal(got[n], want[n]), n
            assert np.array_equal(ref[n], want[n]), n
    finally:
        _abandon(card)
        _abandon(cpu)


def test_k1_on_a_recovered_row_equals_golden_seq(cuda, tmp_path):
    """K1 launches on a CMS row that recovery wrote back, and its per-op
    estimates and table equal golden_seq from the recovered table."""
    rng = np.random.default_rng(15)
    d, w = 5, 1 << 12
    c = _journaled("cuda", tmp_path)
    cms = c.get_count_min_sketch("cms")
    cms.try_init(d, w)
    cms.add_all_seq(list(rng.zipf(1.2, 4000) % 1000))
    _abandon(c)
    c = _journaled("cuda", tmp_path)
    try:
        eng = c._engine
        entry = eng.registry.lookup("cms")
        table = np.asarray(eng.executor.read_row(entry.pool, entry.row)).view(np.uint32)[: d * w]
        keys = list(rng.zipf(1.2, 4000) % 1000)
        H1, H2 = c.get_count_min_sketch("cms")._hash128(keys)
        from redisson_tpu_torch.utils import hashing

        h1w, h2w = hashing.km_reduce_mod(H1, H2, w)
        want_table, want_est = cms_seq.golden_seq(
            table.reshape(d, w), h1w, h2w, np.ones(len(keys), np.uint32), d=d, w=w)
        before = cms_seq.LAUNCHES
        est = c.get_count_min_sketch("cms").add_all_seq(keys)
        assert cms_seq.LAUNCHES > before
        assert np.array_equal(np.asarray(est, np.uint32), np.asarray(want_est, np.uint32))
        got = np.asarray(eng.executor.read_row(entry.pool, entry.row)).view(np.uint32)[: d * w]
        assert np.array_equal(got, want_table.reshape(-1))
    finally:
        _abandon(c)


@pytest.fixture
def p15_small(cuda, monkeypatch):
    import chip_smoke as cs

    monkeypatch.setattr(cs, "P15_DEVICE", "cuda")
    monkeypatch.setattr(cs, "P15", dict(
        cs.P15, keys=1 << 16, chunk=1 << 14, capacity=65_536, contains=1 << 16,
        cms_events=1 << 16, rounds=1, madd=256, madd_cmds=160, c6_batches=2))
    monkeypatch.setenv("RTPU_REQUIRE_NATIVE_RESP", "1")
    return cs


def test_spans_cover_the_card(p15_small):
    """15a at a small size: the spans' event-timed device time over the
    kernel and memcpy time the profiler saw lies in the band the card
    run set, each span's is below its enqueue + d2h_fetch (15a checks
    it), and the tenant's attributed device time is the spans';
    K1's dispatch records equal its launches, and each K1 kernel of the
    trace sits inside its rtpu: region."""
    out = p15_small.p15a_spans(np.random.default_rng(15), "test")
    lo, hi = p15_small.P15_DEVICE_OVER_CARD
    assert out["add_pass_card_us"] > 0
    assert lo <= out["span_over_card"] <= hi
    assert out["add_pass_tenant_device_us"] == pytest.approx(
        out["add_pass_span_device_us"], abs=0.5)
    assert out["k1_dispatch_records"] == out["k1_launches"] >= out["k1_kernels"] > 0


def test_k1_dispatch_records_equal_launches(cuda):
    """Every K1 launch is one ``rtpu_dispatches{cms_update_estimate_seq}``
    record carrying its ops."""
    client = _client(device="cuda")
    try:
        cms = client.get_count_min_sketch("k1-rec")
        cms.try_init(5, 1 << 16)
        fam = client.obs.registry.family("rtpu_dispatches_total")
        ops = client.obs.registry.family("rtpu_dispatch_ops_total")
        key = ("cms_update_estimate_seq",)
        before = cms_seq.LAUNCHES
        n = 3 * client._engine._SEQ_CHUNK + 5
        cms.add_all_seq((np.random.default_rng(1).zipf(1.2, n) % 1000).astype(np.uint64))
        assert dict(fam.items())[key].value == cms_seq.LAUNCHES - before == 4
        assert dict(ops.items())[key].value == n
    finally:
        client.shutdown()


def test_telemetry_verbs_on_the_card(p15_small):
    """15c at a small size on a card server."""
    out = p15_small.p15c_wire(np.random.default_rng(15), "test", 0)
    assert out["fused_runs_attached"] == 0 and out["replies_equal_replay"]


# -- scripting and the per-core front door on the card (phase 16) -------------


def test_eval_bf_madd_on_the_card_equals_golden(cuda):
    """An EVAL whose body calls BF.MADD on a card server: the row equals
    the golden bitmap of its keys."""
    import socket

    import chip_smoke as cs
    from redisson_tpu_torch.ops import golden
    from redisson_tpu_torch.serve.resp import RespServer

    client = cs.p11_client()  # the default codec, as a wire client's bytes
    server = RespServer(client, enable_python_scripts=True)
    try:
        keys = cs.c11_keys(0, 4096)
        s = socket.create_connection((server.host, server.port))
        s.sendall(cs.wire([[b"BF.RESERVE", b"ebf", b"0.01", b"100000"],
                           [b"EVAL", cs.P16_MADD, b"1", b"ebf"] + keys]))
        r = cs.read_frames(s, 2)
        s.close()
        assert r[0] == b"+OK\r\n" and cs.int_array(r[1]).shape == (4096,)
        bf = client.get_bloom_filter("ebf")
        m, k = bf.get_size(), bf.get_hash_iterations()
        h1, h2 = cs.wire_hashes(client, keys, m)
        g = golden.GoldenBloomFilter(m, k)
        g.bits[g._indexes(h1, h2).reshape(-1)] = True
        row = cs.tenant_row(client, "ebf")
        assert np.array_equal(row, cs.golden_words(g, row.shape[0]))
    finally:
        server.close()
        client.shutdown()


def test_k2_node_workers_name_the_card(cuda):
    """MulticoreNode(2, device="cuda"): each worker's INFO server, read
    over its own peer socket, names the card."""
    import chip_smoke as cs
    from redisson_tpu_torch.serve.multicore import MulticoreNode

    node = MulticoreNode(2, device="cuda", env_extra=cs.p16_env())
    try:
        for w in range(2):
            s = cs.p16_peer(node, w)
            info = cs.p16_info(s)
            s.close()
            assert info["rtpu_device"] == "cuda"
            assert info["rtpu_device_name"] == torch.cuda.get_device_name(0)
            assert info["frontdoor_worker_index"] == str(w)
    finally:
        assert node.shutdown()


@pytest.fixture
def p16_small(cuda, monkeypatch):
    import chip_smoke as cs

    monkeypatch.setenv("RTPU_REQUIRE_NATIVE_RESP", "1")
    monkeypatch.setattr(cs, "P11_DEVICE", "cuda")
    monkeypatch.setattr(cs, "P16_DEVICE", "cuda")
    monkeypatch.setattr(cs, "P16", dict(cs.P16, keys=1 << 15, madd=512, read=8192,
                                        capacity=60_000, lat_cmds=8))
    return cs


def test_scripting_on_the_card(p16_small):
    """16a at a small size: the session equal to a CPU server's, config 1
    through EVALSHA equal to golden, FCALL_RO equal to golden, and the
    three SCRIPT KILLs with the slot free after each."""
    out = p16_small.p16a_scripting(np.random.default_rng(16), "test")
    assert out["row_equals_golden"] and out["killed_row_equals_golden"]


# -- the slot-sharded cluster on the card (phase 17) ---------------------------


def test_migration_moves_every_sketch_kind_onto_the_target_card(cuda):
    """Two in-process cluster nodes on the card: a slot holding a Bloom
    filter, an HLL, a BitSet, a CMS and a top-K moves A -> B; on B every
    row is on the card, its DUMP equals the source's, and the filter's row
    equals the golden bitmap of its keys."""
    import redisson_tpu_torch as rt
    import chip_smoke as cs
    from redisson_tpu_torch.cluster.slots import NSLOTS, key_slot
    from redisson_tpu_torch.cluster.supervisor import migrate_slot
    from redisson_tpu_torch.ops import golden
    from redisson_tpu_torch.serve.resp import RespServer

    tag = b"{gpumv}"
    slot = key_slot(tag)
    ports = [cs.free_port(), cs.free_port()]
    topo = {"nodes": [
        {"id": "A", "host": "127.0.0.1", "port": ports[0], "slots": [[slot, slot]]},
        {"id": "B", "host": "127.0.0.1", "port": ports[1],
         "slots": [r for r in ([0, slot - 1], [slot + 1, NSLOTS - 1]) if r[0] <= r[1]]},
    ]}
    nodes = []
    try:
        for nid, port in zip("AB", ports):
            cfg = rt.Config().use_gpu_sketch(device="cuda")
            cfg.cluster_enabled = True
            cfg.cluster_topology = topo
            cfg.cluster_node_id = nid
            cl = rt.create(cfg)
            nodes.append((cl, RespServer(cl, port=port)))
        a, b = [("127.0.0.1", p) for p in ports]
        items = cs.c11_keys(0, 4096)
        names = [tag + x for x in (b"bf", b"hll", b"bits", b"cms", b"topk")]
        seed = [[b"BF.RESERVE", names[0], b"0.01", b"100000"], [b"BF.MADD", names[0]] + items,
                [b"PFADD", names[1]] + items, [b"SETBIT", names[2], b"1048575", b"1"],
                [b"SETBIT", names[2], b"77", b"1"], [b"CMS.INITBYDIM", names[3], b"4096", b"5"],
                [b"CMS.INCRBY", names[3], b"x", b"5", b"y", b"2"],
                [b"TOPK.RESERVE", names[4], b"3"], [b"TOPK.ADD", names[4], b"a", b"b", b"a"]]
        rep = cs.p17_req(a, seed)
        assert not [r for r in rep if isinstance(r, Exception)], rep
        dumps = cs.p17_req(a, [[b"DUMP", n] for n in names])
        assert migrate_slot(slot, a, b, notify=[a, b]) == len(names)
        assert cs.p17_req(b, [[b"DUMP", n] for n in names]) == dumps
        assert cs.p17_req(b, [[b"OBJECT", b"ENCODING", n] for n in names]) == [b"device"] * 5
        client = nodes[1][0]
        for n in names:
            e = client._engine.registry.lookup(n.decode())
            assert e.pool.state.device.type == "cuda"
        bf = client.get_bloom_filter(names[0].decode())
        m, k = bf.get_size(), bf.get_hash_iterations()
        h1, h2 = cs.wire_hashes(client, items, m)
        g = golden.GoldenBloomFilter(m, k)
        g.bits[g._indexes(h1, h2).reshape(-1)] = True
        row = cs.tenant_row(client, names[0].decode())
        assert np.array_equal(row, cs.golden_words(g, row.shape[0]))
    finally:
        for cl, srv in nodes:
            srv.close()
            cl.shutdown()


def test_k1_on_a_migrated_cms_equals_golden_seq(cuda, monkeypatch):
    """17c's in-process half at a small size: a CMS moved between two card
    nodes takes add_all_seq through K1 on the target, estimates and table
    equal golden_seq from the migrated table."""
    import chip_smoke as cs

    monkeypatch.setattr(cs, "P17_DEVICE", "cuda")
    monkeypatch.setattr(cs, "P17", dict(cs.P17, k1_events=1 << 16))
    out = cs.p17c_k1_on_moved_cms(np.random.default_rng(17))
    assert out["k1_moved_cms_launches"] == 2 and out["k1_moved_cms_equals_golden_seq"]


def test_k1_on_a_rebalancer_moved_cms_equals_golden_seq(cuda, monkeypatch):
    """Phase 18's path at a small size: two in-process card nodes, hot
    hash tags on node A, a wave driven by CLUSTER REBALANCE NOW moves hot
    slots (their Bloom and CMS rows) onto node B's card; add_all_seq on a
    moved CMS goes through K1 at its new owner, estimates and table equal
    golden_seq from the moved row."""
    import chip_smoke as cs

    monkeypatch.setattr(cs, "P18_DEVICE", "cuda")
    monkeypatch.setattr(cs, "P18", dict(
        cs.P18, nodes=2, hot=4, cold=1, capacity=60_000, madd=256, hot_madd=8,
        cold_madd=1, hot_incr=2, cold_incr=1, incr_draws=64, k1_events=1 << 16))
    rng = np.random.default_rng(18)
    nodes, ids, addrs, cuts = cs.p18_fleet()
    try:
        out, owners, moved_hot, _hot = cs.p18a_wave(nodes, ids, addrs, cuts, rng)
        assert out["hot_slots_moved"] >= 1 and out["ratio_after"] < out["ratio_before"]
        k1 = cs.p18b_k1_on_moved_cms(nodes, ids, owners, moved_hot, rng)
    finally:
        cs.p18_close(nodes)
    assert k1["k1_moved_cms_launches"] == 2 and k1["k1_moved_cms_equals_golden_seq"]


def _sharded_stream(c, rng):
    """Mixed traffic over every kind at 8 shards, cross-shard merges and
    BITOP, a giant m-sharded BitSet and a replicated filter; returns the
    per-op results."""
    out = []
    keys = lambda n, hi=1 << 20: rng.integers(0, hi, n).astype(np.uint64)  # noqa: E731
    for t in range(24):
        bf = c.get_bloom_filter(f"bf{t}")
        bf.try_init(5000, 0.01)
        out.append(list(bf.add_all_async(keys(300, 8000)).result()))
        out.append(list(bf.contains_each(keys(200, 8000))))
        hl = c.get_hyper_log_log(f"hl{t}")
        out.append(hl.add_all(keys(500)))
        bs = c.get_bit_set(f"bs{t}")
        out.append(list(bs.set_many(rng.integers(0, 8192, 300).astype(np.uint32))))
        cm = c.get_count_min_sketch(f"cm{t}")
        cm.try_init(4, 1 << 10)
        out.append(list(cm.add_all(keys(200, 300), rng.integers(1, 5, 200))))
    c.get_hyper_log_log("hl0").merge_with("hl3", "hl9")
    c.get_count_min_sketch("cm1").merge("cm2", "cm7")
    c.get_bit_set("bs2").xor_op("bs5")
    g = c.get_bit_set("giant")
    g.set((1 << 16) - 1)
    out.append(list(g.set_many(rng.integers(0, 1 << 16, 4000).astype(np.uint32))))
    g.set_range(5000, 40_000)
    out.append((g.cardinality(), g.length(), g.first_clear_bit()))
    rep = c.get_bloom_filter("bf4")
    assert rep.set_replicated()
    out.append(list(rep.contains_each(keys(500, 8000))))
    return out


def test_sharded_engine_on_the_card_equals_the_cpu(cuda):
    """The sharded executor on the card against the same calls on the
    CPU port: per-op results and every row equal, through a live
    reshard 8 -> 4 -> 1 too."""
    import redisson_tpu_torch as rt

    clients = [
        rt.create(rt.Config().use_gpu_sketch(device=d, num_shards=8, min_bucket=64,
                                             mbit_threshold_words=256))
        for d in ("cuda", "cpu")
    ]
    try:
        outs = [_sharded_stream(c, np.random.default_rng(20)) for c in clients]
        assert outs[0] == outs[1]

        def rows(c):
            eng = c._engine
            return {e.name: eng.executor.read_row(e.pool, e.row).tobytes()
                    for e in eng.registry.entries()}

        def pools(c):
            eng = c._engine
            return {p.spec.key: eng.executor.state_to_host(p) for p in eng.registry.pools()}

        for s in (8, 4, 1):
            if s != 8:
                assert all(c.change_topology(s) for c in clients)
            assert rows(clients[0]) == rows(clients[1])
            pa, pb = pools(clients[0]), pools(clients[1])
            assert set(pa) == set(pb)
            for key in pa:
                np.testing.assert_array_equal(pa[key], pb[key])
    finally:
        for c in clients:
            c.shutdown()


# -- shards on several placements and cards (phase 21) -------------------------


def _card_slice(monkeypatch, placements: str) -> list:
    """device_indices for the case: four placements on card 0 (the
    enumeration replaced by four entries of it, the CPU's left alone), or
    two distinct cards, the second first so that the single-device
    executor after a reshard holds cuda:1."""
    from redisson_tpu_torch.executor import torch_executor

    if placements == "2_cards":
        if torch.cuda.device_count() < 2:
            pytest.skip("needs two CUDA devices (shards on distinct cards, D = 2)")
        return [1, 0]
    real = torch_executor.local_devices
    monkeypatch.setattr(
        torch_executor, "local_devices",
        lambda d: [torch.device("cuda", 0)] * 4 if torch.device(d).type == "cuda" else real(d))
    return [0, 1, 2, 3]


@pytest.mark.parametrize("placements", ["4_on_one_card", "2_cards"])
def test_placed_engine_on_the_card_equals_the_cpu(cuda, monkeypatch, placements):
    """8 shards on 4 placements of one card, or on 2 cards, against the
    CPU port at 8 shards: per-op results, rows and pools equal through
    8 -> 4 -> 1, then K1 on the carried CMS on the slice's first card
    equal to golden_seq."""
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec
    from redisson_tpu_torch.parallel import mesh as pm
    from redisson_tpu_torch.utils import hashing

    idx = _card_slice(monkeypatch, placements)
    kw = dict(num_shards=8, min_bucket=64, mbit_threshold_words=256)
    # LongCodec: integer keys hash as their 8 bytes, as golden_seq's lanes.
    clients = [rt.create(rt.Config().set_codec(LongCodec()).use_gpu_sketch(
                   device="cuda", device_indices=idx, **kw)),
               rt.create(rt.Config().set_codec(LongCodec()).use_gpu_sketch(device="cpu", **kw))]
    try:
        ctx = clients[0]._engine.executor.ctx
        assert ctx.placed and len(ctx.devices) == len(idx)
        assert ctx.devices[0] == torch.device("cuda", idx[0])
        outs = [_sharded_stream(c, np.random.default_rng(21)) for c in clients]
        assert outs[0] == outs[1]
        assert all(isinstance(p.state, pm.PlacedState)
                   for p in clients[0]._engine.registry.pools())

        def rows(c):
            eng = c._engine
            return {e.name: eng.executor.read_row(e.pool, e.row).tobytes()
                    for e in eng.registry.entries()}

        for s in (8, 4, 1):
            if s != 8:
                assert all(c.change_topology(s) for c in clients)
            assert rows(clients[0]) == rows(clients[1])
            pa = {p.spec.key: clients[0]._engine.executor.state_to_host(p)
                  for p in clients[0]._engine.registry.pools()}
            pb = {p.spec.key: clients[1]._engine.executor.state_to_host(p)
                  for p in clients[1]._engine.registry.pools()}
            assert set(pa) == set(pb)
            for key in pa:
                np.testing.assert_array_equal(pa[key], pb[key])
        e = clients[0]._engine.registry.lookup("cm1")
        assert e.pool.state.device == torch.device("cuda", idx[0])
        d, w = 4, 1 << 10
        table = clients[0]._engine.executor.read_row(e.pool, e.row)[: d * w].copy()
        ev = (np.random.default_rng(5).zipf(1.2, 5000) % 300).astype(np.uint64)
        before = cms_seq.LAUNCHES
        est = clients[0].get_count_min_sketch("cm1").add_all_seq(ev)
        assert cms_seq.LAUNCHES == before + 1
        h1w, h2w = hashing.km_reduce_mod(
            *hashing.hash128_np(*hashing.encode_uint64_batch(ev)), w)
        t_want, e_want = cms_seq.golden_seq(table.reshape(d, w).copy(), h1w, h2w,
                                            np.ones(len(ev), np.uint32), d=d, w=w)
        np.testing.assert_array_equal(est, e_want)
        got = clients[0]._engine.executor.read_row(e.pool, e.row)[: d * w].reshape(d, w)
        np.testing.assert_array_equal(got, t_want)
    finally:
        for c in clients:
            c.shutdown()


# -- the pre-hashed Bloom path on the card (chip_smoke.py phase 22a small) -------


@pytest.mark.parametrize("arm", ["exact", "fast"])
def test_hashed_bloom_on_the_card_equals_cpu_and_golden(cuda, arm):
    """22a's two arms at 2**16 keys: the engine's bloom_add /
    bloom_contains of host-hashed keys on the card and on the CPU give the
    same flags (sequential for the exact arm, against the state before
    each call for the fast one, both equal golden), the same contains and
    byte-equal rows."""
    import chip_smoke as cs
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec

    kw = {} if arm == "exact" else {"exact_add_semantics": False, "coalesce": False}
    n, chunk = 1 << 16, 1 << 14
    H1, H2 = cs.p22_hashed(np.arange(n, dtype=np.uint64))
    q = np.random.default_rng(3).integers(0, 2 * n, n).astype(np.uint64)
    Q1, Q2 = cs.p22_hashed(q)
    out = []
    for device in ("cuda", "cpu"):
        c = rt.create(rt.Config().set_codec(LongCodec()).use_gpu_sketch(device=device, **kw))
        try:
            r = cs.p22_arm(c, "hb", H1, H2, Q1, Q2, chunk)
            out.append((r["flags"], r["hits"], cs.tenant_row(c, "hb").view(np.uint32)))
            m, k = c.get_bloom_filter("hb").get_size(), c.get_bloom_filter("hb").get_hash_iterations()
        finally:
            c.shutdown()
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    idx, seq, pre = cs.p22_golden(H1, H2, m, k, chunk)
    np.testing.assert_array_equal(out[0][0], seq if arm == "exact" else pre)
    np.testing.assert_array_equal(out[0][2], cs.p22_words(idx, out[0][2].shape[0]))
