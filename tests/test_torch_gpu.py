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
