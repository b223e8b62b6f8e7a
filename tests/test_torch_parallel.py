"""The port's mesh builders (``redisson_tpu_torch/parallel/mesh.py``)
against the JAX package's ``shard_map`` builders on the 8 virtual CPU
devices of ``tests/conftest.py``.

Every builder gets the same numpy-seeded ``[S, L]`` state (random bits,
so a builder that touched the wrong word shows) and the same op columns,
invalid (padded) ops included; the resulting state bytes — every shard's
scratch element too — and the per-op results must be equal, exactly.
Then the four cases of ``tests/test_parallel.py`` run on the port against
the golden models.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from redisson_tpu.ops import bitset as jbitset  # noqa: E402
from redisson_tpu.ops import bitops as jbitops  # noqa: E402
from redisson_tpu.ops import hll as jhll  # noqa: E402
from redisson_tpu.parallel import mesh as jpm  # noqa: E402
from redisson_tpu_torch.ops import bitops as tbitops  # noqa: E402
from redisson_tpu_torch.ops import bitset as tbitset  # noqa: E402
from redisson_tpu_torch.ops import golden  # noqa: E402
from redisson_tpu_torch.ops import hll as thll  # noqa: E402
from redisson_tpu_torch.parallel import mesh as tpm  # noqa: E402
from redisson_tpu_torch.utils import hashing  # noqa: E402

S = 8
BP = 64  # ops per shard in the partitioned builders
W = 64  # words per tenant row
ROWS_LOCAL = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jctx():
    assert len(jax.devices()) >= S, "conftest must force 8 cpu devices"
    return jpm.MeshContext(n_shards=S)


@pytest.fixture(scope="module")
def tctx():
    return tpm.MeshContext(devices="cpu", n_shards=S)


def _t(a):
    """numpy -> torch with uint32 as int32 bit-views."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def _np(x):
    a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _states(jctx, local_len, dtype, seed, zero=False):
    rng = np.random.default_rng(seed)
    if zero:
        host = np.zeros((S, local_len), dtype)
    elif dtype == np.uint8:
        host = rng.integers(0, 20, (S, local_len)).astype(np.uint8)
    else:
        host = rng.integers(0, 1 << 32, (S, local_len), dtype=np.uint64).astype(np.uint32)
    js = jax.device_put(jnp.asarray(host), jctx.state_sharding)
    return js, _t(host)


def _same_state(js, ts):
    np.testing.assert_array_equal(np.asarray(js), _np(ts))


def _cols(rng, n_valid_frac=0.8):
    valid = rng.random((S, BP)) < n_valid_frac
    lrows = rng.integers(0, ROWS_LOCAL, (S, BP)).astype(np.int32)
    return lrows, valid


# -- tenant-sharded (replicate-and-mask) builders ---------------------------------


def test_sharded_bloom_add_and_contains(jctx, tctx):
    rng = np.random.default_rng(1)
    T, k, m = S * ROWS_LOCAL, 5, W * 32 - 7
    js, ts = _states(jctx, ROWS_LOCAL * W + 1, np.uint32, 2, zero=True)
    n = 416  # packed results need a multiple of 32
    rows = rng.integers(0, T, n).astype(np.int32)
    h1m = rng.integers(0, m, n).astype(np.uint32)
    h2m = rng.integers(0, m, n).astype(np.uint32)
    m_arr = np.full(n, m, np.uint32)
    valid = rng.random(n) < 0.9
    js, jn = jpm.sharded_bloom_add(jctx, k=k, words_per_row=W)(js, rows, h1m, h2m, m_arr, valid)
    ts, tn = tpm.sharded_bloom_add(tctx, k=k, words_per_row=W)(ts, rows, h1m, h2m, m_arr, valid)
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
    _same_state(js, ts)
    q1 = rng.integers(0, m, n).astype(np.uint32)
    for pack in (False, True):
        jq = jpm.sharded_bloom_contains(jctx, k=k, words_per_row=W, pack_results=pack)(
            js, rows, q1, h2m, m_arr, valid)
        tq = tpm.sharded_bloom_contains(tctx, k=k, words_per_row=W, pack_results=pack)(
            ts, rows, q1, h2m, m_arr, valid)
        np.testing.assert_array_equal(_np(jq), _np(tq))


def test_sharded_hll_add_and_histogram(jctx, tctx):
    rng = np.random.default_rng(3)
    M = golden.HLL_M
    js, ts = _states(jctx, ROWS_LOCAL * M + 1, np.uint8, 4)
    n = 3000
    rows = rng.integers(0, S * ROWS_LOCAL, n).astype(np.int32)
    c0, c1, c2 = (rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
                  for _ in range(3))
    valid = rng.random(n) < 0.9
    js = jpm.sharded_hll_add(jctx)(js, rows, c0, c1, c2, valid)
    ts = tpm.sharded_hll_add(tctx)(ts, rows, c0, c1, c2, valid)
    _same_state(js, ts)
    for row in (0, 5, 17, S * ROWS_LOCAL - 1):
        np.testing.assert_array_equal(
            np.asarray(jpm.sharded_hll_histogram(jctx)(js, row)),
            tpm.sharded_hll_histogram(tctx)(ts, row).numpy())


def test_sharded_mbit_set_and_get(jctx, tctx):
    rng = np.random.default_rng(5)
    WL = 32
    js, ts = _states(jctx, WL + 1, np.uint32, 6)
    n = 700
    idx = rng.integers(0, S * WL * 32, n).astype(np.uint32)
    valid = rng.random(n) < 0.85
    js, jp = jpm.sharded_mbit_set(jctx, words_local=WL)(js, idx, valid)
    ts, tp = tpm.sharded_mbit_set(tctx, words_local=WL)(ts, idx, valid)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    _same_state(js, ts)
    q = rng.integers(0, S * WL * 32, n).astype(np.uint32)
    np.testing.assert_array_equal(
        np.asarray(jpm.sharded_mbit_get(jctx, words_local=WL)(js, q)),
        tpm.sharded_mbit_get(tctx, words_local=WL)(ts, q).numpy())


# -- partition-by-owner builders ---------------------------------------------------


def test_psharded_bloom_mixed(jctx, tctx):
    rng = np.random.default_rng(7)
    k, m = 4, W * 32 - 3
    js, ts = _states(jctx, ROWS_LOCAL * W + 1, np.uint32, 8)
    lrows, valid = _cols(rng)
    h1m = rng.integers(0, m, (S, BP)).astype(np.uint32)
    h2m = rng.integers(0, m, (S, BP)).astype(np.uint32)
    m_arr = np.where(valid, m, 1).astype(np.uint32)
    is_add = rng.random((S, BP)) < 0.5
    js, jr = jpm.psharded_bloom_mixed(jctx, k=k, words_per_row=W)(
        js, lrows, h1m, h2m, m_arr, is_add, valid)
    ts, tr = tpm.psharded_bloom_mixed(tctx, k=k, words_per_row=W)(
        ts, _t(lrows), _t(h1m), _t(h2m), _t(m_arr), _t(is_add), _t(valid))
    np.testing.assert_array_equal(_np(jr), _np(tr))
    _same_state(js, ts)


def test_psharded_bloom_mixed_keys(jctx, tctx):
    rng = np.random.default_rng(9)
    k, m, L = 5, W * 32 - 11, 8
    js, ts = _states(jctx, ROWS_LOCAL * W + 1, np.uint32, 10)
    lrows, valid = _cols(rng)
    lengths = rng.integers(1, 4 * L, (S, BP)).astype(np.uint32)
    blocks = rng.integers(0, 1 << 32, (S, BP, 4), dtype=np.uint64).astype(np.uint32)
    m_arr = np.where(valid, m, 1).astype(np.uint32)
    is_add = rng.random((S, BP)) < 0.5
    js, jr = jpm.psharded_bloom_mixed_keys(jctx, k=k, words_per_row=W, target_lanes=L)(
        js, lrows, blocks, lengths, m_arr, is_add, valid)
    ts, tr = tpm.psharded_bloom_mixed_keys(tctx, k=k, words_per_row=W, target_lanes=L)(
        ts, _t(lrows), _t(blocks), _t(lengths), _t(m_arr), _t(is_add), _t(valid))
    np.testing.assert_array_equal(_np(jr), _np(tr))
    _same_state(js, ts)


@pytest.mark.parametrize("mode", ["mixed", "set", "clear", "flip", "get"])
def test_psharded_bitset(jctx, tctx, mode):
    rng = np.random.default_rng(11)
    js, ts = _states(jctx, ROWS_LOCAL * W + 1, np.uint32, 12)
    lrows, valid = _cols(rng)
    idx = rng.integers(0, W * 32, (S, BP)).astype(np.uint32)
    if mode == "mixed":
        ops = np.where(valid, rng.integers(0, 4, (S, BP)), 2).astype(np.uint32)
        js, jr = jpm.psharded_bitset_mixed(jctx, words_per_row=W)(js, lrows, idx, ops, valid)
        ts, tr = tpm.psharded_bitset_mixed(tctx, words_per_row=W)(
            ts, _t(lrows), _t(idx), _t(ops), _t(valid))
    elif mode == "get":
        jr = jpm.psharded_bitset_get(jctx, words_per_row=W)(js, lrows, idx, valid)
        tr = tpm.psharded_bitset_get(tctx, words_per_row=W)(ts, _t(lrows), _t(idx), _t(valid))
    else:
        jk = getattr(jbitset, f"bitset_{mode}")
        tk = getattr(tbitset, f"bitset_{mode}")
        js, jr = jpm.psharded_bitset_rw(jctx, jk, words_per_row=W)(js, lrows, idx, valid)
        ts, tr = tpm.psharded_bitset_rw(tctx, tk, words_per_row=W)(
            ts, _t(lrows), _t(idx), _t(valid))
    np.testing.assert_array_equal(_np(jr), _np(tr))
    _same_state(js, ts)


def test_psharded_hll_add_changed_and_keys(jctx, tctx):
    rng = np.random.default_rng(13)
    M = golden.HLL_M
    js, ts = _states(jctx, ROWS_LOCAL * M + 1, np.uint8, 14)
    lrows, valid = _cols(rng)
    c0, c1, c2 = (rng.integers(0, 1 << 32, (S, BP), dtype=np.uint64).astype(np.uint32)
                  for _ in range(3))
    js, jr = jpm.psharded_hll_add_changed(jctx)(js, lrows, c0, c1, c2, valid)
    ts, tr = tpm.psharded_hll_add_changed(tctx)(
        ts, _t(lrows), _t(c0), _t(c1), _t(c2), _t(valid))
    np.testing.assert_array_equal(_np(jr), _np(tr))
    _same_state(js, ts)
    L = 8
    blocks = rng.integers(0, 1 << 32, (S, BP, 4), dtype=np.uint64).astype(np.uint32)
    lengths = rng.integers(1, 4 * L, (S, BP)).astype(np.uint32)
    js, jr = jpm.psharded_hll_add_keys(jctx, target_lanes=L)(js, lrows, blocks, lengths, valid)
    ts, tr = tpm.psharded_hll_add_keys(tctx, target_lanes=L)(
        ts, _t(lrows), _t(blocks), _t(lengths), _t(valid))
    np.testing.assert_array_equal(_np(jr), _np(tr))
    _same_state(js, ts)


@pytest.mark.parametrize("mode", ["updest", "est", "upd"])
def test_psharded_cms_update_estimate(jctx, tctx, mode):
    rng = np.random.default_rng(15)
    d, w = 4, 256
    u = -(-d * w // 128) * 128
    js, ts = _states(jctx, ROWS_LOCAL * u + 1, np.uint32, 16)
    lrows, valid = _cols(rng)
    h1w = rng.integers(0, w, (S, BP)).astype(np.uint32)
    h2w = rng.integers(0, w, (S, BP)).astype(np.uint32)
    wts = rng.integers(0, 1 << 32, (S, BP), dtype=np.uint64).astype(np.uint32)
    kw = dict(d=d, w=w, cells_per_row=u, estimate_only=mode == "est",
              update_only=mode == "upd")
    jout = jpm.psharded_cms_update_estimate(jctx, **kw)(js, lrows, h1w, h2w, wts, valid)
    tout = tpm.psharded_cms_update_estimate(tctx, **kw)(
        ts, _t(lrows), _t(h1w), _t(h2w), _t(wts), _t(valid))
    if mode == "est":
        np.testing.assert_array_equal(_np(jout), _np(tout))
    elif mode == "upd":
        js, ts = jout, tout
    else:
        js, je = jout
        ts, te = tout
        np.testing.assert_array_equal(_np(je), _np(te))
    _same_state(js, ts)


# -- m-sharded row ops ----------------------------------------------------------


def test_msharded_row_ops(jctx, tctx):
    rng = np.random.default_rng(17)
    WL, T = 16, 3
    js, ts = _states(jctx, T * WL + 1, np.uint32, 18)
    for fn_j, fn_t in (
        (lambda loc, r: jbitops.popcount_row(loc, r, WL),
         lambda loc, r: tbitops.popcount_row(loc, r, WL)),
        (lambda loc, r: jbitops.bit_length_row(loc, r, WL),
         lambda loc, r: tbitops.bit_length_row(loc, r, WL)),
        (lambda loc, r: jbitops.bitpos_row(loc, r, WL, 0),
         lambda loc, r: tbitops.bitpos_row(loc, r, WL, 0)),
        (lambda loc, r: jbitops.row_slice(loc, r, WL),
         lambda loc, r: tbitops.row_slice(loc, r, WL)),
    ):
        np.testing.assert_array_equal(
            _np(jpm.msharded_row_map(jctx, fn_j)(js, 1)),
            _np(tpm.msharded_row_map(tctx, fn_t)(ts, 1)).astype(
                np.asarray(jpm.msharded_row_map(jctx, fn_j)(js, 1)).dtype))
    data = rng.integers(0, 1 << 32, (S, WL), dtype=np.uint64).astype(np.uint32)
    js = jpm.msharded_row_write(jctx, words_local=WL)(js, 2, data)
    ts = tpm.msharded_row_write(tctx, words_local=WL)(ts, 2, data)
    _same_state(js, ts)
    win = WL * 32
    offs = np.arange(S, dtype=np.int64) * win
    for value, (lo, hi) in ((True, (37, 5 * win - 9)), (False, (win + 3, 3 * win + 40))):
        fb = np.clip(lo - offs, 0, win).astype(np.int32)
        tb = np.clip(hi - offs, 0, win).astype(np.int32)
        js = jpm.msharded_set_range(jctx, words_local=WL, value=value)(js, 0, fb, tb)
        ts = tpm.msharded_set_range(tctx, words_local=WL, value=value)(ts, 0, fb, tb)
        _same_state(js, ts)
    for op, n_src, masked in (("and", 2, False), ("or", 3, False), ("xor", 2, False),
                              ("not", 1, True)):
        src = np.array([0, 1, 2][:n_src], np.int32)
        limit = np.clip(4 * win + 17 - offs, 0, win)
        js = jpm.msharded_bitop(jctx, words_local=WL, op=op, n_src=n_src, masked=masked)(
            js, 2, src, limit)
        ts = tpm.msharded_bitop(tctx, words_local=WL, op=op, n_src=n_src, masked=masked)(
            ts, 2, src, limit)
        _same_state(js, ts)


# -- cross-shard collectives ------------------------------------------------------


def test_cross_shard_merges_and_bitop(jctx, tctx):
    rng = np.random.default_rng(19)
    M = golden.HLL_M
    jh, th = _states(jctx, ROWS_LOCAL * M + 1, np.uint8, 20)
    src = np.array([1, 10, 19, 4], np.int32)  # shards 1, 2, 3, 4
    jh = jpm.sharded_hll_merge(jctx)(jh, 8, src)  # dst on shard 0
    th = tpm.sharded_hll_merge(tctx)(th, 8, src)
    _same_state(jh, th)
    js, ts = _states(jctx, ROWS_LOCAL * W + 1, np.uint32, 21)
    for op, srcs, masked, limit in (("and", [3, 12], False, 0),
                                    ("or", [5, 6, 23], False, 0),
                                    ("xor", [2, 9], False, 0),
                                    ("not", [7], True, W * 32 - 45),
                                    ("not", [7], False, 0)):
        s_arr = np.array(srcs, np.int32)
        js = jpm.sharded_bitop(jctx, words_per_row=W, op=op, n_src=len(srcs), masked=masked)(
            js, 11, s_arr, np.int64(limit))
        ts = tpm.sharded_bitop(tctx, words_per_row=W, op=op, n_src=len(srcs), masked=masked)(
            ts, 11, s_arr, limit)
        _same_state(js, ts)
    for value, lo, hi in ((True, 5, W * 32 - 100), (False, 70, 900)):
        js = jpm.sharded_bitset_set_range(jctx, words_per_row=W, value=value)(js, 13, lo, hi)
        ts = tpm.sharded_bitset_set_range(tctx, words_per_row=W, value=value)(ts, 13, lo, hi)
        _same_state(js, ts)
    for fj, ft in ((lambda loc, r: jbitops.popcount_row(loc, r, W),
                    lambda loc, r: tbitops.popcount_row(loc, r, W)),
                   (lambda loc, r: jbitops.bitpos_row(loc, r, W, 1),
                    lambda loc, r: tbitops.bitpos_row(loc, r, W, 1))):
        for row in (0, 13, 22):
            assert int(jpm.sharded_row_reduce(jctx, fj)(js, row)) == int(
                tpm.sharded_row_reduce(tctx, ft)(ts, row))
    assert int(jpm.sharded_row_reduce(jctx, jhll.hll_histogram)(jh, 8).sum()) == int(
        tpm.sharded_row_reduce(tctx, thll.hll_histogram)(th, 8).sum())
    for row in (3, 14):
        np.testing.assert_array_equal(
            np.asarray(jpm.sharded_row_read(jctx, row_units=W)(js, row)),
            _np(tpm.sharded_row_read(tctx, row_units=W)(ts, row)))
    data = rng.integers(0, 1 << 32, W, dtype=np.uint64).astype(np.uint32)
    js = jpm.sharded_row_write(jctx, row_units=W)(js, 21, data)
    ts = tpm.sharded_row_write(tctx, row_units=W)(ts, 21, data)
    _same_state(js, ts)
    # CMS.MERGE wraps mod 2**32: random cells make most sums overflow.
    js = jpm.sharded_cms_merge(jctx, cells_per_row=W)(js, 9, np.array([9, 2, 20], np.int32))
    ts = tpm.sharded_cms_merge(tctx, cells_per_row=W)(ts, 9, np.array([9, 2, 20], np.int32))
    _same_state(js, ts)


# -- tests/test_parallel.py on the port ------------------------------------------


def _hashes(n, seed, m=None):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    blocks, lengths = hashing.encode_uint64_batch(keys)
    if m is None:
        return hashing.murmur3_x86_128(blocks, lengths)
    h1, h2 = hashing.hash128_np(blocks, lengths)
    return hashing.km_reduce_mod(h1, h2, m)


def test_sharded_bloom_vs_golden(tctx):
    M, K, Wd = 1 << 14, 5, (1 << 14) // 32
    T = 16  # 2 tenants per shard
    state = tctx.make_state(T // S * Wd + 1, torch.int32)
    add = tpm.sharded_bloom_add(tctx, k=K, words_per_row=Wd)
    query = tpm.sharded_bloom_contains(tctx, k=K, words_per_row=Wd)
    g = [golden.GoldenBloomFilter(M, K) for _ in range(T)]
    rng = np.random.default_rng(1)
    n = 512
    h1m, h2m = _hashes(n, 2, m=M)
    rows = rng.integers(0, T, size=n).astype(np.int32)
    m_arr = np.full(n, M, np.uint32)
    valid = np.ones(n, bool)
    state, newly = add(state, rows, h1m, h2m, m_arr, valid)
    newly_g = np.zeros(n, bool)
    for t in range(T):
        sel = rows == t
        newly_g[sel] = g[t].add_hashed(h1m[sel], h2m[sel])
    np.testing.assert_array_equal(newly.numpy(), newly_g)
    assert query(state, rows, h1m, h2m, m_arr, valid).numpy().all()
    q1, q2 = _hashes(n, 3, m=M)
    got2 = query(state, rows, q1, q2, m_arr, valid).numpy()
    exp2 = np.zeros(n, bool)
    for t in range(T):
        sel = rows == t
        exp2[sel] = g[t].contains_hashed(q1[sel], q2[sel])
    np.testing.assert_array_equal(got2, exp2)
    host = _np(state)  # [S, local]
    for t in range(T):
        shard, lrow = t % S, t // S
        words = host[shard][lrow * Wd : (lrow + 1) * Wd]
        bits = np.unpackbits(words.view(np.uint8), bitorder="little").astype(bool)
        np.testing.assert_array_equal(bits, g[t].bits)


def test_sharded_hll_add_hist_merge(tctx):
    M, T = golden.HLL_M, 8
    state = tctx.make_state(T // S * M + 1, torch.uint8)
    addf = tpm.sharded_hll_add(tctx)
    histf = tpm.sharded_hll_histogram(tctx)
    mergef = tpm.sharded_hll_merge(tctx)
    g = [golden.GoldenHyperLogLog() for _ in range(T)]
    rng = np.random.default_rng(7)
    n = 4096
    c0, c1, c2, _ = _hashes(n, 11)
    rows = rng.integers(0, T, size=n).astype(np.int32)
    state = addf(state, rows, c0, c1, c2, np.ones(n, bool))
    for t in range(T):
        sel = rows == t
        g[t].add_hashed(c0[sel], c1[sel], c2[sel])
    for t in range(T):
        assert int(round(golden.ertl_estimate(histf(state, t).numpy()))) == g[t].count()
    state = mergef(state, 0, np.array([1, 2, 3], np.int32))
    g[0].merge(g[1], g[2], g[3])
    assert int(round(golden.ertl_estimate(histf(state, 0).numpy()))) == g[0].count()


def test_sharded_mbit_giant_bitmap(tctx):
    total_bits = 1 << 18
    WL = total_bits // 32 // S
    state = tctx.make_state(WL + 1, torch.int32)
    setf = tpm.sharded_mbit_set(tctx, words_local=WL)
    getf = tpm.sharded_mbit_get(tctx, words_local=WL)
    rng = np.random.default_rng(13)
    idx = rng.integers(0, total_bits, size=1024).astype(np.uint32)
    gold = golden.GoldenBitSet(total_bits)
    state, prev = setf(state, idx, np.ones(1024, bool))
    np.testing.assert_array_equal(prev.numpy(), gold.set(idx))
    qidx = rng.integers(0, total_bits, size=2048).astype(np.uint32)
    np.testing.assert_array_equal(getf(state, qidx).numpy(), gold.get(qidx))


def test_sharded_bitop(tctx):
    Wd, T = 64, 8
    state = tctx.make_state(T // S * Wd + 1, torch.int32)
    setf = tpm.sharded_bloom_add(tctx, k=1, words_per_row=Wd)  # one bit per op
    rows = np.array([1, 1, 2, 2, 2], np.int32)
    bits = np.array([3, 40, 40, 50, 60], np.uint32)
    m_arr = np.full(5, Wd * 32, np.uint32)
    state, _ = setf(state, rows, bits, np.zeros(5, np.uint32), m_arr, np.ones(5, bool))
    opf = tpm.sharded_bitop(tctx, words_per_row=Wd, op="or", n_src=2)
    state = opf(state, 0, np.array([1, 2], np.int32), 0)
    got = np.unpackbits(_np(state)[0][:Wd].view(np.uint8), bitorder="little")
    assert sorted(np.nonzero(got)[0].tolist()) == [3, 40, 50, 60]
    opf_and = tpm.sharded_bitop(tctx, words_per_row=Wd, op="and", n_src=2)
    state = opf_and(state, 0, np.array([1, 2], np.int32), 0)
    got = np.unpackbits(_np(state)[0][:Wd].view(np.uint8), bitorder="little")
    assert sorted(np.nonzero(got)[0].tolist()) == [40]
