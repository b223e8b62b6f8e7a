"""RHyperLogLog in the torch port against the JAX package: the same numpy
inputs go through both, and per-op results and register bytes must be
identical (``ertl_estimate_device`` within a stated tolerance) — at the
op level, through both executors and through both clients."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
from redisson_tpu.codecs import LongCodec as JLongCodec  # noqa: E402
from redisson_tpu.ops import hll as jhll  # noqa: E402
from redisson_tpu.utils import hashing as jh  # noqa: E402
from redisson_tpu_torch.codecs import LongCodec  # noqa: E402
from redisson_tpu_torch.interop import load_sketch_rows  # noqa: E402
from redisson_tpu_torch.ops import golden, hll  # noqa: E402

M = golden.HLL_M
# float32 Ertl on two backends: the same operations in the same order,
# so they may differ only by rounding (a few float32 ulps).
ERTL_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The tests run several pytest workers side by side; one intra-op
    # thread per worker avoids oversubscribing the CPU.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def _lanes(rng, B, n_keys):
    keys = rng.integers(0, n_keys, B).astype(np.uint64)
    c0, c1, c2, _ = jh.murmur3_x86_128(*jh.encode_uint64_batch(keys))
    return c0, c1, c2


def _regs(rng, tenants):
    flat = np.zeros(tenants * M + 1, np.uint8)
    flat[:-1] = rng.integers(0, 12, tenants * M) * (rng.random(tenants * M) < 0.3)
    return flat


def test_index_rank_edges():
    """The clz edges: c1 = 0 (rank from c2), c1 = 1, c1 = 2**32 - 1, top
    18 bits of c2 = 0 (rank 51) and = 1 (rank 50)."""
    top = np.uint32(0xFFFFFFFF)
    c0 = np.array([0, 5, M - 1, top, 7, 9, 11, 3], np.uint32)
    c1 = np.array([0, 1, top, 0, 0, 0x80000000, 2, 0], np.uint32)
    c2 = np.array([0, 0, top, 1 << 14, (1 << 14) - 1, 0, top, top], np.uint32)
    rng = np.random.default_rng(0)
    rc0, rc1, rc2 = _lanes(rng, 512, 1 << 30)
    c0, c1, c2 = (np.concatenate([a, b]) for a, b in ((c0, rc0), (c1, rc1), (c2, rc2)))
    g_idx, g_rank = golden.hll_index_rank(c0, c1, c2)
    j_idx, j_rank = jhll.hll_index_rank_device(jnp.asarray(c0), jnp.asarray(c1), jnp.asarray(c2))
    t_idx, t_rank = hll.hll_index_rank_device(_t(c0), _t(c1), _t(c2))
    assert list(g_rank[:8]) == [51, 32, 1, 50, 51, 1, 31, 33]
    assert np.array_equal(t_rank.numpy(), np.asarray(j_rank))
    assert np.array_equal(t_rank.numpy(), g_rank)
    assert np.array_equal(t_idx.numpy(), np.asarray(j_idx)) and np.array_equal(t_idx.numpy(), g_idx)


def _golden_changed(regs, rows, c0, c1, c2):
    """One op at a time: op j changed iff its rank beat its register."""
    regs = regs.copy()
    idx, rank = golden.hll_index_rank(c0, c1, c2)
    out = np.zeros(len(c0), bool)
    for j, g in enumerate(rows.astype(np.int64) * M + idx):
        out[j] = rank[j] > regs[g]
        regs[g] = max(regs[g], rank[j])
    return regs, out


@pytest.mark.parametrize("seed", [0, 1])
def test_hll_add_changed_matches_jax(seed):
    """Heavy duplicates over three tenants, with padded ops at the end."""
    rng = np.random.default_rng(seed)
    flat = _regs(rng, 3)
    B = 3000
    c0, c1, c2 = _lanes(rng, B, 300)
    c0 = c0 & np.uint32(0x3F)  # 64 registers per tenant: long runs per register
    rows = rng.integers(0, 3, B).astype(np.int32)
    valid = np.ones(B, bool)
    valid[-200:] = False
    j_new, j_changed = jax.jit(jhll.hll_add_changed)(
        jnp.asarray(flat), jnp.asarray(rows), jnp.asarray(c0), jnp.asarray(c1),
        jnp.asarray(c2), valid=jnp.asarray(valid),
    )
    state = torch.from_numpy(flat.copy())
    changed = hll.hll_add_changed(state, _t(rows), _t(c0), _t(c1), _t(c2),
                                  valid=torch.from_numpy(valid))
    assert np.array_equal(state.numpy(), np.asarray(j_new))
    assert np.array_equal(changed.numpy(), np.asarray(j_changed))
    g_regs, g_changed = _golden_changed(flat, rows[valid], c0[valid], c1[valid], c2[valid])
    assert np.array_equal(state.numpy(), g_regs)
    assert np.array_equal(changed.numpy()[valid], g_changed) and not changed.numpy()[~valid].any()
    assert 0 < g_changed.sum() < valid.sum()

    # The plain scatter-max and the single-tenant form agree too.
    j_new = jhll.hll_add(jnp.asarray(flat), jnp.asarray(rows), jnp.asarray(c0),
                         jnp.asarray(c1), jnp.asarray(c2), valid=jnp.asarray(valid))
    state = torch.from_numpy(flat.copy())
    hll.hll_add(state, _t(rows), _t(c0), _t(c1), _t(c2), valid=torch.from_numpy(valid))
    assert np.array_equal(state.numpy(), np.asarray(j_new))
    j_new, j_ch = jhll.hll_add_single(jnp.asarray(flat), 2, jnp.asarray(c0),
                                      jnp.asarray(c1), jnp.asarray(c2))
    state = torch.from_numpy(flat.copy())
    ch = hll.hll_add_single(state, 2, _t(c0), _t(c1), _t(c2))
    assert np.array_equal(state.numpy(), np.asarray(j_new)) and bool(ch) == bool(j_ch)


def test_histogram_merge_and_ertl_device():
    rng = np.random.default_rng(3)
    flat = np.zeros(4 * M + 1, np.uint8)
    for t, n in enumerate((0, 500, 20_000, 3_000_000)):  # empty .. every register hit
        g = golden.GoldenHyperLogLog()
        if n:
            g.add_hashed(*_lanes(rng, min(n, 200_000), n))
        flat[t * M : (t + 1) * M] = g.regs
    state = torch.from_numpy(flat.copy())
    for row in range(4):
        assert np.array_equal(hll.hll_histogram(state, row).numpy(),
                              np.asarray(jhll.hll_histogram(jnp.asarray(flat), row)))
    regs2d = flat[:-1].reshape(4, M)
    t_hist = hll.hll_histograms_all(torch.from_numpy(regs2d.copy()))
    j_hist = np.asarray(jhll.hll_histograms_all(jnp.asarray(regs2d)))
    assert np.array_equal(t_hist.numpy(), j_hist)
    # A histogram with a saturated register exercises tau's loop.
    hists = np.concatenate([j_hist, j_hist[2:3] - np.eye(1, 52, 0, dtype=j_hist.dtype)
                            + np.eye(1, 52, 51, dtype=j_hist.dtype)])
    t_est = hll.ertl_estimate_device(torch.from_numpy(hists)).numpy()
    j_est = np.asarray(jax.jit(jhll.ertl_estimate_device)(jnp.asarray(hists)))
    assert t_est.dtype == np.float32
    np.testing.assert_allclose(t_est, j_est, rtol=ERTL_RTOL)
    g_est = np.array([golden.ertl_estimate(h) for h in hists])
    np.testing.assert_allclose(t_est, g_est, rtol=1e-4)

    j_new = jhll.hll_merge(jnp.asarray(flat), 0, jnp.asarray(np.array([1, 2], np.int32)))
    hll.hll_merge(state, 0, torch.tensor([1, 2]))
    assert np.array_equal(state.numpy(), np.asarray(j_new))


def _row(client, name):
    eng = client._engine
    eng._drain()
    e = eng.registry.lookup(name)
    u = e.pool.row_units
    return eng.executor.state_to_host(e.pool)[e.row * u : (e.row + 1) * u]


@pytest.mark.parametrize("coalesce", [True, False], ids=["coalesced", "device_hash"])
def test_client_flow_matches_jax(coalesce):
    """add, add_all, count, count_with, merge_with through both clients;
    without the coalescer both hash on the device."""
    knobs = dict(coalesce=coalesce, min_bucket=4096)
    jc = redisson_tpu.create(
        redisson_tpu.Config().set_codec(JLongCodec()).use_tpu_sketch(**knobs))
    tc = rt.create(rt.Config().set_codec(LongCodec()).use_gpu_sketch(device="cpu", **knobs))
    try:
        rng = np.random.default_rng(4)
        a = rng.integers(0, 3000, 3000).astype(np.uint64)
        b = rng.integers(2000, 6000, 3000).astype(np.uint64)
        out = []
        for c in (jc, tc):
            ha, hb = c.get_hyper_log_log("ha"), c.get_hyper_log_log("hb")
            got = [ha.add(17), ha.add(17), ha.add_all(a), ha.add_all(a[:100]),
                   hb.add_all_async(b).result(), ha.count(), hb.count(),
                   ha.count_with("hb"), ha.count_with("missing"),
                   c.get_hyper_log_log("never").count()]
            ha.merge_with("hb", "missing")
            got += [ha.count(), _row(c, "ha"), _row(c, "hb")]
            out.append(got)
        for x, y in zip(*out):
            assert np.array_equal(np.asarray(x), np.asarray(y))
        j, t = out
        assert t[:2] == [True, False] and t[3] is False
        g = golden.GoldenHyperLogLog()
        for keys in (np.array([17], np.uint64), a, b):
            g.add_hashed(*jh.murmur3_x86_128(*jh.encode_uint64_batch(keys))[:3])
        assert np.array_equal(t[-2], g.regs) and t[-3] == g.count()
    finally:
        tc.shutdown()
        jc.shutdown()


def test_chunked_keys_single_matches_golden():
    """The direct device-hash PFADD in passes of a small chunk: registers
    as the golden model's, and "changed" as the any over passes."""
    tc = rt.create(rt.Config().use_gpu_sketch(device="cpu", coalesce=False))
    try:
        ex = tc._engine.executor
        e = tc._engine.hll_ensure("chunked")
        rng = np.random.default_rng(6)
        keys = rng.integers(0, 4000, 3500).astype(np.uint64)
        blocks, lengths = jh.encode_uint64_batch(keys)
        assert ex.hll_add_keys_single(e.pool, e.row, blocks, lengths, chunk=1000).result()
        g = golden.GoldenHyperLogLog()
        g.add_hashed(*jh.murmur3_x86_128(blocks, lengths)[:3])
        assert np.array_equal(ex.read_row(e.pool, e.row), g.regs)
        # The same keys again, and a chunk size that leaves a ragged pass.
        assert not ex.hll_add_keys_single(e.pool, e.row, blocks, lengths, chunk=999).result()
        assert not ex.hll_add_keys_single(e.pool, e.row, blocks[:0], lengths[:0]).result()
        assert np.array_equal(ex.read_row(e.pool, e.row), g.regs)
    finally:
        tc.shutdown()


def test_load_sketch_rows_carries_jax_hll():
    jc = redisson_tpu.create(redisson_tpu.Config().use_tpu_sketch(min_bucket=4096))
    tc = rt.create(rt.Config().use_gpu_sketch(device="cpu", min_bucket=4096))
    try:
        rng = np.random.default_rng(7)
        jh_obj = jc.get_hyper_log_log("carried")
        jh_obj.add_all(rng.integers(0, 50_000, 4000).astype(np.uint64))
        th_obj = load_sketch_rows(tc, "carried", "hll", {}, _row(jc, "carried"))
        hist = np.bincount(_row(jc, "carried"), minlength=golden.HLL_Q + 2)
        assert th_obj.count() == jh_obj.count() == round(golden.ertl_estimate(hist))
        more = rng.integers(0, 80_000, 2000).astype(np.uint64)
        assert th_obj.add_all(more) == jh_obj.add_all(more)
        assert np.array_equal(_row(tc, "carried"), _row(jc, "carried"))
        with pytest.raises(ValueError):
            load_sketch_rows(tc, "short", "hll", {}, np.zeros(3, np.uint8))
    finally:
        tc.shutdown()
        jc.shutdown()
