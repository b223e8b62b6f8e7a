"""Kernel K1's plain PyTorch version (``redisson_tpu_torch.ops.cms_seq``)
against the Pallas kernel in interpret mode and ``golden_seq``, and the
vectorized count-min ops against ``redisson_tpu.ops.cms``.  All
comparisons are exact: counters stay below 2**31, where the Pallas
kernel's signed minimum agrees with the unsigned one."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from redisson_tpu.ops import cms as jcms  # noqa: E402
from redisson_tpu.ops import pallas_cms  # noqa: E402
from redisson_tpu_torch.ops import cms, cms_seq  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The tests run several pytest workers side by side; one intra-op
    # thread per worker avoids oversubscribing the CPU.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


D, W = 4, 1 << 12


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32 else a).copy())


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _seq(table: np.ndarray, h1, h2, wt, d=D, w=W):
    """Run the wrapper on a CPU copy; returns (new table [d, w], est)."""
    flat = _t(table.reshape(-1))
    est = cms_seq.cms_update_estimate_seq(flat, _t(h1), _t(h2), _t(wt), d=d, w=w)
    return _u32(flat).reshape(d, w), _u32(est)


def _pallas(table, h1, h2, wt, d=D, w=W):
    t, e = pallas_cms.cms_update_estimate_seq(
        jnp.asarray(table), jnp.asarray(h1), jnp.asarray(h2), jnp.asarray(wt),
        d=d, w=w, interpret=True,
    )
    return np.asarray(t), np.asarray(e)


def test_duplicate_heavy_stream_matches_pallas_and_golden():
    rng = np.random.default_rng(0)
    B = 512
    h1 = (rng.integers(0, 50, B) * 7919 % W).astype(np.uint32)
    h2 = (rng.integers(0, 50, B) * 104729 % W).astype(np.uint32)
    wt = rng.integers(0, 5, B).astype(np.uint32)
    table = rng.integers(0, 1000, (D, W)).astype(np.uint32)
    g_table, g_est = cms_seq.golden_seq(table, h1, h2, wt, d=D, w=W)
    p_table, p_est = _pallas(table, h1, h2, wt)
    t_table, t_est = _seq(table, h1, h2, wt)
    assert np.array_equal(t_table, g_table) and np.array_equal(t_est, g_est)
    assert np.array_equal(t_table, p_table) and np.array_equal(t_est, p_est)
    # The port's golden copy is the reference's.
    r_table, r_est = pallas_cms.golden_seq(table, h1, h2, wt, d=D, w=W)
    assert np.array_equal(r_table, g_table) and np.array_equal(r_est, g_est)


def test_no_duplicates_equals_vectorized_path():
    rng = np.random.default_rng(1)
    B = 256
    h1 = rng.permutation(W)[:B].astype(np.uint32)  # distinct cells
    h2 = np.full(B, 1, np.uint32)
    wt = rng.integers(1, 5, B).astype(np.uint32)
    table = np.zeros((D, W), np.uint32)
    t_table, t_est = _seq(table, h1, h2, wt)
    flat = _t(np.zeros(D * W + 1, np.uint32))
    rows = torch.zeros(B, dtype=torch.int32)
    v_est = cms.cms_update_and_estimate(
        flat, rows, _t(h1), _t(h2), _t(wt), d=D, w=W, cells_per_row=D * W
    )
    assert np.array_equal(t_est, _u32(v_est))
    assert np.array_equal(t_table.reshape(-1), _u32(flat)[:-1])
    _, j_est = jcms.cms_update_and_estimate(
        jnp.zeros(D * W + 1, jnp.uint32), jnp.zeros(B, jnp.int32),
        jnp.asarray(h1), jnp.asarray(h2), jnp.asarray(wt),
        d=D, w=W, cells_per_row=D * W,
    )
    assert np.array_equal(t_est, np.asarray(j_est))


def test_hot_key_counts_up_one_by_one():
    B = 300
    h1 = np.full(B, 17, np.uint32)
    h2 = np.full(B, 5, np.uint32)
    table, est = _seq(np.zeros((D, W), np.uint32), h1, h2, np.ones(B, np.uint32))
    assert np.array_equal(est, np.arange(1, B + 1, dtype=np.uint32))
    assert all(table[r, (17 + 5 * r) % W] == B for r in range(D))


def test_zero_weight_ops_are_pure_estimates():
    rng = np.random.default_rng(3)
    B = 384
    h1 = rng.integers(0, W, B).astype(np.uint32)
    h2 = rng.integers(0, W, B).astype(np.uint32)
    table = rng.integers(0, 100, (D, W)).astype(np.uint32)
    t_table, t_est = _seq(table, h1, h2, np.zeros(B, np.uint32))
    assert np.array_equal(t_table, table)
    g = table[np.arange(D)[None, :], (h1[:, None].astype(np.int64) + np.arange(D) * h2[:, None]) % W]
    assert np.array_equal(t_est, g.min(axis=1))
    wt = (rng.random(B) < 0.5).astype(np.uint32)
    g_table, g_est = cms_seq.golden_seq(table, h1, h2, wt, d=D, w=W)
    t_table, t_est = _seq(table, h1, h2, wt)
    assert np.array_equal(t_table, g_table) and np.array_equal(t_est, g_est)


def test_unsigned_min_past_2_31():
    """The port follows golden_seq's unsigned minimum (the Pallas kernel's
    int32 minimum would differ here)."""
    table = np.zeros((2, 128), np.uint32)
    table[0, 3] = 0x9000_0000
    table[1, 4] = 0x1000
    h1, h2 = np.array([3], np.uint32), np.array([1], np.uint32)
    g_table, g_est = cms_seq.golden_seq(table, h1, h2, np.ones(1, np.uint32), d=2, w=128)
    t_table, t_est = _seq(table, h1, h2, np.ones(1, np.uint32), d=2, w=128)
    assert np.array_equal(t_table, g_table) and t_est[0] == g_est[0] == 0x1001


def test_wrapper_checks_and_never_falls_back():
    flat = torch.zeros(D * W, dtype=torch.int32)
    ops = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        cms_seq.cms_update_estimate_seq(flat, ops.long(), ops, ops, d=D, w=W)
    with pytest.raises(ValueError):
        cms_seq.cms_update_estimate_seq(flat[: D * W - 1], ops, ops, ops, d=D, w=W)
    with pytest.raises(ValueError):  # a device with no kernel: no fallback
        meta = torch.zeros(D * W, dtype=torch.int32, device="meta")
        cms_seq.cms_update_estimate_seq(meta, *(t.to("meta") for t in (ops, ops, ops)), d=D, w=W)
    before = cms_seq.LAUNCHES
    cms_seq.cms_update_estimate_seq(flat, ops, ops, ops, d=D, w=W)
    assert cms_seq.LAUNCHES == before  # the plain version is not a launch


def test_vectorized_cms_ops_match_jax_multitenant():
    rng = np.random.default_rng(4)
    d, w = 5, 1000
    cpr = -(-d * w // 128) * 128
    flat0 = np.zeros(4 * cpr + 1, np.uint32)
    flat0[:-1] = rng.integers(0, 50, 4 * cpr)
    B = 400
    rows = rng.integers(0, 4, B).astype(np.int32)
    h1 = rng.integers(0, 30, B).astype(np.uint32) * np.uint32(31) % np.uint32(w)
    h2 = rng.integers(0, 30, B).astype(np.uint32) * np.uint32(7) % np.uint32(w)
    wt = rng.integers(0, 4, B).astype(np.uint32)
    kw = dict(d=d, w=w, cells_per_row=cpr)
    j_upd = jax.jit(jcms.cms_update_and_estimate, static_argnames=tuple(kw))
    j_new, j_est = j_upd(jnp.asarray(flat0), jnp.asarray(rows), jnp.asarray(h1),
                         jnp.asarray(h2), jnp.asarray(wt), **kw)
    flat = _t(flat0)
    est = cms.cms_update_and_estimate(flat, _t(rows), _t(h1), _t(h2), _t(wt), **kw)
    assert np.array_equal(_u32(flat), np.asarray(j_new))
    assert np.array_equal(_u32(est), np.asarray(j_est))
    j_only = jax.jit(jcms.cms_estimate, static_argnames=tuple(kw))(
        j_new, jnp.asarray(rows), jnp.asarray(h2), jnp.asarray(h1), **kw)
    only = cms.cms_estimate(flat, _t(rows), _t(h2), _t(h1), **kw)
    assert np.array_equal(_u32(only), np.asarray(j_only))


# -- the kernel's tile/grid plan and a NumPy model of its schedule -----------

_GEOMETRIES = [
    (5, 1 << 16),  # the main path: CountMinSketch(5, 65536)
    (2, 1 << 20),  # the gate's edge, d*w*4 = 8 MiB
    (1, 1 << 21),  # the gate's edge, one row
    (3, 10_007),  # w not a multiple of the tile: a ragged last tile
    (3, 20),  # w smaller than one tile
    (1, 1),
    (4, 4096),
    (7, 1000),
    (16_384, 128),  # more work items than blocks: grid-stride
    (1, (1 << 31) - 1),  # the widest row the wrapper accepts
]


@pytest.mark.parametrize("n_sm", [132, 114, 8])
@pytest.mark.parametrize("d,w", _GEOMETRIES)
def test_k1_plan_tiles_every_cell_once(d, w, n_sm):
    plan = cms_seq._plan(d, w, n_sm)
    T = plan.tile_w
    # Tiles are whole warps of cells, so every region of the dynamic shared
    # memory after the tile starts on a 128-byte boundary.
    assert T % cms_seq.TILE_ALIGN == 0 and T > 0
    assert plan.smem == 4 * (T + 6 * cms_seq.CHUNK + 16 + 2)
    assert plan.smem <= cms_seq.SMEM_PER_BLOCK
    assert plan.n_work == d * plan.tiles_per_row < 1 << 31
    assert 1 <= plan.grid <= plan.n_work
    # The tiles of a row cover [0, w) and none is empty.
    assert (plan.tiles_per_row - 1) * T < w <= plan.tiles_per_row * T
    if d * w <= 1 << 22:
        owner = np.zeros(d * w, np.int64)
        for item in range(plan.n_work):  # what the grid-stride loop visits
            r, t = divmod(item, plan.tiles_per_row)
            lo = t * T
            owner[r * w + lo : r * w + min(lo + T, w)] += 1
        assert np.all(owner == 1)
    if (d, w) == (5, 1 << 16) and n_sm == 132:
        assert plan.n_work == plan.grid == 130  # one work item per SM


def _row_cell(h1, h2, r, w):
    """The kernel's row cell: conditional subtraction below r = 16, one
    64-bit remainder above."""
    if r < 16:
        idx = h1.astype(np.int64)
        for _ in range(r):
            idx = idx + h2
            idx = np.where(idx >= w, idx - w, idx)
        return idx
    return (h1.astype(np.int64) + r * h2.astype(np.int64)) % w


def _group_scan(x, group):
    """The kernel's pointer-jumping scan: inclusive prefix of x (uint32)
    over each lane's group, lanes in order."""
    lanes = np.arange(32)
    below = group & ((1 << lanes) - 1)
    prev = np.array([int(m).bit_length() - 1 for m in below])
    x = x.astype(np.uint64)
    for _ in range(5):
        src = np.where(prev < 0, lanes, prev)
        xp, pp = x[src], prev[src]
        x = np.where(prev >= 0, (x + xp) & 0xFFFFFFFF, x)
        prev = np.where(prev >= 0, pp, prev)
    return x


def _kernel_model(table, h1, h2, wt, d, w, plan):
    """csrc/cms_seq.cu step by step: the filter warps' ballot ranks and
    segment offsets, each 32-op window's match-any groups, prefixes and
    last-of-group marks, then warp 0's walk.  Work items run in reverse
    order: blocks run in no order."""
    B = len(h1)
    chunk, seg = cms_seq.CHUNK, 32 * 8
    table = table.reshape(-1).astype(np.uint64)
    est = np.full(B, 0xFFFFFFFF, np.uint64)
    lanes = np.arange(32)
    for item in reversed(range(plan.n_work)):
        r, t = divmod(item, plan.tiles_per_row)
        lo = t * plan.tile_w
        ln = min(plan.tile_w, w - lo)
        tile = table[r * w + lo : r * w + lo + ln].copy()
        for c in range(-(-B // chunk)):
            kept = np.full((3, chunk), -1, np.int64)  # cell, weight, op
            counts = []
            for fw in range(15):  # count, then write after earlier segments
                j = c * chunk + fw * seg + lanes[None, :] + 32 * np.arange(8)[:, None]
                ok = j < B
                jj = np.where(ok, j, 0)
                off = _row_cell(h1[jj], h2[jj], r, w) - lo
                local = np.where(ok & (off >= 0) & (off < ln), off, -1)
                counts.append((j, local))
            at = 0
            for j, local in counts:
                for u in range(8):
                    bits = local[u] >= 0
                    rank = at + np.cumsum(bits) - bits  # popc(kept & lanemask_lt)
                    kept[0, rank[bits]] = local[u][bits]
                    kept[1, rank[bits]] = wt[j[u][bits]]
                    kept[2, rank[bits]] = j[u][bits]
                    at += int(bits.sum())
            for i in range(0, at, 32):  # warp 0's walk
                k = i + lanes
                active = k < at
                cell = np.where(active, kept[0, np.minimum(k, chunk - 1)], -1)
                weight = np.where(active, kept[1, np.minimum(k, chunk - 1)], 0)
                op = kept[2, np.minimum(k, chunk - 1)]
                group = np.array([int(np.sum((cell == cell[l]) << lanes)) for l in lanes])
                if np.all(weight <= 1):
                    le = (1 << (lanes + 1)) - 1
                    ones = int(np.sum((weight == 1).astype(np.int64) << lanes))
                    prefix = np.array([bin(g & ones & m).count("1") for g, m in zip(group, le)])
                else:
                    prefix = _group_scan(weight, group)
                cur = tile[np.where(active, cell, 0)]
                for l in lanes[active]:
                    val = (int(cur[l]) + int(prefix[l])) & 0xFFFFFFFF
                    est[op[l]] = min(est[op[l]], val)
                    if l == int(group[l]).bit_length() - 1:
                        tile[cell[l]] = val
        table[r * w + lo : r * w + lo + ln] = tile
    return table.astype(np.uint32).reshape(d, w), est.astype(np.uint32)


def _stream(kind, rng, B, w):
    if kind == "one_key":
        keys = np.full(B, 7)
    elif kind == "uniform":
        keys = rng.integers(0, 1 << 30, B)
    else:
        keys = rng.zipf(1.2, B) % 1000
    return (keys * 2654435761 % w).astype(np.uint32), (keys * 40503 % w).astype(np.uint32)


@pytest.mark.parametrize("d,w,B,kind,n_sm", [
    (5, 256, 33, "zipf", 132),
    (4, 1024, 1, "zipf", 132),
    (3, 1009, 4000, "zipf", 132),  # two chunks, a ragged last tile
    (2, 64, 600, "one_key", 132),
    (5, 4096, 500, "uniform", 20),
    (20, 96, 300, "zipf", 8),  # rows past 16 take the 64-bit remainder
    (3, 512, 200, "wrap", 132),  # weights past 2**32: the pointer-jumping scan
])
def test_k1_schedule_model_reproduces_golden_seq(d, w, B, kind, n_sm):
    rng = np.random.default_rng(B + d)
    h1, h2 = _stream("zipf" if kind == "wrap" else kind, rng, B, w)
    table = rng.integers(0, 1 << 16, (d, w)).astype(np.uint32)
    wt = (rng.random(B) < 0.9).astype(np.uint32)
    if kind == "wrap":
        table = rng.integers(0, 1 << 32, (d, w), dtype=np.uint64).astype(np.uint32)
        wt = rng.integers(0, 1 << 32, B, dtype=np.uint64).astype(np.uint32)
    plan = cms_seq._plan(d, w, n_sm)
    with np.errstate(over="ignore"):  # golden_seq wraps mod 2**32
        g_table, g_est = cms_seq.golden_seq(table, h1, h2, wt, d=d, w=w)
    m_table, m_est = _kernel_model(table, h1, h2, wt, d, w, plan)
    assert np.array_equal(m_table, g_table) and np.array_equal(m_est, g_est)
