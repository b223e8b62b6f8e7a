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
