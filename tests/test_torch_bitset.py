"""RBitSet in the torch port against the JAX package: the same numpy
inputs go through both, and per-op results and pool bytes must be
identical — the segmented scans, the four opcodes with heavy duplicate
(word, bit) pairs, both executors' run-length and per-op dispatch,
range / count / position / BITOP queries, size-class migration and the
threaded coalesced path."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
from redisson_tpu import Config as JaxConfig  # noqa: E402
from redisson_tpu.executor.tpu_executor import TpuCommandExecutor  # noqa: E402
from redisson_tpu.ops import bitops as jbitops  # noqa: E402
from redisson_tpu.ops import bitset as jbitset  # noqa: E402
from redisson_tpu.tenancy import TenantRegistry as JaxRegistry  # noqa: E402
from redisson_tpu_torch.executor.torch_executor import TorchCommandExecutor  # noqa: E402
from redisson_tpu_torch.interop import load_sketch_rows  # noqa: E402
from redisson_tpu_torch.ops import bitops, bitset  # noqa: E402
from redisson_tpu_torch.tenancy import TenantRegistry  # noqa: E402

WPR = 128  # words per row: the smallest size class


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


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32) if t.dtype == torch.int32 else t.numpy()


def _pool(rng, tenants=3):
    flat = np.zeros(tenants * WPR + 1, np.uint32)
    flat[:] = rng.integers(0, 1 << 32, flat.shape[0], dtype=np.uint64)
    return flat


def _golden_mixed(flat, rows, idx, ops):
    """One op at a time on a bool copy of the pool: each op observes the
    bit just before it, then applies x -> a ^ (b & x)."""
    bits = np.unpackbits(flat.view(np.uint8), bitorder="little").astype(bool)
    obs = np.zeros(len(idx), bool)
    for j, (r, i, op) in enumerate(zip(rows, idx, ops)):
        g = int(r) * WPR * 32 + int(i)
        obs[j] = bits[g]
        bits[g] = bool(op & 1) ^ (bool(op >> 1) and bits[g])
    return np.packbits(bits, bitorder="little").view(np.uint32), obs


def test_segmented_scans_match_jax():
    rng = np.random.default_rng(0)
    n = 700
    first = rng.random(n) < 0.08
    first[0] = True
    b = (rng.random(n) < 0.7).astype(np.uint32)
    a = (rng.random(n) < 0.5).astype(np.uint32)
    j = jax.jit(jbitops._segmented_affine_scan)(jnp.asarray(first), jnp.asarray(b),
                                                jnp.asarray(a))
    t = bitops._segmented_affine_scan(torch.from_numpy(first), _t(b), _t(a))
    for x, y in zip(t, j):
        assert np.array_equal(x.numpy(), np.asarray(y))
    vals = rng.integers(0, 52, n).astype(np.int32)
    j = jax.jit(jbitops.segmented_exclusive_max)(jnp.asarray(first), jnp.asarray(vals))
    t = bitops.segmented_exclusive_max(torch.from_numpy(first), torch.from_numpy(vals))
    assert np.array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bitset_mixed_matches_jax_and_golden(seed):
    """Random opcodes on few (word, bit) pairs, so runs are long and mix
    every opcode; padded ops route to the scratch word as reads."""
    rng = np.random.default_rng(seed)
    flat = _pool(rng)
    B = 1500
    rows = rng.integers(0, 3, B).astype(np.int32)
    idx = rng.integers(0, 40, B).astype(np.uint32) * np.uint32(97) % np.uint32(WPR * 32)
    ops = rng.integers(0, 4, B).astype(np.uint32)
    valid = np.ones(B, bool)
    valid[-100:] = False
    ops[~valid] = jbitset.OP_GET
    j_new, j_obs = jax.jit(jbitset.bitset_mixed, static_argnames=("words_per_row",))(
        jnp.asarray(flat), jnp.asarray(rows), jnp.asarray(idx), jnp.asarray(ops),
        words_per_row=WPR, valid=jnp.asarray(valid),
    )
    state = _t(flat)
    obs = bitset.bitset_mixed(state, _t(rows), _t(idx), _t(ops), words_per_row=WPR,
                              valid=torch.from_numpy(valid))
    assert np.array_equal(_u32(state), np.asarray(j_new))
    assert np.array_equal(obs.numpy(), np.asarray(j_obs))
    g_flat, g_obs = _golden_mixed(flat[:-1], rows[valid], idx[valid], ops[valid])
    assert np.array_equal(_u32(state)[:-1], g_flat)
    assert np.array_equal(obs.numpy()[valid], g_obs)


@pytest.mark.parametrize("op", ["set", "clear", "flip", "get"])
def test_single_opcode_kernels_match_jax(op):
    rng = np.random.default_rng(3)
    flat = _pool(rng)
    B = 600
    rows = rng.integers(0, 3, B).astype(np.int32)
    idx = rng.integers(0, 50, B).astype(np.uint32) * np.uint32(13)
    valid = rng.random(B) < 0.9
    jfn, tfn = getattr(jbitset, f"bitset_{op}"), getattr(bitset, f"bitset_{op}")
    state = _t(flat)
    if op == "get":
        j_obs = jfn(jnp.asarray(flat), jnp.asarray(rows), jnp.asarray(idx), words_per_row=WPR)
        obs = tfn(state, _t(rows), _t(idx), words_per_row=WPR)
        j_new, valid = flat, np.ones(B, bool)
    else:
        j_new, j_obs = jfn(jnp.asarray(flat), jnp.asarray(rows), jnp.asarray(idx),
                           words_per_row=WPR, valid=jnp.asarray(valid))
        obs = tfn(state, _t(rows), _t(idx), words_per_row=WPR, valid=torch.from_numpy(valid))
    assert np.array_equal(_u32(state), np.asarray(j_new))
    # Padded ops' results are never returned; every real op must agree.
    assert np.array_equal(obs.numpy()[valid], np.asarray(j_obs)[valid])


def _executors(tenants=16):
    jex = TpuCommandExecutor(JaxConfig().use_tpu_sketch())
    tex = TorchCommandExecutor(rt.Config().use_gpu_sketch(device="cpu"))
    pools = []
    for ex in (jex, tex):
        reg = (JaxRegistry if ex is jex else TenantRegistry)(
            ex, initial_capacity=tenants, dispatch_lock=ex._dispatch_lock)
        for i in range(tenants):
            e, _ = reg.try_create(f"bs{i}", "bitset", (WPR,), {"nbits": 0})
        pools.append(e.pool)
    return (jex, pools[0]), (tex, pools[1])


@pytest.mark.parametrize("n_runs", [9, 1024, 1500])
def test_runs_and_per_op_dispatch_match_jax_executor(n_runs):
    """bitset_mixed_runs (up to 1024 runs: packing, run expansion,
    OP_GET padding, the scratch word) and the per-op bitset_mixed that
    takes over above 1024 runs, in both executors."""
    rng = np.random.default_rng(n_runs)
    sizes = rng.integers(1, 6, n_runs)
    run_rows = rng.integers(0, 16, n_runs).astype(np.int32)
    run_ops = rng.integers(0, 4, n_runs).astype(np.uint32)
    starts = np.zeros(n_runs + 1, np.int32)
    starts[1:] = np.cumsum(sizes)
    B = int(starts[-1])
    idx = rng.integers(0, 64, B).astype(np.uint32) * np.uint32(61)
    (jex, jpool), (tex, tpool) = _executors()
    seed_state = _pool(rng, tenants=16)
    jex.state_from_host(jpool, seed_state)
    tex.state_from_host(tpool, seed_state)
    if n_runs <= 1024:
        j = jex.bitset_mixed_runs(jpool, idx, run_rows, run_ops, starts)
        t = tex.bitset_mixed_runs(tpool, idx, run_rows, run_ops, starts)
    else:
        rows, ops = np.repeat(run_rows, sizes), np.repeat(run_ops, sizes)
        j = jex.bitset_mixed(jpool, rows, idx, ops)
        t = tex.bitset_mixed(tpool, rows, idx, ops)
    assert np.array_equal(t.result(), j.result())
    assert np.array_equal(tex.state_to_host(tpool), jex.state_to_host(jpool))
    g_flat, g_obs = _golden_mixed(seed_state[:-1], np.repeat(run_rows, sizes), idx,
                                  np.repeat(run_ops, sizes))
    assert np.array_equal(t.result(), g_obs)
    assert np.array_equal(tex.state_to_host(tpool)[:-1], g_flat)
    # Direct (uncoalesced) forms on the same pools.
    rows = rng.integers(0, 16, 300).astype(np.int32)
    idx = rng.integers(0, 30, 300).astype(np.uint32) * np.uint32(7)
    for name in ("bitset_set", "bitset_clear_bits", "bitset_flip", "bitset_get"):
        j = getattr(jex, name)(jpool, rows, idx)
        t = getattr(tex, name)(tpool, rows, idx)
        assert np.array_equal(t.result(), j.result()), name
        assert np.array_equal(tex.state_to_host(tpool), jex.state_to_host(jpool)), name


def _row(client, name):
    eng = client._engine
    eng._drain()
    e = eng.registry.lookup(name)
    u = e.pool.row_units
    return eng.executor.state_to_host(e.pool)[e.row * u : (e.row + 1) * u]


def _pair(**knobs):
    knobs.setdefault("min_bucket", 4096)
    jc = redisson_tpu.create(redisson_tpu.Config().use_tpu_sketch(**knobs))
    tc = rt.create(rt.Config().use_gpu_sketch(device="cpu", **knobs))
    return jc, tc


@pytest.mark.parametrize("coalesce", [True, False], ids=["coalesced", "direct"])
def test_queries_ranges_bitops_and_migration(coalesce):
    """set/get/flip/clear, set_range, cardinality/length/bitpos on full,
    empty and absent rows, BITOP AND/OR/XOR/NOT (NOT masked to the byte-
    aligned logical length), bytes, and a size-class migration (128 to
    512 words) that keeps every bit."""
    jc, tc = _pair(coalesce=coalesce)
    try:
        rng = np.random.default_rng(11)
        first = rng.integers(0, 4000, 500)
        probe = rng.integers(0, 5000, 300)
        out = []
        for c in (jc, tc):
            a, b, e = c.get_bit_set("a"), c.get_bit_set("b"), c.get_bit_set("e")
            got = [a.set_many(first), a.get_many(probe),
                   a.set(7), a.set(7, False), a.flip(9), a.flip(9), a.clear_bit(first[0]),
                   a.cardinality(), a.length(), a.first_set_bit(), a.first_clear_bit(),
                   a.size()]
            a.set_range(100, 1000)
            a.clear_range(333, 400)
            b.set_range(0, 70)
            got += [a.cardinality(), b.first_clear_bit(), b.length(),
                    e.cardinality(), e.length(), e.first_set_bit(), e.first_clear_bit()]
            grown = a.set_many([16000, 3])  # migration: 4096 -> 16384 bits
            got += [grown, a.size(), a.cardinality(), a.length(), _row(c, "a")]
            e.set_range(5, 5)  # empty range: creates the bitset, sets nothing
            got += [e.cardinality(), e.length(), e.first_set_bit(), e.size()]
            b.set(1999)
            b.and_op("a")
            got += [b.to_byte_array(), b.cardinality()]
            b.or_op("a", "e")
            b.xor_op("e")
            got += [_row(c, "b"), b.size()]
            a.not_op()
            got += [a.to_byte_array(), a.cardinality(), a.length(), _row(c, "a")]
            b.clear()
            got += [b.cardinality(), b.get(5), _row(c, "a")]
            out.append(got)
        for i, (x, y) in enumerate(zip(*out)):
            assert np.array_equal(np.asarray(x), np.asarray(y)), i
        t = out[1]
        assert t[15] == t[16] == 0 and t[17] == -1 and t[18] == 0  # e absent
        assert t[20] == 16384 and t[22] == 16001
    finally:
        tc.shutdown()
        jc.shutdown()


def _tenant_traffic(c, name, seed):
    """Interleaved async SET, CLEAR, FLIP and GET batches on one tenant,
    issued in order; plus one HLL add."""
    rng = np.random.default_rng(seed)
    bs = c.get_bit_set(name)
    eng = c._engine
    futs = []
    for step in range(6):
        idx = rng.integers(0, 300, int(rng.integers(1, 40))).astype(np.uint32)
        kind = step % 4
        if kind == 0:
            futs.append(bs.set_many_async(idx))
        elif kind == 1:
            futs.append(bs.set_many_async(idx, False))
        elif kind == 2:
            futs.append(eng.bitset_flip(name, idx))
        else:
            futs.append(bs.get_many_async(idx))
    futs.append(c.get_hyper_log_log("h" + name).add_all_async(
        rng.integers(0, 1000, 50).astype(np.uint64)))
    return [f.result() for f in futs]


def test_threaded_coalesced_interleaving():
    """Four threads, each owning four bitsets, interleave opcodes through
    the coalescer; flushes carry many runs."""
    names = [f"mt{i}" for i in range(16)]
    jc, tc = _pair(batch_window_us=5000)
    try:
        out = []
        for c in (jc, tc):
            res: dict = {}

            def worker(t):
                for name in names[t::4]:
                    res[name] = _tenant_traffic(c, name, int(name[2:]))

            threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            assert not any(th.is_alive() for th in threads)
            # Rows are handed out in the order the threads create tenants,
            # so compare tenant by tenant.
            out.append((res, {name: _row(c, name) for name in names}))
        (jres, jrows), (tres, trows) = out
        for name in names:
            for x, y in zip(jres[name], tres[name]):
                assert np.array_equal(np.asarray(x), np.asarray(y)), name
            assert np.array_equal(jrows[name], trows[name]), name
    finally:
        tc.shutdown()
        jc.shutdown()


@pytest.mark.parametrize("n_chunks", [300, 1100])
def test_one_flush_of_many_runs(n_chunks):
    """Tiny async calls queued under a long flush window land in one
    launch: the run-length form up to 1024 runs, per-op arrays above."""
    jc, tc = _pair(batch_window_us=2_000_000)
    try:
        rng = np.random.default_rng(n_chunks)
        plan = [(int(rng.integers(0, 4)), rng.integers(0, 500, int(rng.integers(1, 4))))
                for _ in range(n_chunks)]
        out = []
        for c in (jc, tc):
            eng = c._engine
            eng.bitset_ensure("many", 4096)
            calls = (lambda i: eng.bitset_set("many", i, True),
                     lambda i: eng.bitset_set("many", i, False),
                     lambda i: eng.bitset_flip("many", i),
                     lambda i: eng.bitset_get("many", i))
            futs = [calls[kind](idx) for kind, idx in plan]
            out.append(([f.result() for f in futs], _row(c, "many")))
        (jres, jrow), (tres, trow) = out
        for x, y in zip(jres, tres):
            assert np.array_equal(np.asarray(x), np.asarray(y))
        assert np.array_equal(jrow, trow)
    finally:
        tc.shutdown()
        jc.shutdown()


def test_load_sketch_rows_carries_jax_bitset():
    jc, tc = _pair()
    try:
        rng = np.random.default_rng(12)
        jbs = jc.get_bit_set("carried")
        jbs.set_many(rng.integers(0, 9000, 800))
        eng = jc._engine
        tbs = load_sketch_rows(tc, "carried", "bitset", eng.params("carried"),
                               _row(jc, "carried"))
        probe = rng.integers(0, 20_000, 700)
        assert np.array_equal(tbs.get_many(probe), jbs.get_many(probe))
        assert tbs.cardinality() == jbs.cardinality() and tbs.length() == jbs.length()
        more = rng.integers(0, 12_000, 400)
        assert np.array_equal(tbs.set_many(more), jbs.set_many(more))
        assert np.array_equal(_row(tc, "carried"), _row(jc, "carried"))
        assert tbs.to_byte_array() == jbs.to_byte_array()
        with pytest.raises(ValueError):
            load_sketch_rows(tc, "short", "bitset", {"nbits": 9000}, np.zeros(5, np.uint32))
    finally:
        tc.shutdown()
        jc.shutdown()
