"""Bloom ops of the torch port against the JAX package on the same pool and
ops: the pool state and the per-op results must be bit-identical, with
duplicates, invalid (padded) ops, several tenants and per-op m — at the
function level and through both executors' run-length dispatch."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import redisson_tpu_torch as rt  # noqa: E402
from redisson_tpu import Config as JaxConfig  # noqa: E402
from redisson_tpu.executor.tpu_executor import TpuCommandExecutor  # noqa: E402
from redisson_tpu.ops import bitops as jbitops  # noqa: E402
from redisson_tpu.ops import bloom as jbloom  # noqa: E402
from redisson_tpu.ops import fastpath as jfast  # noqa: E402
from redisson_tpu.tenancy import TenantRegistry as JaxRegistry  # noqa: E402
from redisson_tpu.utils import hashing as jh  # noqa: E402
from redisson_tpu_torch.executor.torch_executor import TorchCommandExecutor  # noqa: E402
from redisson_tpu_torch.ops import bitops, bloom, fastpath  # noqa: E402
from redisson_tpu_torch.tenancy import TenantRegistry  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The tests run several pytest workers side by side; one intra-op
    # thread per worker avoids oversubscribing the CPU.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WPR = 256  # words per row: one size class for every m below
MS = (5000, 6000, 8192)  # per-tenant bit counts sharing the class
K = 5


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def _pool(rng, tenants=3):
    flat = np.zeros(tenants * WPR + 1, np.uint32)
    flat[:-1] = rng.integers(0, 1 << 32, tenants * WPR, dtype=np.uint64) & np.uint64(
        0x0100_0101
    )  # sparse pre-set bits, so "set before the batch" is exercised
    return flat


def _ops(rng, B, n_keys=60):
    keys = rng.integers(0, n_keys, B).astype(np.uint64)  # heavy duplicates
    blocks, lens = jh.encode_uint64_batch(keys)
    tenant = rng.integers(0, len(MS), B)
    rows = tenant.astype(np.int32)
    m_arr = np.asarray(MS, np.uint32)[tenant]
    is_add = rng.random(B) < 0.5
    valid = np.ones(B, bool)
    valid[-B // 8 :] = False
    return rows, blocks, lens, m_arr, is_add, valid


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32) if t.dtype == torch.int32 else t.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bloom_mixed_keys_matches_jax(seed):
    rng = np.random.default_rng(seed)
    flat = _pool(rng)
    rows, blocks, lens, m_arr, is_add, valid = _ops(rng, 320)
    j_new, j_res = jax.jit(jfast.bloom_mixed_keys, static_argnames=("k", "words_per_row", "target_lanes"))(
        jnp.asarray(flat), jnp.asarray(rows), jnp.asarray(blocks[:, :2]),
        jnp.asarray(lens), jnp.asarray(m_arr), jnp.asarray(is_add),
        jnp.asarray(valid), k=K, words_per_row=WPR, target_lanes=4,
    )
    state = _t(flat)
    res = fastpath.bloom_mixed_keys(
        state, _t(rows), _t(blocks[:, :2]), _t(lens), _t(m_arr),
        torch.from_numpy(is_add), torch.from_numpy(valid),
        k=K, words_per_row=WPR, target_lanes=4,
    )
    assert np.array_equal(_u32(state), np.asarray(j_new))
    # Padded ops' results are never returned (the JAX gather reads them
    # out of range); every real op must agree.
    assert np.array_equal(res.numpy()[valid], np.asarray(j_res)[valid])


def test_hashed_bloom_ops_match_jax():
    rng = np.random.default_rng(5)
    flat = _pool(rng)
    B, m = 256, 8000
    rows = rng.integers(0, 3, B).astype(np.int32)
    h1 = rng.integers(0, 40, B).astype(np.uint32) * np.uint32(97) % np.uint32(m)
    h2 = rng.integers(0, 40, B).astype(np.uint32) * np.uint32(31) % np.uint32(m)
    is_add = rng.random(B) < 0.6
    valid = rng.random(B) < 0.9
    j_new, j_res = jax.jit(jbloom.bloom_mixed, static_argnames=("m", "k", "words_per_row"))(
        jnp.asarray(flat), jnp.asarray(rows), jnp.asarray(h1), jnp.asarray(h2),
        jnp.asarray(is_add), m=m, k=K, words_per_row=WPR, valid=jnp.asarray(valid),
    )
    state = _t(flat)
    res = bloom.bloom_mixed(
        state, _t(rows), _t(h1).long(), _t(h2).long(), torch.from_numpy(is_add),
        m=m, k=K, words_per_row=WPR, valid=torch.from_numpy(valid),
    )
    assert np.array_equal(_u32(state), np.asarray(j_new))
    assert np.array_equal(res.numpy()[valid], np.asarray(j_res)[valid])

    j_new, j_newly = jax.jit(jbloom.bloom_add, static_argnames=("m", "k", "words_per_row"))(
        jnp.asarray(flat), jnp.asarray(rows), jnp.asarray(h1), jnp.asarray(h2),
        m=m, k=K, words_per_row=WPR,
    )
    state = _t(flat)
    newly = bloom.bloom_add(state, _t(rows), _t(h1).long(), _t(h2).long(),
                            m=m, k=K, words_per_row=WPR)
    assert np.array_equal(_u32(state), np.asarray(j_new))
    assert np.array_equal(newly.numpy(), np.asarray(j_newly))
    j_hit = jbloom.bloom_contains(
        j_new, jnp.asarray(rows), jnp.asarray(h1), jnp.asarray(h2),
        m=m, k=K, words_per_row=WPR,
    )
    hit = bloom.bloom_contains(state, _t(rows), _t(h1).long(), _t(h2).long(),
                               m=m, k=K, words_per_row=WPR)
    assert np.array_equal(hit.numpy(), np.asarray(j_hit)) and hit.all()


def test_bit_packing_matches_jax():
    rng = np.random.default_rng(9)
    flags = rng.random(320) < 0.5
    packed = bitops.pack_bool_u32(torch.from_numpy(flags))
    assert np.array_equal(_u32(packed), np.asarray(jbitops.pack_bool_u32(jnp.asarray(flags))))
    assert np.array_equal(bitops.unpack_bool_u32(_u32(packed), 300), flags[:300])
    host = bitops.host_pack_bool_u32(flags[:301])
    assert np.array_equal(host, jbitops.host_pack_bool_u32(flags[:301]))
    assert np.array_equal(bitops.unpack_bool_u32_dev(_t(host), 301).numpy(), flags[:301])


def _executors():
    jex = TpuCommandExecutor(JaxConfig().use_tpu_sketch())
    tex = TorchCommandExecutor(rt.Config().use_gpu_sketch(device="cpu"))
    jreg = JaxRegistry(jex, initial_capacity=8, dispatch_lock=jex._dispatch_lock)
    treg = TenantRegistry(tex, initial_capacity=8, dispatch_lock=tex._dispatch_lock)
    pools = []
    for reg in (jreg, treg):
        for i, m in enumerate(MS):
            e, _ = reg.try_create(f"bf{i}", "bloom", (WPR,), {"size": m})
        pools.append(e.pool)
    return (jex, pools[0]), (tex, pools[1])


def _runs(rng, sizes, flags):
    C = len(sizes)
    starts = np.zeros(C + 1, np.int32)
    starts[1:] = np.cumsum(sizes)
    tenant = rng.integers(0, len(MS), C)
    return tenant.astype(np.int32), np.asarray(MS, np.uint32)[tenant], np.asarray(flags), starts


@pytest.mark.parametrize("case", ["const_len", "var_len", "full_run_table"])
def test_runs_dispatch_matches_jax_executor(case):
    """bloom_mixed_keys_runs end to end in both executors: packing, the
    on-device run expansion, padding and the scratch word."""
    rng = np.random.default_rng({"const_len": 0, "var_len": 1, "full_run_table": 2}[case])
    if case == "full_run_table":
        # C == Cp == 1024 runs ending in an add: padded ops take the last
        # run's row and flag, and (routed to scratch) set scratch bits.
        sizes = np.ones(1024, int)
        sizes[0] = 7
        flags = rng.random(1024) < 0.5
        flags[-1] = True
    else:
        sizes = rng.integers(1, 60, 9)
        flags = rng.random(9) < 0.5
    rows, m, flags, starts = _runs(rng, sizes, flags)
    B = int(starts[-1])
    if case == "var_len":
        items = [rng.bytes(int(n)) for n in rng.integers(0, 30, B)]
        items[:20] = items[20:40]  # duplicate keys across runs
        blocks, lengths = jh.encode_bytes_batch(items)
    else:
        blocks, lengths = jh.encode_uint64_batch(rng.integers(0, 80, B).astype(np.uint64))
        lengths = np.uint32(8)
    (jex, jpool), (tex, tpool) = _executors()
    seed_state = _pool(rng, tenants=8)
    jex.state_from_host(jpool, seed_state)
    tex.state_from_host(tpool, seed_state)
    j = jex.bloom_mixed_keys_runs(jpool, K, blocks, lengths, rows, m, flags, starts)
    t = tex.bloom_mixed_keys_runs(tpool, K, blocks, lengths, rows, m, flags, starts)
    assert np.array_equal(t.result(), j.result())
    j_state, t_state = jex.state_to_host(jpool), tex.state_to_host(tpool)
    assert np.array_equal(t_state, j_state)
    if case == "full_run_table":
        assert t_state[-1] != seed_state[-1]  # the scratch word was written


def test_single_tenant_keyed_paths_match_jax_executor():
    rng = np.random.default_rng(4)
    (jex, jpool), (tex, tpool) = _executors()
    keys = rng.integers(0, 3000, 4000).astype(np.uint64)
    blocks, lengths = jh.encode_uint64_batch(keys)
    m = MS[1]
    j = jex.bloom_add_keys_st(jpool, 1, m, K, blocks, lengths)
    t = tex.bloom_add_keys_st(tpool, 1, m, K, blocks, lengths)
    assert np.array_equal(t.result(), j.result())
    assert np.array_equal(tex.state_to_host(tpool), jex.state_to_host(jpool))
    probe, plen = jh.encode_uint64_batch(rng.integers(0, 6000, 999).astype(np.uint64))
    j = jex.bloom_contains_keys_st(jpool, 1, m, K, probe, plen)
    t = tex.bloom_contains_keys_st(tpool, 1, m, K, probe, plen)
    assert np.array_equal(t.result(), j.result())
