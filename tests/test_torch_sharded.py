"""The port's sharded engine against the JAX package's, byte for byte.

One numpy-seeded op stream over all four sketch kinds — 64 tenants,
mixed adds and reads, PFMERGE, CMS.MERGE and BITOP with sources on
different shards, and a giant BitSet above a lowered
``mbit_threshold_words`` (m-sharded) — runs through a JAX client at
``use_tpu_sketch(num_shards=8)`` (the 8 virtual CPU devices of
``tests/conftest.py``) and a port client at ``use_gpu_sketch(
device="cpu", num_shards=8)``.  Both dispatch directly (``coalesce=
False``), so every launch holds the same ops in both packages.  Then:

* every per-op result is equal;
* every pool array is byte-equal (the ``[S, local_len]`` stacks,
  per-shard scratch words included);
* every object's DUMP bytes are equal;
* a snapshot of either package restores into the other at 8 shards,
  and resharded to 4 and to 1, with every row equal to the source's;
* ``change_topology(8 -> 4 -> 1)`` on the port leaves every row equal
  to the JAX client's after the same reshard, and its pools byte-equal.

Plus the capability flags and the cases of the port that have no JAX
counterpart: ``MeshContext`` refuses distinct devices, the sharded
executor's ``copy_row`` moves a tenant row into an m-sharded pool, the
rollback of a failed swap, and a retired executor forwarding.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
from redisson_tpu.codecs import LongCodec as JaxLongCodec  # noqa: E402
from redisson_tpu_torch.codecs import LongCodec  # noqa: E402
from redisson_tpu_torch.executor.failures import ExecutorRetiredError  # noqa: E402
from redisson_tpu_torch.executor.sharded_executor import (  # noqa: E402
    ShardedTorchCommandExecutor,
)
from redisson_tpu_torch.parallel.mesh import MeshContext  # noqa: E402

S = 8
THRESH = 256  # m-shard threshold (words) for the giant BitSet
GIANT_BITS = 1 << 16  # 2048-word rows: 256 words per shard
TENANTS = 16  # per kind: 64 in all


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_client(num_shards=S, snapshot_dir=None, **kw):
    cfg = rt.Config().set_codec(LongCodec())
    kw.setdefault("coalesce", False)
    cfg.use_gpu_sketch(device="cpu", num_shards=num_shards, min_bucket=64,
                       mbit_threshold_words=THRESH, **kw)
    if snapshot_dir is not None:
        cfg.snapshot_dir = str(snapshot_dir)
    return rt.create(cfg)


def jax_client(num_shards=S, snapshot_dir=None, **kw):
    kw.setdefault("coalesce", False)
    cfg = redisson_tpu.Config().set_codec(JaxLongCodec()).use_tpu_sketch(
        num_shards=num_shards, min_bucket=64, mbit_threshold_words=THRESH, **kw)
    if snapshot_dir is not None:
        cfg.snapshot_dir = str(snapshot_dir)
    return redisson_tpu.create(cfg)


def _stream(c, seed=0):
    """The seeded op stream; returns every per-op result in order."""
    rng = np.random.default_rng(seed)
    out = []
    keys = lambda n, hi=1 << 20: rng.integers(0, hi, n).astype(np.uint64)  # noqa: E731
    for t in range(TENANTS):
        bf = c.get_bloom_filter(f"bf{t}")
        out.append(bf.try_init(int(rng.integers(500, 5000)), 0.01))
        out.append(bf.add_all(keys(200, 5000)))
        hl = c.get_hyper_log_log(f"hl{t}")
        out.append(hl.add_all(keys(300)))
        bs = c.get_bit_set(f"bs{t}")
        out.append(list(bs.set_many(rng.integers(0, 4096, 150).astype(np.uint32))))
        cm = c.get_count_min_sketch(f"cm{t}")
        out.append(cm.try_init(4, 1 << 10))
        out.append(list(cm.add_all(keys(100, 200), rng.integers(1, 5, 100))))
    for t in range(TENANTS):
        bf = c.get_bloom_filter(f"bf{t}")
        out.append(list(bf.contains_each(keys(100, 5000))))
        out.append(bf.count())
        bs = c.get_bit_set(f"bs{t}")
        idx = rng.integers(0, 4096, 120).astype(np.uint32)
        out.append(list(bs.set_many(idx[:40], value=False)))
        out.append([bs.flip(int(i)) for i in idx[40:44]])
        out.append(list(bs.get_many(idx)))
        out.append((bs.cardinality(), bs.length(), bs.first_set_bit(),
                    bs.first_clear_bit()))
        out.append(c.get_hyper_log_log(f"hl{t}").count())
        out.append(list(c.get_count_min_sketch(f"cm{t}").estimate_all(keys(50, 200))))
    # Cross-shard merges and BITOP: sources on other shards than the dst.
    c.get_hyper_log_log("hl0").merge_with("hl3", "hl5", "hl10")
    out.append(c.get_hyper_log_log("hl0").count())
    c.get_count_min_sketch("cm1").merge("cm2", "cm7", "cm12")
    out.append(list(c.get_count_min_sketch("cm1").estimate_all(keys(50, 200))))
    c.get_bit_set("bs2").and_op("bs3", "bs9")
    c.get_bit_set("bs4").or_op("bs6")
    c.get_bit_set("bs5").xor_op("bs11")
    c.get_bit_set("bs7").not_op()
    c.get_bit_set("bs8").set_range(100, 3000)
    c.get_bit_set("bs8").clear_range(700, 900)
    for t in (2, 4, 5, 7, 8):
        out.append(c.get_bit_set(f"bs{t}").cardinality())
    # The giant (m-sharded) BitSets.
    for name in ("giant-a", "giant-b"):
        g = c.get_bit_set(name)
        g.set(GIANT_BITS - 1)
        out.append(list(g.set_many(rng.integers(0, GIANT_BITS, 3000).astype(np.uint32))))
    ga, gb = c.get_bit_set("giant-a"), c.get_bit_set("giant-b")
    ga.set_range(GIANT_BITS // 4 + 13, 3 * GIANT_BITS // 4 - 5)
    out.append(list(ga.set_many(rng.integers(0, GIANT_BITS, 500).astype(np.uint32),
                                value=False)))
    out.append([ga.flip(int(i)) for i in rng.integers(0, GIANT_BITS, 8)])
    out.append(list(ga.get_many(rng.integers(0, GIANT_BITS, 2000).astype(np.uint32))))
    out.append((ga.cardinality(), ga.length(), ga.first_set_bit(), ga.first_clear_bit()))
    ga.xor_op("giant-b")
    gb.not_op()
    out.append((ga.cardinality(), gb.cardinality()))
    return out


def _pools(c) -> dict:
    eng = c._engine
    return {tuple(p.spec.key): eng.executor.state_to_host(p) for p in eng.registry.pools()}


def _rows(c) -> dict:
    """name -> row bytes (the truth of every object, layout-free)."""
    eng = c._engine
    out = {}
    for e in eng.registry.entries():
        out[e.name] = np.asarray(eng.executor.read_row(e.pool, e.row)).tobytes()
    return out


def _assert_pools_equal(jc, tc):
    jp, tp = _pools(jc), _pools(tc)
    assert set(jp) == set(tp)
    for key in jp:
        assert jp[key].shape == tp[key].shape, key
        assert jp[key].dtype == tp[key].dtype, key
        np.testing.assert_array_equal(jp[key], tp[key], err_msg=str(key))


@pytest.fixture(scope="module")
def streamed():
    jc, tc = jax_client(), port_client()
    jout, tout = _stream(jc), _stream(tc)
    yield jc, tc, jout, tout
    jc.shutdown()
    tc.shutdown()


def test_per_op_results_equal(streamed):
    _, _, jout, tout = streamed
    assert len(jout) == len(tout)
    for i, (a, b) in enumerate(zip(jout, tout)):
        assert a == b, (i, a, b)


def test_pool_arrays_byte_equal(streamed):
    jc, tc, _, _ = streamed
    # The giant rows landed in an m-sharded pool on both sides.
    entry = tc._engine.registry.lookup("giant-a")
    assert tc._engine.executor._is_mbit(entry.pool)
    assert tuple(entry.pool.state.shape)[0] == S
    _assert_pools_equal(jc, tc)


def test_dump_bytes_equal(streamed):
    jc, tc, _, _ = streamed
    for name in jc._engine.registry.names():
        assert jc._engine.dump(name) == tc._engine.dump(name), name


def test_layout_rule_places_every_row_as_both_executors_do(streamed):
    """The one layout rule of ``parallel/mesh.py``, with which snapshot,
    restore and reshard read host arrays, finds every row where the
    port's executor and the JAX package's put it."""
    from redisson_tpu_torch.parallel import mesh as tpm

    jc, tc, _, _ = streamed
    jx, tx = jc._engine.executor, tc._engine.executor
    kinds = set()
    for e in tc._engine.registry.entries():
        pool, u = e.pool, e.pool.row_units
        kind = pool.spec.kind
        mbit = tpm.mbit_layout(kind, u, S, THRESH)
        kinds.add((kind, mbit))
        assert mbit == jx._mbit_layout(u, kind) == tx._is_mbit(pool), e.name
        host = tx.state_to_host(pool)
        assert tpm.layout_shape(kind, u, pool.capacity, S, THRESH) == host.shape
        got = tpm.read_host_row(host, kind, u, S, THRESH, e.row)
        np.testing.assert_array_equal(got, tx.read_row(pool, e.row), err_msg=e.name)
        jpool = jc._engine.registry.lookup(e.name).pool
        np.testing.assert_array_equal(got, np.asarray(jx.read_row(jpool, e.row)),
                                      err_msg=e.name)
        # write_host_row is its inverse: a zeroed copy rebuilt row by row.
        blank = np.zeros_like(host)
        tpm.write_host_row(blank, kind, u, S, THRESH, e.row, got)
        np.testing.assert_array_equal(
            tpm.read_host_row(blank, kind, u, S, THRESH, e.row), got)
    assert ("bitset", True) in kinds and ("bitset", False) in kinds


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("target_shards", [8, 4, 1])
def test_snapshot_restores_across_packages_and_shards(streamed, tmp_path, direction,
                                                      target_shards):
    jc, tc, _, _ = streamed
    src = jc if direction == "jax_to_port" else tc
    src._engine.snapshot(str(tmp_path))
    make = port_client if direction == "jax_to_port" else jax_client
    dst = make(num_shards=target_shards)
    try:
        assert dst._engine.restore_snapshot(str(tmp_path))
        assert getattr(dst._engine.executor, "S", 1) == target_shards
        assert _rows(dst) == _rows(src)
        for name in ("bf3", "hl0", "cm1", "bs7", "giant-a"):
            assert dst._engine.dump(name) == src._engine.dump(name), name
        if target_shards == S:  # same layout: installed verbatim
            _assert_pools_equal(src if src is jc else dst, dst if src is jc else src)
    finally:
        dst.shutdown()


def test_change_topology_matches_the_reference(streamed):
    """Runs after every other case on the streamed clients (it reshards
    them)."""
    jc, tc, _, _ = streamed
    golden = _rows(tc)
    for s in (4, 1):
        assert jc.change_topology(s) is True
        assert tc.change_topology(s) is True
        assert getattr(tc._engine.executor, "S", 1) == s
        assert _rows(tc) == _rows(jc) == golden
        _assert_pools_equal(jc, tc)
    assert tc.change_topology(1) is False
    # Traffic after the reshards still agrees.
    keys = np.arange(5000, 5600, dtype=np.uint64)
    for c in (jc, tc):
        c.get_bloom_filter("bf1").add_all(keys)
        c.get_bit_set("giant-b").set_many(np.arange(0, GIANT_BITS, 11, dtype=np.uint32))
    assert _rows(tc) == _rows(jc)
    _assert_pools_equal(jc, tc)


def test_replicated_filter_rows_equal_across_packages():
    jc, tc = jax_client(), port_client()
    try:
        keys = np.arange(3000, dtype=np.uint64)
        probe = np.arange(10_000, 14_000, dtype=np.uint64)
        results = []
        for c in (jc, tc):
            bf = c.get_bloom_filter("rep")
            bf.try_init(20_000, 0.01)
            bf.add_all(keys[:1000])
            assert bf.set_replicated() is True
            r = [bf.add_all(keys[1000:]), list(bf.contains_each(probe))]
            for _ in range(3):  # reads rotate across the replicas
                r.append(list(bf.contains_each(keys)))
            results.append(r)
        assert results[0] == results[1]
        je = jc._engine.registry.lookup("rep")
        te = tc._engine.registry.lookup("rep")
        assert je.replica_rows == te.replica_rows
        assert sorted(r % S for r in te.replica_rows) == list(range(S))
        row = tc._engine.executor.read_row(te.pool, te.row)
        for r in te.replica_rows:
            np.testing.assert_array_equal(tc._engine.executor.read_row(te.pool, r), row)
        _assert_pools_equal(jc, tc)
    finally:
        jc.shutdown()
        tc.shutdown()


# -- the port's own cases ----------------------------------------------------------


def test_capability_flags_route_around_k1_and_runs():
    c = port_client(coalesce=True)
    try:
        ex = c._engine.executor
        assert isinstance(ex, ShardedTorchCommandExecutor)
        assert ex.supports_seq_cms is False
        assert ex.supports_runs_metadata is False
        calls = []
        for name in ("cms_update_estimate_seq", "bloom_mixed_keys_runs",
                     "bitset_mixed_runs"):
            orig = getattr(ex, name)
            setattr(ex, name, lambda *a, _n=name, _o=orig, **k: (calls.append(_n), _o(*a, **k))[1])
        cm = c.get_count_min_sketch("seq")
        cm.try_init(4, 1 << 10)
        est = cm.add_all_seq(np.array([5, 5, 5, 7], np.uint64))
        assert list(est) == [3, 3, 3, 1]  # whole-batch estimates, not K1's 1, 2, 3
        bf = c.get_bloom_filter("bf")
        bf.try_init(1000, 0.01)
        bf.add_all(np.arange(100, dtype=np.uint64))
        c.get_bit_set("bs").set_many(np.arange(0, 500, 7, dtype=np.uint32))
        assert calls == []
    finally:
        c.shutdown()


def test_mesh_context_refuses_distinct_devices():
    """Distinct devices the shards do not split over evenly are refused,
    with both counts named; a split they do take is accepted."""
    with pytest.raises(ValueError, match=r"8 shards do not split evenly over 3 placements"):
        MeshContext(devices=["cpu", "meta", "cpu"], n_shards=8)
    ctx = MeshContext(devices=["cpu", "meta"], n_shards=2)
    assert [str(d) for d in ctx.devices] == ["cpu", "meta"] and ctx.per == 1


def test_mesh_context_places_shards_in_contiguous_blocks():
    """One device gives the single [S, L] stack; a repeated device
    gives separate placements on it (contiguous blocks of S/D shards);
    more devices than shards use the first S; S not a multiple of D
    raises naming both."""
    one = MeshContext(devices="cpu", n_shards=8)
    st = one.make_state(5, torch.int32)
    assert not one.placed and isinstance(st, torch.Tensor) and tuple(st.shape) == (8, 5)
    four = MeshContext(devices=["cpu"] * 4, n_shards=8)
    assert four.placed and four.per == 2 and len(four.devices) == 4
    assert [list(sh) for _, _, sh in four.placements()] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    st = four.make_state(5, torch.int32)
    assert tuple(st.shape) == (8, 5) and [tuple(b.shape) for b in st.blocks] == [(2, 5)] * 4
    st[5][3] = 7  # shard 5 is row 1 of placement 2
    assert int(st.blocks[2][1, 3]) == 7 and st.numel() == 40
    assert MeshContext(devices=["cpu"] * 8, n_shards=2).per == 1
    with pytest.raises(ValueError, match=r"6 shards .* 4 placements"):
        MeshContext(devices=["cpu"] * 4, n_shards=6)


def test_copy_row_into_an_m_sharded_pool_matches_the_reference():
    """A BitSet growing past the threshold moves from a tenant-sharded
    pool into an m-sharded one (the port's ``copy_row``; the JAX package
    copies through the host)."""
    jc, tc = jax_client(), port_client()
    try:
        for c in (jc, tc):
            bs = c.get_bit_set("grow")
            bs.set_many(np.arange(0, 4000, 3, dtype=np.uint32))
            bs.set(GIANT_BITS - 2)  # migrate into the m-sharded class
        assert tc._engine.executor._is_mbit(tc._engine.registry.lookup("grow").pool)
        assert jc.get_bit_set("grow").to_byte_array() == tc.get_bit_set("grow").to_byte_array()
        _assert_pools_equal(jc, tc)
    finally:
        jc.shutdown()
        tc.shutdown()


def test_failed_swap_rolls_back(monkeypatch):
    c = port_client()
    try:
        bf = c.get_bloom_filter("rb")
        bf.try_init(1000, 0.01)
        bf.add_all(np.arange(100, dtype=np.uint64))
        before = _pools(c)

        def boom(self, pool, arr):
            raise RuntimeError("injected install failure")

        monkeypatch.setattr(rt.executor.torch_executor.TorchCommandExecutor,
                            "state_from_host", boom)
        with pytest.raises(RuntimeError, match="injected"):
            c.change_topology(1)
        monkeypatch.undo()
        assert c._engine.config.gpu_sketch.num_shards == S
        assert c._engine.executor.S == S
        after = _pools(c)
        for key in before:
            np.testing.assert_array_equal(before[key], after[key])
        assert bf.contains_all(np.arange(100, dtype=np.uint64)) == 100
        assert c.change_topology(2) is True
        assert bf.contains_all(np.arange(100, dtype=np.uint64)) == 100
    finally:
        c.shutdown()


def test_retired_executor_forwards_and_refuses_runs():
    c = port_client(num_shards=1)
    try:
        bf = c.get_bloom_filter("ret")
        bf.try_init(1000, 0.01)
        bf.add_all(np.arange(10, dtype=np.uint64))
        old = c._engine.executor
        entry = c._engine.registry.lookup("ret")
        m, k = entry.params["size"], entry.params["hash_iterations"]
        assert c.change_topology(2) is True
        assert old._retired and old._successor is c._engine.executor
        assert int(old.bloom_count(entry.pool, entry.row, m, k).result()) > 0
        with pytest.raises(ExecutorRetiredError):
            old.bloom_mixed_keys_runs(
                entry.pool, k, np.zeros((1, 4), np.uint32), np.uint32(8),
                np.array([entry.row], np.int32), np.array([m], np.uint32),
                np.array([True]), np.array([0, 1], np.int32),
            )
    finally:
        c.shutdown()


def test_nodes_group_lists_one_node_per_shard():
    c = port_client()
    try:
        nodes = c.get_nodes_group().get_nodes()
        assert [n.shard for n in nodes] == list(range(S))
        assert {n.address for n in nodes} == {"cpu:0"}
        assert c.get_nodes_group().ping_all()
    finally:
        c.shutdown()
