"""The port's RObject durability (TTL, DUMP/RESTORE, snapshots) on the CPU,
and its byte formats against the JAX package's.

The first classes are the single-device cases of ``tests/test_durability.py``
run on the port (``use_gpu_sketch(device="cpu")``); TTL cases poll the
keyspace with a 5 s deadline instead of sleeping a fixed time.  The
differential cases run the same numpy-seeded ops through one JAX client
(``use_tpu_sketch(min_bucket=64)`` on the JAX CPU backend) and one port
client: DUMP bytes must be identical, a dump of either package must
restore into the other with byte-equal rows and equal answers, and a
snapshot directory of either must restore into the other with every pool
array byte-equal and the metadata equal except ``pools_crc`` (``np.savez``
stamps zip times, so the file bytes are not compared).
"""

import io
import json
import os
import pickle
import struct
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
from redisson_tpu.codecs import LongCodec as JaxLongCodec  # noqa: E402
from redisson_tpu_torch.codecs import LongCodec  # noqa: E402

DEADLINE_S = 5.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_client(snapshot_dir=None, codec=True, **kw):
    cfg = rt.Config()
    if codec:
        cfg.set_codec(LongCodec())
    cfg.use_gpu_sketch(device="cpu", min_bucket=64, **kw)
    if snapshot_dir is not None:
        cfg.snapshot_dir = str(snapshot_dir)
    return rt.create(cfg)


def make_jax_client(snapshot_dir=None):
    cfg = redisson_tpu.Config().set_codec(JaxLongCodec()).use_tpu_sketch(min_bucket=64)
    if snapshot_dir is not None:
        cfg.snapshot_dir = str(snapshot_dir)
    return redisson_tpu.create(cfg)


@pytest.fixture
def client():
    c = make_client()
    yield c
    c.shutdown()


def wait_until(cond, what: str) -> None:
    deadline = time.time() + DEADLINE_S
    while not cond():
        assert time.time() < deadline, f"{what} within {DEADLINE_S} s"
        time.sleep(0.02)


class TestTTL:
    def test_expire_makes_sketch_vanish(self, client):
        bf = client.get_bloom_filter("ttl-bf")
        bf.try_init(1000, 0.01)
        bf.add(123)
        assert bf.is_exists()
        assert bf.remain_time_to_live() == -1
        assert bf.expire(0.15)
        assert 0 < bf.remain_time_to_live() <= 150
        wait_until(lambda: not bf.is_exists(), "the filter expires")
        assert bf.remain_time_to_live() == -2
        # Re-init lands on a fresh, empty filter.
        assert bf.try_init(1000, 0.01)
        assert not bf.contains(123)

    def test_clear_expire(self, client):
        h = client.get_hyper_log_log("ttl-hll")
        h.add(1)
        assert h.expire(0.15)
        assert h.clear_expire()
        assert h.remain_time_to_live() == -1
        time.sleep(0.3)  # past the cleared deadline: it must still exist
        assert h.is_exists()

    def test_expire_absent_is_false(self, client):
        bf = client.get_bloom_filter("ttl-none")
        assert not bf.expire(1.0)
        assert not bf.clear_expire()

    def test_delete_expired_reports_false(self, client):
        bs = client.get_bit_set("ttl-bs")
        bs.set(5)
        deadline = time.time() + 0.05
        assert bs.expire_at(deadline)
        wait_until(lambda: time.time() >= deadline, "the deadline passes")
        assert not bs.delete()
        assert not bs.is_exists()
        # Expired but certainly unswept: DEL frees it and reports False.
        h = client.get_hyper_log_log("ttl-del")
        h.add(1)
        entry = client._engine.registry.lookup("ttl-del")
        entry.expire_at = time.time() - 1
        assert not h.delete()
        assert "ttl-del" not in client._engine.names()
        assert not client._engine.executor.read_row(entry.pool, entry.row).any()

    def test_expired_object_reads_as_absent_on_data_paths(self, client):
        h = client.get_hyper_log_log("ttl-data")
        h.add_all([1, 2, 3])
        cms = client.get_count_min_sketch("ttl-cms")
        cms.try_init(2, 256)
        e_h = client._engine.registry.lookup("ttl-data")
        e_h.expire_at = time.time() - 1  # due, not yet swept
        client._engine.registry.lookup("ttl-cms").expire_at = time.time() - 1
        assert h.count() == 0
        with pytest.raises(RuntimeError, match="not initialized"):
            cms.estimate(1)
        # The lazy reap zeroed the row before freeing it.
        assert not client._engine.executor.read_row(e_h.pool, e_h.row).any()

    def test_sweeper_reclaims_without_touch(self, client):
        bf = client.get_bloom_filter("ttl-sweep")
        bf.try_init(1000, 0.01)
        bf.expire(0.1)
        engine = client._engine
        wait_until(lambda: engine.registry.lookup("ttl-sweep") is None, "the sweeper reaps")


class TestDumpRestore:
    def test_bloom_dump_restore_bit_exact(self, client):
        bf = client.get_bloom_filter("dump-bf")
        bf.try_init(10_000, 0.01)
        keys = np.arange(5000, dtype=np.uint64)
        bf.add_all(keys)
        blob = bf.dump()
        bf2 = client.get_bloom_filter("dump-bf2")
        bf2.restore(blob)
        assert all(bf2.contains_each(keys))
        probe = np.arange(100_000, 101_000, dtype=np.uint64)
        assert list(bf.contains_each(probe)) == list(bf2.contains_each(probe))
        assert bf2.dump() == blob

    def test_restore_busykey(self, client):
        h = client.get_hyper_log_log("dump-hll")
        h.add_all([1, 2, 3])
        blob = h.dump()
        with pytest.raises(ValueError, match="BUSYKEY"):
            h.restore(blob)
        h.restore(blob, replace=True)
        assert h.is_exists()
        assert h.count() == 3

    def test_dump_absent_raises(self, client):
        bf = client.get_bloom_filter("dump-none")
        with pytest.raises(RuntimeError):
            bf.dump()

    def test_dump_wire_format_is_data_only(self, client):
        c = client.get_count_min_sketch("dump-cms")
        c.try_init(4, 1 << 10)
        c.add(7)
        blob = c.dump()
        assert blob[:4] == b"RTPU"
        with pytest.raises(Exception):
            pickle.loads(blob)  # not a pickle stream


class TestSnapshot:
    def test_kill_and_restore_round_trips(self, tmp_path):
        c1 = make_client(tmp_path)
        bf = c1.get_bloom_filter("snap-bf")
        bf.try_init(10_000, 0.001)
        keys = np.arange(7000, dtype=np.uint64)
        bf.add_all(keys)
        h = c1.get_hyper_log_log("snap-hll")
        h.add_all(np.arange(3000, dtype=np.uint64))
        hll_count = h.count()
        bs = c1.get_bit_set("snap-bs")
        bs.set_many(np.arange(0, 2048, 7, dtype=np.uint32))
        probe = np.arange(50_000, 52_000, dtype=np.uint64)
        fp_pattern = list(bf.contains_each(probe))
        c1.shutdown()  # writes the final snapshot

        c2 = make_client(tmp_path)  # restores on create
        try:
            bf2 = c2.get_bloom_filter("snap-bf")
            assert bf2.is_exists()
            assert bf2.count() > 6000
            assert all(bf2.contains_each(keys))
            # Bit-exact: the same false-positive pattern, not just hits.
            assert list(bf2.contains_each(probe)) == fp_pattern
            assert c2.get_hyper_log_log("snap-hll").count() == hll_count
            assert c2.get_bit_set("snap-bs").cardinality() == len(range(0, 2048, 7))
            # Params survived: re-init reports already-initialized.
            assert not bf2.try_init(10_000, 0.001)
        finally:
            c2.shutdown()

    def test_snapshot_preserves_ttl(self, tmp_path):
        c1 = make_client(tmp_path)
        bf = c1.get_bloom_filter("snap-ttl")
        bf.try_init(1000, 0.01)
        bf.expire(30.0)
        c1.shutdown()
        c2 = make_client(tmp_path)
        try:
            ttl = c2.get_bloom_filter("snap-ttl").remain_time_to_live()
            assert 0 < ttl <= 30_000
        finally:
            c2.shutdown()

    def test_periodic_snapshotter(self, tmp_path):
        cfg_dir = tmp_path / "periodic"
        cfg = rt.Config().set_codec(LongCodec()).use_gpu_sketch(device="cpu", min_bucket=64)
        cfg.snapshot_dir = str(cfg_dir)
        cfg.snapshot_interval_s = 0.2
        c = rt.create(cfg)
        try:
            bf = c.get_bloom_filter("snap-periodic")
            bf.try_init(1000, 0.01)
            bf.add_all(np.arange(100, dtype=np.uint64))
            wait_until(lambda: (cfg_dir / "sketch_meta.json").exists(), "a periodic snapshot")
        finally:
            c.shutdown()
        with open(cfg_dir / "sketch_meta.json") as f:
            assert [t["name"] for t in json.load(f)["tenants"]] == ["snap-periodic"]

    def test_new_objects_after_restore_get_fresh_rows(self, tmp_path):
        """Restored free lists must not hand out rows that restored
        tenants own."""
        c1 = make_client(tmp_path)
        for i in range(5):
            bf = c1.get_bloom_filter(f"fr-{i}")
            bf.try_init(1000, 0.01)
            bf.add(i)
        c1.shutdown()
        c2 = make_client(tmp_path)
        try:
            nbf = c2.get_bloom_filter("fr-new")
            nbf.try_init(1000, 0.01)
            nbf.add_all(np.arange(100, dtype=np.uint64))
            for i in range(5):
                old = c2.get_bloom_filter(f"fr-{i}")
                assert old.contains(i)
                assert old.count() <= 3  # the new tenant's keys did not leak in
        finally:
            c2.shutdown()

    def test_restore_refuses_live_keyspace_and_torn_blob(self, tmp_path):
        c1 = make_client()
        c1.get_hyper_log_log("live").add(1)
        c1.snapshot(str(tmp_path))
        try:
            with pytest.raises(ValueError, match="BUSYKEY"):
                c1._engine.restore_snapshot(str(tmp_path))
        finally:
            c1.shutdown()
        with open(tmp_path / "sketch_pools.npz", "ab") as f:
            f.write(b"torn")
        c2 = make_client()
        try:
            with pytest.raises(ValueError, match="torn snapshot"):
                c2._engine.restore_snapshot(str(tmp_path))
            assert c2._engine.names() == []
        finally:
            c2.shutdown()


class TestForgedDumps:
    """Dump payloads cross trust boundaries: forged headers are rejected
    BEFORE allocation or object creation."""

    def test_forged_giant_npy_shape_rejected(self, client):
        c = client.get_bloom_filter("forge-src")
        c.try_init(1000, 0.01)
        blob = bytearray(c.dump())
        i = blob.find(b"'shape': (")
        assert i > 0
        j = blob.index(b")", i)
        forged = bytes(blob[:i]) + b"'shape': (1099511627776,)" + bytes(blob[j + 1:])
        with pytest.raises(ValueError, match="declares|descr|header"):
            client._engine.restore("forge-dst", forged)
        assert not client._engine.exists("forge-dst")

    def test_mismatched_row_rejected_before_create(self, client):
        h = client.get_hyper_log_log("forge-hll")
        h.add(1)
        raw = h.dump()
        (hlen,) = struct.unpack("<I", raw[4:8])
        buf = io.BytesIO()
        np.save(buf, np.zeros(7, np.uint8), allow_pickle=False)  # wrong length
        with pytest.raises(ValueError, match="shape"):
            client._engine.restore("forge-hll2", raw[: 8 + hlen] + buf.getvalue())
        assert not client._engine.exists("forge-hll2")


class TestTopKDurability:
    """The engine-shared heavy-hitter tables survive durability
    boundaries: counters without candidates would give an empty top_k()."""

    def test_dump_restore_keeps_topk(self, client):
        c = client.get_count_min_sketch("tk-src")
        c.try_init(4, 1 << 10, track_top_k=3)
        for key, n in ((1, 9), (2, 5), (3, 2)):
            for _ in range(n):
                c.add(key)
        c2 = client.get_count_min_sketch("tk-dst")
        c2.restore(c.dump())
        assert c2.top_k(2) == c.top_k(2) == [(1, 9), (2, 5)]

    def test_snapshot_restore_keeps_topk(self, tmp_path):
        d = str(tmp_path / "snap")
        c1 = make_client()
        cms = c1.get_count_min_sketch("tk-snap")
        cms.try_init(4, 1 << 10, track_top_k=3)
        for key, n in ((7, 11), (8, 4)):
            for _ in range(n):
                cms.add(key)
        c1._engine.snapshot(d)
        c1.shutdown()
        c2 = make_client()
        try:
            assert c2._engine.restore_snapshot(d)
            assert c2.get_count_min_sketch("tk-snap").top_k(2) == [(7, 11), (8, 4)]
        finally:
            c2.shutdown()

    def test_topk_key_types_survive_round_trip(self):
        """Candidate keys keep their scalar type across dump/restore (the
        default codec encodes np.uint64(5) and 5 differently)."""
        c = make_client(codec=False)
        try:
            cms = c.get_count_min_sketch("tk-np")
            cms.try_init(4, 1 << 10, track_top_k=3)
            cms.add_all(np.array([11, 11, 11, 22, 22, 33], dtype=np.uint64))
            before = cms.top_k(2)
            assert before == [(11, 3), (22, 2)]
            cms2 = c.get_count_min_sketch("tk-np2")
            cms2.restore(cms.dump())
            assert cms2.top_k(2) == before
            cands = c._engine.topk.candidates("tk-np2")
            assert all(type(k) is np.uint64 for k in cands), cands
        finally:
            c.shutdown()

    def test_topk_export_import_state_round_trip(self, client):
        from redisson_tpu_torch.objects.engines import TopKStore

        cms = client.get_count_min_sketch("tk-state")
        cms.try_init(4, 1 << 10, track_top_k=2)
        cms.add_all([3, 3, 4])
        state = client._engine.topk.export_state()
        other = TopKStore()
        other.import_state(state)
        assert other.export_state() == state
        assert other.track("tk-state") == 2 and set(other.candidates("tk-state")) == {3, 4}
        other.import_state(None, "tk-state")  # a dump with no table clears it
        assert other.candidates("tk-state") == []

    def test_topk_ghost_table_cleared_on_replace(self, client):
        tracked = client.get_count_min_sketch("tk-ghost")
        tracked.try_init(4, 1 << 10, track_top_k=3)
        for _ in range(9):
            tracked.add(5)
        assert tracked.top_k(1) == [(5, 9)]
        plain = client.get_count_min_sketch("tk-plain")
        plain.try_init(4, 1 << 10)  # no tracking
        plain.add(7)
        tracked.restore(plain.dump(), replace=True)
        assert client._engine.topk.candidates("tk-ghost") == []

    @pytest.mark.parametrize("forged_topk", [
        '{"k": 1152921504606846976, "cands": []}',   # absurd k
        '{"k": 3, "cands": [["zz", 1, 2]]}',          # unknown tag
        '{"k": 3, "cands": [["b", "not-hex", 2]]}',   # bad hex
    ])
    def test_topk_forged_blob_rejected_before_install(self, client, forged_topk):
        src = client.get_count_min_sketch("tk-forge-src")
        src.try_init(4, 1 << 10, track_top_k=3)
        src.add(1)
        raw = src.dump()
        (hlen,) = struct.unpack("<I", raw[4:8])
        hdr = json.loads(raw[8 : 8 + hlen].decode())
        hdr["topk"] = json.loads(forged_topk)
        new_hdr = json.dumps(hdr).encode()
        forged = raw[:4] + struct.pack("<I", len(new_hdr)) + new_hdr + raw[8 + hlen :]
        with pytest.raises(ValueError):
            client.get_count_min_sketch("tk-forge-dst").restore(forged)
        assert not client.get_count_min_sketch("tk-forge-dst").is_exists()


# -- against the JAX package ---------------------------------------------------

_GETTERS = {
    "bloom": "get_bloom_filter",
    "hll": "get_hyper_log_log",
    "bitset": "get_bit_set",
    "cms": "get_count_min_sketch",
}


def _load(c, kind: str, name: str, seed: int):
    """The same numpy-seeded ops on a ``kind`` object of either package."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 40, 3000).astype(np.uint64)
    obj = getattr(c, _GETTERS[kind])(name)
    if kind == "bloom":
        obj.try_init(5000, 0.01)
        obj.add_all(keys)
    elif kind == "hll":
        obj.add_all(keys)
    elif kind == "bitset":
        obj.set_many((keys % 40_000).astype(np.uint32))
        obj.set_many((keys[:500] % 40_000).astype(np.uint32), False)
    else:
        obj.try_init(4, 1024, track_top_k=3)
        obj.add_all((rng.zipf(1.3, 4000) % 300).astype(np.uint64))
    return obj


def _answers(obj, kind: str):
    probe = np.arange(1 << 20, (1 << 20) + 2000, dtype=np.uint64)
    if kind == "bloom":
        return obj.count(), obj.contains_each(probe).tolist()
    if kind == "hll":
        return obj.count()
    if kind == "bitset":
        return obj.cardinality(), obj.length(), obj.to_byte_array()
    return obj.top_k(3), obj.estimate_all(np.arange(300, dtype=np.uint64)).tolist()


def _row(c, name):
    eng = c._engine
    eng._drain()
    e = eng.registry.lookup(name)
    u = e.pool.row_units
    return eng.executor.state_to_host(e.pool)[e.row * u : (e.row + 1) * u]


@pytest.fixture(scope="module")
def both():
    jc, tc = make_jax_client(), make_client()
    yield jc, tc
    tc.shutdown()
    jc.shutdown()


@pytest.mark.parametrize("kind", list(_GETTERS))
def test_dump_bytes_identical_across_packages(both, kind):
    blobs = [_load(c, kind, f"same-{kind}", 7).dump() for c in both]
    assert blobs[0] == blobs[1]


@pytest.mark.parametrize("kind", list(_GETTERS))
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_dump_restores_across_packages(both, kind, direction):
    jc, tc = both
    src_c, dst_c = (jc, tc) if direction == "jax_to_port" else (tc, jc)
    src = _load(src_c, kind, f"x-{kind}-{direction}", 11)
    dst = getattr(dst_c, _GETTERS[kind])(f"y-{kind}-{direction}")
    dst.restore(src.dump())
    assert np.array_equal(_row(dst_c, dst.name), _row(src_c, src.name))
    assert _answers(dst, kind) == _answers(src, kind)
    assert dst.dump() == src.dump()  # the blob carries no name


def _fill_keyspace(c):
    """Every kind, two size classes of bitset, a TTL, a deleted row and
    a rename, so the snapshot carries free-list holes and every key."""
    for kind in _GETTERS:
        _load(c, kind, f"snap-{kind}", 3)
    big = c.get_bit_set("snap-big")
    big.set_many(np.array([5, 1 << 20], np.uint32))
    c.get_bloom_filter("snap-bloom").expire_at(4_000_000_000.0)
    c.get_hyper_log_log("snap-gone").add_all([1, 2, 3])
    c.get_hyper_log_log("snap-gone").delete()
    c.get_hyper_log_log("snap-old").add_all([4, 5])
    c.get_hyper_log_log("snap-old").rename("snap-new")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_restores_across_packages(tmp_path, direction):
    jc, tc = make_jax_client(), make_client()
    try:
        dirs = {}
        for tag, c in (("jax", jc), ("port", tc)):
            _fill_keyspace(c)
            dirs[tag] = str(tmp_path / tag)
            c._engine.snapshot(dirs[tag])
        metas, pools = [], []
        for tag in ("jax", "port"):
            with open(os.path.join(dirs[tag], "sketch_meta.json")) as f:
                meta = json.load(f)
            meta.pop("pools_crc")
            metas.append(meta)
            with np.load(os.path.join(dirs[tag], "sketch_pools.npz")) as z:
                pools.append({k: z[k] for k in z.files})
        assert metas[0] == metas[1]
        assert pools[0].keys() == pools[1].keys()
        for k in pools[0]:
            assert pools[0][k].dtype == pools[1][k].dtype
            assert np.array_equal(pools[0][k], pools[1][k]), k

        src_tag, make_dst = (
            ("jax", make_client) if direction == "jax_to_port" else ("port", make_jax_client)
        )
        src_c = jc if src_tag == "jax" else tc
        dst_c = make_dst(dirs[src_tag])  # restores on create
        try:
            eng = dst_c._engine
            for p in eng.registry.pools():
                i = [tuple(m["key"]) for m in metas[0]["pools"]].index(tuple(p.spec.key))
                assert np.array_equal(eng.executor.state_to_host(p), pools[0][f"pool_{i}"])
            assert sorted(eng.names()) == sorted(src_c._engine.names())
            for kind in _GETTERS:
                name = f"snap-{kind}"
                got = _answers(getattr(dst_c, _GETTERS[kind])(name), kind)
                assert got == _answers(getattr(src_c, _GETTERS[kind])(name), kind)
            ttl = dst_c.get_bloom_filter("snap-bloom").remain_time_to_live()
            assert ttl > 0
            assert dst_c.get_hyper_log_log("snap-new").count() == 2
            # New objects land in free rows, not in restored ones.
            fresh = dst_c.get_hyper_log_log("fresh")
            fresh.add(99)
            rows = {(e.pool.spec.key, e.row) for e in eng.registry.entries()}
            assert len(rows) == len(eng.registry.entries())
        finally:
            dst_c._engine.config.snapshot_dir = None  # no shutdown snapshot
            dst_c.shutdown()
    finally:
        tc.shutdown()
        jc.shutdown()
