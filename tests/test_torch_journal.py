"""The port's op journal, crash recovery and RESP persistence surface
against the JAX package's.

Three kinds of check:

* the JAX package's own ``tests/test_journal.py`` classes run again on
  the port (``port_class`` rebinds their globals and in-body imports to
  the port, on the CPU; ``test_replay_onto_resharded_topology``
  recovers onto a two-shard engine).  Every method runs, the
  host-hashed ``bloom_add`` of ``test_always_future_done_tracks_durability``
  included;
* state carried across the packages: ``encode_record`` gives the same
  bytes for the same records, and a snapshot plus a journal tail written
  by either package recovers into the other with every pool byte-equal
  to the writer's own recovery;
* the RESP replies to ``CONFIG GET appendonly|appendfsync``, ``WAIT``,
  ``INFO persistence`` and ``BGREWRITEAOF`` are byte-equal to the JAX
  server's on the same state.
"""

import inspect
import os
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
import test_journal as _ref  # noqa: E402
from redisson_tpu.codecs import LongCodec as JaxLongCodec  # noqa: E402
from redisson_tpu.durability import journal as jax_journal  # noqa: E402
from redisson_tpu_torch.analysis import witness as port_witness  # noqa: E402
from redisson_tpu_torch.codecs import LongCodec  # noqa: E402
from redisson_tpu_torch.durability import journal as port_journal  # noqa: E402
from redisson_tpu_torch.objects.engines import _DurableResult  # noqa: E402
from test_torch_grid_coordination import port_case  # noqa: E402


@pytest.fixture(autouse=True)
def _port_witness_guard():
    """``tests/conftest.py`` drains only the JAX package's witness: under
    ``RTPU_LOCK_WITNESS=1`` a test that leaves a violation in the port's
    fails with its stack pairs (nothing to do with the witness off)."""
    yield
    if port_witness.active():
        vs = port_witness.take_violations()
        if vs:
            pytest.fail(
                "port lock-order witness found %d violation(s):\n\n%s"
                % (len(vs), "\n\n".join(v.format() for v in vs)),
                pytrace=False,
            )


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the JAX package's journal tests on the port ---------------------------------

# The reference module's helpers, rebound to the port too (a helper is a
# function of the test module, so port_case must rebind it by name).
_make_cfg = port_case(_ref.make_cfg)
_HELPERS = dict(
    make_cfg=_make_cfg,
    make_client=port_case(_ref.make_client, make_cfg=_make_cfg),
    crash=port_case(_ref.crash),
    engine_rows=port_case(_ref.engine_rows),
)


def _port_journal_class(ref, skip=()):
    """``ref`` with every method (and the helpers it calls) on the port."""
    ns = {"__module__": __name__}
    for name, fn in vars(ref).items():
        if inspect.isfunction(fn):
            ns[name] = port_case(fn, **_HELPERS)
    for name in skip:
        ns[name] = None
    return type(ref.__name__, (ref,), ns)


TestRecordCodec = _port_journal_class(_ref.TestRecordCodec)
TestJournalCore = _port_journal_class(_ref.TestJournalCore)
TestEngineRecovery = _port_journal_class(_ref.TestEngineRecovery)
TestRecoveryEdgeCases = _port_journal_class(_ref.TestRecoveryEdgeCases)
TestSnapshotCrashSafety = _port_journal_class(_ref.TestSnapshotCrashSafety)


class TestRespPersistence(_port_journal_class(_ref.TestRespPersistence)):
    @pytest.fixture
    def served(self, tmp_path):
        """The reference fixture on a port client and server."""
        from redisson_tpu_torch.serve.resp import RespServer
        from test_resp_server import RespClient

        client = _HELPERS["make_client"](tmp_path, fsync="everysec")
        server = RespServer(client)
        conn = RespClient(server.host, server.port)
        yield conn, client
        conn.close()
        server.close()
        client.config.snapshot_dir = None
        client._engine.config.snapshot_dir = None
        client.shutdown()


def test_reference_classes_run_on_the_port(tmp_path):
    """The rebound helpers build port clients (not the JAX package's)."""
    c = _HELPERS["make_client"](tmp_path)
    try:
        assert type(c._engine).__module__.startswith("redisson_tpu_torch")
        assert c._engine.journal is not None
    finally:
        _HELPERS["crash"](c)


# -- helpers -----------------------------------------------------------------------


def _port_cfg(d, fsync="always", snap=True, journal=True):
    cfg = rt.Config().set_codec(LongCodec()).use_gpu_sketch(device="cpu", min_bucket=64)
    if snap:
        cfg.snapshot_dir = os.path.join(d, "snap")
    if journal:
        cfg.journal_dir = os.path.join(d, "journal")
        cfg.journal_fsync = fsync
    return cfg


def _jax_cfg(d, fsync="always", snap=True, journal=True):
    cfg = redisson_tpu.Config().set_codec(JaxLongCodec()).use_tpu_sketch(min_bucket=64)
    if snap:
        cfg.snapshot_dir = os.path.join(d, "snap")
    if journal:
        cfg.journal_dir = os.path.join(d, "journal")
        cfg.journal_fsync = fsync
    return cfg


def _crash(client):
    """Tear a client down WITHOUT the final snapshot: the journal tail is
    what recovery works with (the journal's close flushes what the OS
    would have written)."""
    eng = client._engine
    j, eng.journal = eng.journal, None
    if j is not None:
        j.close()
    eng.config.snapshot_dir = None
    client.config.snapshot_dir = None
    client.shutdown()


def _pools(client) -> dict:
    """Every pool's elements as bytes, keyed by its size class."""
    eng = client._engine
    eng._drain()
    return {
        tuple(p.spec.key): np.asarray(eng.executor.state_to_host(p)).tobytes()
        for p in eng.registry.pools()
    }


def _workload(c, tail: bool):
    """Every journaled sketch op kind, plus grid writes: the snapshot
    part (tail=False) or the post-snapshot tail (tail=True)."""
    bf = c.get_bloom_filter("bf")
    h = c.get_hyper_log_log("h")
    bs = c.get_bit_set("bs")
    cms = c.get_count_min_sketch("cms")
    if not tail:
        bf.try_init(20_000, 0.01)
        cms.try_init(4, 512)
        bf.add_all(list(range(300)))
        h.add_all(list(range(0, 2000, 3)))
        bs.set_many([1, 7, 300, 4095], True)
        cms.add_all(list(range(64)))
        c.get_atomic_long("ctr").set(5)
        return
    bf.add_all(list(range(10_000, 10_500)))
    h.add_all(list(range(5000, 9000, 7)))
    h2 = c.get_hyper_log_log("h2")
    h2.add_all(list(range(100)))
    h.merge_with("h2")
    bs.set_many([2, 7, 9000], True)
    bs.set_many([1], False)
    bs.flip(3)
    bs.set_range(20, 40)
    bs.clear_range(30, 35)
    other = c.get_bit_set("bs2")
    other.set_many([7, 9, 11], True)
    c._engine.bitset_bitop("bs3", ["bs", "bs2"], "or")
    cms.add_all(list(range(32, 200)))
    cms.add(7, 11)
    cms2 = c.get_count_min_sketch("cms2")
    cms2.try_init(4, 512)
    cms2.add(5, 3)
    cms.merge("cms2")
    c._engine.expire_at("h2", 4_000_000_000.0)
    c._engine.rename("bs2", "bs2r")
    c.get_atomic_long("ctr").increment_and_get()
    c.get_bucket("bk").set(42)


# -- state carried across the packages -------------------------------------------


def _record_zoo():
    rng = np.random.default_rng(5)
    return [
        {"op": "bloom.init", "name": "bf", "ei": 1000, "fp": 0.01},
        {"op": "bloom.addk", "name": "bf",
         "blocks": rng.integers(0, 2**32, (16, 2), dtype=np.uint64).astype(np.uint32),
         "lengths": np.uint32(8)},
        {"op": "bloom.addk", "name": "bf",
         "blocks": rng.integers(0, 2**32, (4, 3), dtype=np.uint64).astype(np.uint32),
         "lengths": np.array([3, 7, 12, 9], np.uint32)},
        {"op": "hll.add", "name": "h",
         "c0": rng.integers(0, 2**32, 9, dtype=np.uint64).astype(np.uint32),
         "c1": rng.integers(0, 2**32, 9, dtype=np.uint64).astype(np.uint32),
         "c2": rng.integers(0, 2**32, 9, dtype=np.uint64).astype(np.uint32)},
        {"op": "hll.addk", "name": "h",
         "blocks": np.arange(8, dtype=np.uint32).reshape(4, 2), "lengths": np.uint32(8)},
        {"op": "hll.merge", "name": "h", "srcs": ["a", "b"]},
        {"op": "bitset.set", "name": "bs", "idx": np.array([1, 5, 9], np.uint32),
         "value": True},
        {"op": "bitset.flip", "name": "bs", "idx": np.array([3], np.uint32)},
        {"op": "bitset.range", "name": "bs", "frm": 4, "to": 90, "value": False},
        {"op": "bitset.bitop", "name": "d", "srcs": ["x", "y"], "bop": "xor"},
        {"op": "cms.init", "name": "c", "depth": 5, "width": 65536},
        {"op": "cms.add", "name": "c",
         "h1": rng.integers(0, 2**63, 6, dtype=np.uint64),
         "h2": rng.integers(0, 2**63, 6, dtype=np.uint64),
         "w": np.arange(1, 7, dtype=np.uint32)},
        {"op": "cms.reset", "name": "c"},
        {"op": "cms.merge", "name": "c", "srcs": ["c2"]},
        {"op": "obj.del", "name": "x"},
        {"op": "obj.rename", "name": "x", "new": "y"},
        {"op": "obj.expire", "name": "y", "at": 1.7e9 + 0.25},
        {"op": "obj.persist", "name": "y"},
        {"op": "obj.restore", "name": "z", "data": b"RTPU\x00\x01\xff", "replace": True},
        {"op": "grid.state", "name": "k", "kind": "bucket",
         "desc": '{"t":"b","v":0}', "expire_at": None, "blobs": b"\x01\x00\x00\x00\x02\x00\x00\x00hi"},
        {"op": "grid.del", "name": "k"},
        {"op": "repl.mark", "name": "", "offset": 17},
    ]


@pytest.mark.parametrize("rec", _record_zoo(), ids=lambda r: r["op"])
def test_encode_record_bytes_equal_across_packages(rec):
    got = port_journal.encode_record(rec)
    assert got == jax_journal.encode_record(rec)
    # And each package decodes the other's bytes to the same record.
    a, b = port_journal.decode_record(got), jax_journal.decode_record(got)
    assert a.keys() == b.keys() == rec.keys()
    for k in rec:
        assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes(), k


def test_segment_files_byte_equal_across_packages(tmp_path):
    """The same records appended through each package's OpJournal leave
    identical segment files."""
    recs = _record_zoo()
    for tag, mod in (("p", port_journal), ("j", jax_journal)):
        j = mod.OpJournal(str(tmp_path / tag), fsync_policy="always", max_segment_bytes=1 << 10)
        for r in recs:
            j.append(r)
        assert j.wait_durable(timeout=30.0)
        j.close()
    names = sorted(os.listdir(tmp_path / "p"))
    assert names == sorted(os.listdir(tmp_path / "j")) and len(names) > 1
    for n in names:
        assert (tmp_path / "p" / n).read_bytes() == (tmp_path / "j" / n).read_bytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_plus_tail_recovers_across_packages(tmp_path, writer):
    """A snapshot plus a journal tail written by one package recovers
    into the other: every pool byte-equal to the writer's own recovery
    of the same directory, the grid keyspace too."""
    src = str(tmp_path / "src")
    make_w = (lambda d: redisson_tpu.create(_jax_cfg(d))) if writer == "jax" \
        else (lambda d: rt.create(_port_cfg(d)))
    make_r = (lambda d: rt.create(_port_cfg(d))) if writer == "jax" \
        else (lambda d: redisson_tpu.create(_jax_cfg(d)))
    c = make_w(src)
    _workload(c, tail=False)
    c._engine.snapshot(c.config.snapshot_dir)
    _workload(c, tail=True)
    assert len(list(c._engine.journal.records_after(0))) > 10
    _crash(c)
    import shutil

    for tag in ("own", "other"):
        shutil.copytree(src, str(tmp_path / tag))
    own = make_w(str(tmp_path / "own"))
    other = make_r(str(tmp_path / "other"))
    try:
        assert other._engine._restored_journal_seq == own._engine._restored_journal_seq > 0
        assert _pools(other) == _pools(own)
        assert sorted(other._engine.registry.names()) == sorted(own._engine.registry.names())
        assert other.get_atomic_long("ctr").get() == 6
        assert other.get_bucket("bk").get() == 42
        assert other._engine.remain_ttl_ms("h2") > 0
    finally:
        _crash(own)
        _crash(other)


def _rows(client) -> dict:
    """Each live object's row bytes (a pool's scratch word and its freed
    rows are not object state)."""
    eng = client._engine
    eng._drain()
    return {
        e.name: np.asarray(eng.executor.read_row(e.pool, e.row)).tobytes()
        for e in eng.registry.entries()
    }


def test_port_records_replay_in_the_jax_package(tmp_path):
    """Records the port journals (keyed Bloom lanes hashed on the card
    live, on the host at replay) rebuild, in the JAX package, the same
    object rows the port's device path wrote: a journal-only recovery."""
    d = str(tmp_path)
    c = rt.create(_port_cfg(d, snap=False))
    _workload(c, tail=False)
    _workload(c, tail=True)
    want = _rows(c)
    _crash(c)
    j = redisson_tpu.create(_jax_cfg(d, snap=False))
    try:
        assert _rows(j) == want
    finally:
        _crash(j)


def test_always_result_acks_after_fsync(tmp_path):
    """The port's form of the reference's
    ``test_always_future_done_tracks_durability``: under ``always`` a
    keyed Bloom add returns a durable gate, and its ack means fsynced."""
    c = rt.create(_port_cfg(str(tmp_path), snap=False, fsync="always"))
    eng = c._engine
    c.get_bloom_filter("bf").try_init(1000, 0.01)
    blocks = np.array([[1, 0, 0, 0], [2, 0, 0, 0]], np.uint32)
    res = eng.bloom_add_encoded("bf", blocks, np.uint32(8))
    assert isinstance(res, _DurableResult)
    res.result()
    assert eng.journal.is_durable(eng.journal.cut())
    recs = [r for _, r in eng.journal.records_after(0)]
    assert recs[-1]["op"] == "bloom.addk"
    np.testing.assert_array_equal(recs[-1]["blocks"], blocks)
    _crash(c)


def test_journal_off_by_default():
    c = rt.create(rt.Config().use_gpu_sketch(device="cpu"))
    try:
        assert c._engine.journal is None and c.config.journal_dir is None
        bf = c.get_bloom_filter("bf")
        bf.try_init(100, 0.01)
        assert not isinstance(c._engine.bloom_add_encoded(
            "bf", np.array([[1, 0, 0, 0]], np.uint32), np.uint32(8)), _DurableResult)
    finally:
        c.shutdown()


def test_broken_journal_refuses_writes(tmp_path):
    """A journal whose fsync fails breaks: later writes raise instead of
    acking without a record (never a silent fall back to no journal)."""
    from redisson_tpu_torch import chaos
    from redisson_tpu_torch.durability import JournalError

    c = rt.create(_port_cfg(str(tmp_path), snap=False, fsync="always"))
    try:
        bf = c.get_bloom_filter("bf")
        bf.try_init(1000, 0.01)
        chaos.inject("journal.fsync", kind="error", rate=1.0)
        with pytest.raises((JournalError, chaos.FaultInjected)):
            bf.add(1)
        chaos.clear()
        with pytest.raises(JournalError):
            bf.add(2)
        assert c._engine.journal.broken is not None
    finally:
        chaos.clear()
        _crash(c)


# -- the RESP persistence surface against the JAX server -------------------------


def _wire(server, cmds):
    from redisson_tpu_torch.serve.wireutil import wire_command

    s = socket.create_connection((server.host, server.port), timeout=10)
    try:
        out = []
        for cmd in cmds:
            s.sendall(wire_command(cmd))
            buf = b""
            s.settimeout(10)
            # One reply frame per command: simple, integer, error or bulk.
            while True:
                buf += s.recv(1 << 16)
                if buf[:1] in (b"+", b"-", b":") and buf.endswith(b"\r\n"):
                    break
                if buf[:1] == b"$" and b"\r\n" in buf:
                    n = int(buf[1:buf.index(b"\r\n")])
                    if n < 0 or len(buf) >= buf.index(b"\r\n") + 2 + n + 2:
                        break
                if buf[:1] == b"*" and buf.endswith(b"\r\n") and buf.count(b"\r\n") >= 5:
                    break
            out.append(buf)
        return out
    finally:
        s.close()


def _strip_volatile(info: bytes) -> bytes:
    """INFO lines whose values are clocks or per-process ids."""
    keep = [ln for ln in info.split(b"\r\n")
            if not ln.startswith((b"rdb_last_save_time", b"aof_fsync_ewma_us",
                                  b"aof_fsyncs", b"master_replid", b"$"))]
    return b"\r\n".join(keep)


@pytest.mark.parametrize("journal", [False, True])
def test_durability_replies_byte_equal_to_jax(tmp_path, journal):
    from redisson_tpu.serve.resp import RespServer as JaxServer
    from redisson_tpu_torch.serve.resp import RespServer as PortServer

    jc = redisson_tpu.create(_jax_cfg(str(tmp_path / "j"), fsync="everysec", journal=journal))
    tc = rt.create(_port_cfg(str(tmp_path / "t"), fsync="everysec", journal=journal))
    js, ts = JaxServer(jc), PortServer(tc)
    try:
        script = [
            [b"CONFIG", b"GET", b"appendonly"],
            [b"CONFIG", b"GET", b"appendfsync"],
            [b"BF.RESERVE", b"bf", b"0.01", b"1000"],
            [b"BF.ADD", b"bf", b"123"],
            [b"SET", b"k", b"v"],
            [b"WAIT", b"0", b"1000"],
            [b"WAIT", b"1", b"50"],
            [b"CONFIG", b"SET", b"appendfsync", b"always"],
            [b"CONFIG", b"GET", b"appendfsync"],
            [b"CONFIG", b"SET", b"appendfsync", b"sometimes"],
            [b"REPLCONF", b"ACK", b"0"],
            [b"FAILOVER"],
        ]
        got_j, got_t = _wire(js, script), _wire(ts, script)
        assert got_t == got_j
        info = [[b"INFO", b"persistence"], [b"INFO", b"replication"]]
        for a, b in zip(_wire(ts, info), _wire(js, info)):
            assert _strip_volatile(a) == _strip_volatile(b)
        rewrite = [[b"BGREWRITEAOF"]]
        assert _wire(ts, rewrite) == _wire(js, rewrite)
    finally:
        ts.close()
        js.close()
        _crash(tc)
        _crash(jc)


@pytest.mark.parametrize("journal", [False, True])
def test_grid_capture_only_while_a_journal_is_attached(tmp_path, journal):
    """A grid record encodes the object's whole state: with the journal
    off no mutation may encode one (a 100,000-entry map would pay O(n)
    per put); attached (at boot or live), mutators journal."""
    c = rt.create(_port_cfg(str(tmp_path), snap=False))
    store = c._grid
    calls = []
    enc = store._enc_entry
    store._enc_entry = lambda *a: calls.append(a[0]) or enc(*a)
    try:
        if not journal:
            c._engine.journal_set_enabled(False)
        m = c.get_map("m")
        m.put_all({i: i for i in range(100)})
        m.put(1, -1)
        c.get_queue("q").offer(1)
        assert (len(calls) > 0) == journal
        n = len(calls)
        c._engine.journal_set_enabled(not journal)
        m.put(2, -2)
        assert (len(calls) > n) == (not journal)
    finally:
        _crash(c)


def test_mixed_add_contains_call_journals_its_adds(tmp_path):
    """A fused add/contains run journals exactly its ADD subset, and the
    recovered row equals the live one."""
    c = rt.create(_port_cfg(str(tmp_path), snap=False))
    eng = c._engine
    c.get_bloom_filter("bf").try_init(10_000, 0.01)
    blocks = np.arange(64, dtype=np.uint32).reshape(16, 4)
    flags = np.arange(16) % 3 == 0
    np.asarray(eng.bloom_mixed_encoded("bf", blocks, np.uint32(16), flags).result())
    rec = [r for _, r in eng.journal.records_after(0)][-1]
    assert rec["op"] == "bloom.addk"
    np.testing.assert_array_equal(rec["blocks"], blocks[flags])
    want = _rows(c)
    _crash(c)
    c = rt.create(_port_cfg(str(tmp_path), snap=False))
    try:
        assert _rows(c) == want
    finally:
        _crash(c)
