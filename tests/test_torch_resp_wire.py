"""The port's RESP front door against the JAX package's, byte for byte.

The fixture table of ``tests/test_resp_wire_fixtures.py`` restricted to
the families the port serves (connection, strings, counters, keyspace,
bitmaps, HLL, Bloom, CMS, Top-K, transactions), extended with more
commands of those families, runs as ONE session against a JAX
``RespServer`` (CPU backend) and a port ``RespServer``
(``device="cpu"``): every reply must equal the JAX server's bytes, and
the literal Redis reply where the table gives one.  TTL-valued replies
are compared by range.  A command of a family the port does not carry
yet gets exactly the reply the JAX server gives a command it lacks.

Also here: the admin surfaces earlier slices left for the front door —
``INFO nearcache`` and ``CONFIG SET nearcache*`` (tests/test_nearcache.py
``TestRespSurface``), OBJECT FREQ/IDLETIME/ENCODING, ``DEBUG RESIDENCY``
and ``CONFIG SET residency-*`` (tests/test_residency.py), and the
degraded flag with ``DEBUG INJECT`` and its loopback/requirepass gate
(tests/test_chaos.py ``TestDegradedServe``).
"""

import socket
import time

import pytest

torch = pytest.importorskip("torch")

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
from redisson_tpu.serve.resp import RespServer as JaxRespServer  # noqa: E402
from redisson_tpu_torch import chaos  # noqa: E402
from redisson_tpu_torch.serve.resp import RespError, RespServer  # noqa: E402
from redisson_tpu_torch.serve.wireutil import (  # noqa: E402
    ReplyError,
    exchange,
    skip_reply_frame,
    wire_command,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_pair():
    c = redisson_tpu.create(redisson_tpu.Config().use_tpu_sketch(min_bucket=64))
    return c, JaxRespServer(c)


def _port_pair(**kw):
    kw.setdefault("min_bucket", 64)
    c = rt.create(rt.Config().use_gpu_sketch(device="cpu", **kw))
    return c, RespServer(c)


@pytest.fixture(scope="module")
def servers():
    jc, js = _jax_pair()
    tc, ts = _port_pair()
    yield js, ts
    ts.close()
    tc.shutdown()
    js.close()
    jc.shutdown()


def _read_frames(sock, n, timeout=30.0):
    sock.settimeout(timeout)
    buf, out, pos = b"", [], 0
    deadline = time.monotonic() + timeout
    while len(out) < n:
        try:
            while len(out) < n:
                end = skip_reply_frame(buf, pos)
                out.append(buf[pos:end])
                pos = end
        except (IndexError, ValueError):
            pass
        if len(out) >= n:
            break
        assert time.monotonic() < deadline, f"timeout at {len(out)}/{n}"
        chunk = sock.recv(1 << 16)
        assert chunk, f"connection closed at {len(out)}/{n}"
        buf += chunk
    return out


def _ttl(lo, hi):
    return ("ttl", lo, hi)


# (request argv, expected reply): bytes = the literal reply; None = equal
# to the JAX server's bytes only; ("ttl", lo, hi) = an integer reply in
# [lo, hi] on both; ("prefix", b"-CODE") = both start with the code.
FIXTURES = [
    # connection
    ([b"PING"], b"+PONG\r\n"),
    ([b"PING", b"hello"], b"$5\r\nhello\r\n"),
    ([b"ECHO", b"abc"], b"$3\r\nabc\r\n"),
    ([b"SELECT", b"0"], b"+OK\r\n"),
    ([b"SELECT", b"1"], ("prefix", b"-ERR")),
    ([b"CLIENT", b"SETNAME", b"wire"], b"+OK\r\n"),
    ([b"CLIENT", b"GETNAME"], b"$4\r\nwire\r\n"),
    ([b"CLIENT", b"SETINFO", b"lib-name", b"x"], b"+OK\r\n"),
    ([b"COMMAND"], b"*0\r\n"),
    ([b"HELLO", b"2"], None),
    ([b"AUTH", b"pw"], None),
    # strings
    ([b"SET", b"k", b"value"], b"+OK\r\n"),
    ([b"GET", b"k"], b"$5\r\nvalue\r\n"),
    ([b"GET", b"missing"], b"$-1\r\n"),
    ([b"EXISTS", b"k"], b":1\r\n"),
    ([b"STRLEN", b"k"], b":5\r\n"),
    ([b"APPEND", b"k", b"x"], b":6\r\n"),
    ([b"GETRANGE", b"k", b"0", b"-1"], b"$6\r\nvaluex\r\n"),
    ([b"GETRANGE", b"k", b"-3", b"-2"], b"$2\r\nue\r\n"),
    ([b"SETRANGE", b"k", b"8", b"yz"], b":10\r\n"),
    ([b"GET", b"k"], b"$10\r\nvaluex\x00\x00yz\r\n"),
    ([b"TYPE", b"k"], b"+string\r\n"),
    ([b"MSET", b"m1", b"a", b"m2", b"b"], b"+OK\r\n"),
    ([b"MGET", b"m1", b"nope", b"m2"], b"*3\r\n$1\r\na\r\n$-1\r\n$1\r\nb\r\n"),
    ([b"SETNX", b"m1", b"zz"], b":0\r\n"),
    ([b"SETNX", b"m3", b"c"], b":1\r\n"),
    ([b"GETSET", b"m3", b"d"], b"$1\r\nc\r\n"),
    ([b"GETDEL", b"m3"], b"$1\r\nd\r\n"),
    ([b"GETDEL", b"m3"], b"$-1\r\n"),
    ([b"SETEX", b"ex", b"100", b"v"], b"+OK\r\n"),
    ([b"TTL", b"ex"], _ttl(98, 100)),
    ([b"PSETEX", b"pex", b"100000", b"v"], b"+OK\r\n"),
    ([b"PTTL", b"pex"], _ttl(98_000, 100_000)),
    ([b"GETEX", b"pex", b"PERSIST"], b"$1\r\nv\r\n"),
    ([b"TTL", b"pex"], b":-1\r\n"),
    ([b"GETEX", b"pex", b"EX", b"50"], b"$1\r\nv\r\n"),
    ([b"TTL", b"pex"], _ttl(48, 50)),
    ([b"SET", b"opt", b"v", b"PX", b"90000"], b"+OK\r\n"),
    ([b"PTTL", b"opt"], _ttl(88_000, 90_000)),
    ([b"SET", b"opt", b"v", b"NX"], ("prefix", b"-ERR")),
    ([b"DEL", b"k"], b":1\r\n"),
    ([b"DEL", b"k"], b":0\r\n"),
    # counters
    ([b"INCR", b"ctr"], b":1\r\n"),
    ([b"INCRBY", b"ctr", b"41"], b":42\r\n"),
    ([b"DECR", b"ctr"], b":41\r\n"),
    ([b"GET", b"ctr"], b"$2\r\n41\r\n"),
    ([b"INCRBYFLOAT", b"ctr", b"0.5"], b"$4\r\n41.5\r\n"),
    ([b"INCR", b"ctr"], ("prefix", b"-ERR")),
    ([b"SET", b"word", b"abc"], b"+OK\r\n"),
    ([b"INCR", b"word"], ("prefix", b"-ERR")),
    ([b"INCRBYFLOAT", b"word", b"1"], ("prefix", b"-ERR")),
    # expiry and keyspace
    ([b"SET", b"ek", b"v"], b"+OK\r\n"),
    ([b"EXPIRE", b"ek", b"100"], b":1\r\n"),
    ([b"TTL", b"ek"], _ttl(98, 100)),
    ([b"PERSIST", b"ek"], b":1\r\n"),
    ([b"PERSIST", b"ek"], b":0\r\n"),
    ([b"TTL", b"ek"], b":-1\r\n"),
    ([b"TTL", b"ghost"], b":-2\r\n"),
    ([b"PEXPIRE", b"ek", b"100000"], b":1\r\n"),
    ([b"PTTL", b"ek"], _ttl(98_000, 100_000)),
    ([b"EXPIRE", b"ghost", b"10"], b":0\r\n"),
    ([b"RENAME", b"ek", b"ek2"], b"+OK\r\n"),
    ([b"EXISTS", b"ek", b"ek2", b"ek2"], b":2\r\n"),
    ([b"RENAMENX", b"ek2", b"m1"], b":0\r\n"),
    ([b"RENAMENX", b"ek2", b"ek3"], b":1\r\n"),
    ([b"RENAME", b"ghost", b"x"], ("prefix", b"-ERR")),
    ([b"COPY", b"m1", b"m1c"], b":1\r\n"),
    ([b"COPY", b"m1", b"m1c"], b":0\r\n"),
    ([b"GET", b"m1c"], b"$1\r\na\r\n"),
    ([b"DUMP", b"m1"], b"$6\r\nRTPS\x00a\r\n"),
    ([b"RESTORE", b"m1r", b"0", b"RTPS\x00a"], b"+OK\r\n"),
    ([b"RESTORE", b"m1r", b"0", b"RTPS\x00a"], ("prefix", b"-BUSYKEY")),
    ([b"GET", b"m1r"], b"$1\r\na\r\n"),
    ([b"DUMP", b"ghost"], b"$-1\r\n"),
    # bitmaps
    ([b"SETBIT", b"bm", b"7", b"1"], b":0\r\n"),
    ([b"SETBIT", b"bm", b"7", b"1"], b":1\r\n"),
    ([b"GETBIT", b"bm", b"7"], b":1\r\n"),
    ([b"GETBIT", b"bm", b"100000"], b":0\r\n"),
    ([b"SETBIT", b"bm", b"3", b"1"], b":0\r\n"),
    ([b"BITCOUNT", b"bm"], b":2\r\n"),
    ([b"BITPOS", b"bm", b"1"], b":3\r\n"),
    ([b"BITPOS", b"bm", b"0"], b":0\r\n"),
    ([b"BITCOUNT", b"bm", b"0", b"1"], ("prefix", b"-ERR")),
    ([b"TYPE", b"bm"], b"+string\r\n"),
    # HyperLogLog
    ([b"PFADD", b"h1", b"a", b"b", b"c"], b":1\r\n"),
    ([b"PFADD", b"h1", b"a"], b":0\r\n"),
    ([b"PFCOUNT", b"h1"], b":3\r\n"),
    ([b"PFADD", b"h2", b"c", b"d"], b":1\r\n"),
    ([b"PFCOUNT", b"h1", b"h2"], b":4\r\n"),
    ([b"PFMERGE", b"h3", b"h1", b"h2"], b"+OK\r\n"),
    ([b"PFCOUNT", b"h3"], b":4\r\n"),
    # Bloom
    ([b"BF.RESERVE", b"bf", b"0.01", b"1000"], b"+OK\r\n"),
    ([b"BF.RESERVE", b"bf", b"0.01", b"1000"], ("prefix", b"-ERR")),
    ([b"BF.ADD", b"bf", b"a"], b":1\r\n"),
    ([b"BF.ADD", b"bf", b"a"], b":0\r\n"),
    ([b"BF.EXISTS", b"bf", b"a"], b":1\r\n"),
    ([b"BF.EXISTS", b"bf", b"zz"], b":0\r\n"),
    ([b"BF.MADD", b"bf", b"b", b"a", b"c"], b"*3\r\n:1\r\n:0\r\n:1\r\n"),
    ([b"BF.MEXISTS", b"bf", b"a", b"b", b"q"], b"*3\r\n:1\r\n:1\r\n:0\r\n"),
    ([b"BF.INFO", b"bf"], None),
    ([b"TYPE", b"bf"], b"+MBbloom--\r\n"),
    ([b"BF.ADD", b"nobf", b"a"], ("prefix", b"-ERR")),
    ([b"DUMP", b"bf"], None),
    # Count-min sketch
    ([b"CMS.INITBYDIM", b"cm", b"512", b"4"], b"+OK\r\n"),
    ([b"CMS.INCRBY", b"cm", b"x", b"3", b"y", b"2"], b"*2\r\n:3\r\n:2\r\n"),
    ([b"CMS.QUERY", b"cm", b"x", b"y", b"q"], b"*3\r\n:3\r\n:2\r\n:0\r\n"),
    ([b"CMS.INFO", b"cm"], None),
    ([b"CMS.INITBYDIM", b"cm2", b"512", b"4"], b"+OK\r\n"),
    ([b"CMS.INCRBY", b"cm2", b"x", b"5"], b"*1\r\n:5\r\n"),
    ([b"CMS.MERGE", b"cm3", b"2", b"cm", b"cm2"], None),
    ([b"CMS.INITBYDIM", b"cm3", b"512", b"4"], b"+OK\r\n"),
    ([b"CMS.MERGE", b"cm3", b"2", b"cm", b"cm2"], b"+OK\r\n"),
    ([b"CMS.QUERY", b"cm3", b"x", b"y"], b"*2\r\n:8\r\n:2\r\n"),
    ([b"TYPE", b"cm"], b"+CMSk-TYPE\r\n"),
    # Top-K
    ([b"TOPK.RESERVE", b"tk", b"2"], b"+OK\r\n"),
    ([b"TOPK.ADD", b"tk", b"a", b"b", b"a", b"c", b"a", b"b"],
     b"*6\r\n$-1\r\n$-1\r\n$-1\r\n$-1\r\n$-1\r\n$-1\r\n"),
    ([b"TOPK.INCRBY", b"tk", b"c", b"1"], b"*1\r\n$-1\r\n"),
    ([b"TOPK.LIST", b"tk"], None),
    ([b"TOPK.LIST", b"tk", b"WITHCOUNT"], None),
    ([b"TOPK.QUERY", b"tk", b"a", b"z"], b"*2\r\n:1\r\n:0\r\n"),
    ([b"TOPK.COUNT", b"tk", b"a", b"b"], b"*2\r\n:3\r\n:2\r\n"),
    ([b"TOPK.INFO", b"tk"], None),
    # cross-backend WRONGTYPE: one keyspace over the grid and the sketches
    ([b"GET", b"bf"], None),
    ([b"BF.RESERVE", b"m1", b"0.01", b"100"], ("prefix", b"-WRONGTYPE")),
    ([b"SETBIT", b"m1", b"1", b"1"], ("prefix", b"-WRONGTYPE")),
    ([b"PFADD", b"bf", b"x"], ("prefix", b"-WRONGTYPE")),
    ([b"SET", b"bf", b"v"], ("prefix", b"-WRONGTYPE")),
    # keyspace views across both backends
    ([b"KEYS", b"h*"], None),
    ([b"DBSIZE"], None),
    ([b"SCAN", b"0", b"MATCH", b"m*", b"COUNT", b"100"], None),
    ([b"RENAME", b"h3", b"h4"], b"+OK\r\n"),
    ([b"PFCOUNT", b"h4"], b":4\r\n"),
    ([b"DEL", b"h4", b"m1", b"nothing"], b":2\r\n"),
    # transactions
    ([b"MULTI"], b"+OK\r\n"),
    ([b"SET", b"tk1", b"1"], b"+QUEUED\r\n"),
    ([b"INCR", b"tk1"], b"+QUEUED\r\n"),
    ([b"BF.ADD", b"bf", b"t"], b"+QUEUED\r\n"),
    ([b"EXEC"], b"*3\r\n+OK\r\n:2\r\n:1\r\n"),
    ([b"EXEC"], ("prefix", b"-ERR")),
    ([b"MULTI"], b"+OK\r\n"),
    ([b"NOSUCHCMD"], ("prefix", b"-ERR unknown command")),
    ([b"EXEC"], ("prefix", b"-EXECABORT")),
    ([b"MULTI"], b"+OK\r\n"),
    ([b"DISCARD"], b"+OK\r\n"),
    # persistence admin without a snapshot directory
    ([b"LASTSAVE"], b":0\r\n"),
    ([b"SAVE"], ("prefix", b"-ERR")),
    ([b"FLUSHALL"], b"+OK\r\n"),
    ([b"DBSIZE"], b":0\r\n"),
]

# Families the port does not carry yet: each must answer exactly as the
# JAX server answers a command it lacks.
WAITING = [
    [b"LPUSH", b"l", b"a"], [b"HSET", b"h", b"f", b"v"],
    [b"SADD", b"s", b"a"], [b"ZADD", b"z", b"1", b"m"],
    [b"XADD", b"st", b"*", b"f", b"v"], [b"GEOADD", b"g", b"1", b"2", b"m"],
    [b"BLPOP", b"l", b"1"], [b"SUBSCRIBE", b"ch"], [b"PUBLISH", b"ch", b"m"],
    [b"EVAL", b"return 1", b"0"], [b"FUNCTION", b"LIST"],
    [b"CLUSTER", b"INFO"], [b"WAIT", b"0", b"0"], [b"SLOWLOG", b"GET"],
    [b"MONITOR"], [b"BGREWRITEAOF"], [b"REPLCONF", b"ACK", b"0"],
]


def _session(server, cmds):
    s = socket.create_connection((server.host, server.port))
    try:
        out = []
        for c in cmds:
            s.sendall(wire_command(c))
            out.append(_read_frames(s, 1)[0])
        return out
    finally:
        s.close()


def _int_reply(frame):
    assert frame[:1] == b":", frame
    return int(frame[1:-2])


def test_wire_fixtures_byte_exact_on_both_servers(servers):
    js, ts = servers
    cmds = [c for c, _ in FIXTURES]
    got_j = _session(js, cmds)
    got_t = _session(ts, cmds)
    diff = [(c, t, j) for (c, w), j, t in zip(FIXTURES, got_j, got_t)
            if t != j and not (isinstance(w, tuple) and w[0] == "ttl")]
    assert not diff, diff
    for (cmd, want), j, t in zip(FIXTURES, got_j, got_t):
        if isinstance(want, tuple) and want[0] == "ttl":
            for frame in (j, t):
                assert want[1] <= _int_reply(frame) <= want[2], (cmd, frame)
            continue
        if isinstance(want, tuple):  # ("prefix", b"-CODE")
            assert j.startswith(want[1]), (cmd, j)
            assert t.startswith(want[1]), (cmd, t)
            if not want[1].startswith(b"-ERR unknown"):
                assert t == j, (cmd, t, j)
            continue
        assert t == j, (cmd, t, j)
        if want is not None:
            assert t == want, (cmd, t, want)


def test_waiting_families_answer_as_unknown_commands(servers):
    """A command the port lacks gets the byte-identical reply the JAX
    server gives a command IT lacks: the same encoder, the same text."""
    js, ts = servers
    got = _session(ts, WAITING)
    for cmd, frame in zip(WAITING, got):
        name = cmd[0].decode().upper()
        assert frame == b"-ERR unknown command '%s'\r\n" % name.encode()
        j = _session(js, [[b"NO" + cmd[0]] + cmd[1:]])[0]
        assert j == b"-ERR unknown command 'NO%s'\r\n" % name.encode()
    # A lacking command queued under MULTI poisons the transaction on
    # both servers alike.
    txn = [[b"MULTI"], [b"NOSUCHCMD", b"x"], [b"EXEC"]]
    assert _session(ts, txn) == _session(js, txn)


def test_inline_command_fixture(servers):
    """redis-cli's fallback inline protocol (no RESP framing)."""
    for server in servers:
        s = socket.create_connection((server.host, server.port), timeout=5)
        try:
            for line, want in ((b"PING\r\n", b"+PONG\r\n"),
                               (b"SET ik iv\r\n", b"+OK\r\n"),
                               (b"GET ik\r\n", b"$2\r\niv\r\n")):
                s.sendall(line)
                assert _read_frames(s, 1)[0] == want
        finally:
            s.close()


def test_pipelined_fixture_single_write(servers):
    """A stock client's pipeline: N requests in one write, N replies in
    order — byte-exact concatenation, equal on both servers."""
    payload = (
        b"*3\r\n$3\r\nSET\r\n$1\r\np\r\n$1\r\n1\r\n"
        b"*2\r\n$4\r\nINCR\r\n$1\r\np\r\n"
        b"*2\r\n$3\r\nGET\r\n$1\r\np\r\n"
    )
    for server in servers:
        s = socket.create_connection((server.host, server.port), timeout=5)
        try:
            s.sendall(payload)
            assert b"".join(_read_frames(s, 3)) == b"+OK\r\n:2\r\n$1\r\n2\r\n"
        finally:
            s.close()


def test_resp3_hello_and_auth_flow():
    """HELLO 3 answers a map on both servers; a requirepass server
    refuses before AUTH and accepts after, with identical bytes."""
    jc, js = _jax_pair()
    tc, ts = _port_pair()
    try:
        for srv in (js, ts):
            srv._requirepass = "pw"
        cmds = [[b"GET", b"x"], [b"AUTH", b"bad"], [b"HELLO", b"2"],
                [b"AUTH", b"pw"], [b"SET", b"x", b"1"], [b"GET", b"x"],
                [b"HELLO", b"2", b"AUTH", b"default", b"pw"]]
        got = []
        for srv in (js, ts):
            s = socket.create_connection((srv.host, srv.port))
            try:
                out = []
                for c in cmds:
                    s.sendall(wire_command(c))
                    out.append(_read_frames(s, 1)[0])
                s.sendall(wire_command([b"HELLO", b"3"]))
                s.settimeout(5)
                time.sleep(0.2)
                out.append(s.recv(1 << 16))
                got.append(out)
            finally:
                s.close()
        assert got[0] == got[1]
        assert got[1][0].startswith(b"-NOAUTH")
        assert got[1][1].startswith(b"-WRONGPASS")
        assert got[1][-1].startswith(b"%7\r\n")
    finally:
        ts.close()
        tc.shutdown()
        js.close()
        jc.shutdown()


# -- admin surfaces of the near cache, the residency ladder and chaos ---------


def _port_client(tmp_path=None, **kw):
    kw.setdefault("min_bucket", 64)
    kw.setdefault("batch_window_us", 100)
    if tmp_path is not None:
        kw.setdefault("residency_dir", str(tmp_path))
    return rt.create(rt.Config().use_gpu_sketch(device="cpu", **kw))


def _resp(cl):
    srv = RespServer(cl)
    s = socket.create_connection((srv.host, srv.port))

    def cmd(*args):
        return exchange(s, [[str(a).encode() for a in args]])[0]

    return srv, s, cmd


class TestNearCacheRespSurface:
    def test_info_section_and_live_config_set(self):
        c = _port_client()
        server = RespServer(c, host="127.0.0.1", port=0)
        try:
            bf = c.get_bloom_filter("resp-bf")
            bf.try_init(10_000, 0.01)
            bf.add("x")
            bf.contains("x")
            bf.contains("x")
            info = server._cmd_INFO([b"nearcache"]).decode()
            assert "# Nearcache" in info
            assert "nearcache_enabled:1" in info
            assert "nearcache_hits:" in info
            out = server._cmd_CONFIG([b"GET", b"nearcache*"]).decode()
            assert "nearcache-max-bytes" in out
            # Live retune: byte budget + disable (drops every entry).
            server._cmd_CONFIG([b"SET", b"nearcache-max-bytes", b"1048576"])
            nc = c._engine.nearcache
            assert nc.store.max_bytes == 1 << 20
            server._cmd_CONFIG([b"SET", b"nearcache", b"no"])
            assert nc.enabled is False and nc.store.entries() == 0
            info = server._cmd_INFO([b"nearcache"]).decode()
            assert "nearcache_enabled:0" in info
            server._cmd_CONFIG([b"SET", b"nearcache", b"yes"])
            assert nc.enabled is True
            with pytest.raises(RespError):
                server._cmd_CONFIG([b"SET", b"nearcache", b"maybe"])
            with pytest.raises(RespError):
                server._cmd_CONFIG([b"SET", b"nearcache-max-batch", b"0"])
        finally:
            server.close()
            c.shutdown()


class _FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class TestResidencyRespSurface:
    def test_object_introspection_rides_the_heat_tracker(self, tmp_path):
        from redisson_tpu_torch.storage.heat import HeatTracker

        cl = _port_client(tmp_path)
        srv = s = None
        try:
            rm = cl._engine.residency
            clk = _FakeClock()
            rm.heat = HeatTracker(half_life_s=10.0, clock=clk)
            srv, s, cmd = _resp(cl)
            cmd("BF.RESERVE", "bf", "0.01", "1000")
            for _ in range(6):
                cmd("BF.ADD", "bf", "1")
            assert cmd("OBJECT", "ENCODING", "bf") == b"device"
            # FREQ is the redis 0-255 LOGARITHMIC LFU scale over the
            # decayed heat h: min(255, round(32*log2(1+h))).
            hot_freq = cmd("OBJECT", "FREQ", "bf")
            assert 64 <= hot_freq <= 255
            clk.t += 30.0  # fake clock, no sleep
            assert cmd("OBJECT", "IDLETIME", "bf") == 30
            cold_freq = cmd("OBJECT", "FREQ", "bf")
            assert cold_freq < hot_freq and cold_freq <= 32
            assert cmd("DEBUG", "RESIDENCY", "DEMOTE", "bf") == 1
            assert cmd("OBJECT", "ENCODING", "bf") == b"host"
            assert cmd("DEBUG", "RESIDENCY", "SPILL", "bf") == 1
            assert cmd("OBJECT", "ENCODING", "bf") == b"disk"
            assert cmd("DEBUG", "RESIDENCY", "LOAD", "bf") == 1
            assert cmd("OBJECT", "ENCODING", "bf") == b"host"
            assert cmd("DEBUG", "RESIDENCY", "PROMOTE", "bf") == 1
            assert cmd("OBJECT", "ENCODING", "bf") == b"device"
            assert cmd("BF.EXISTS", "bf", "1") == 1
            # Grid kinds keep the classic encodings.
            cmd("SET", "str", "v")
            assert cmd("OBJECT", "ENCODING", "str") == b"embstr"
            assert cmd("OBJECT", "FREQ", "str") == 0
            assert isinstance(cmd("OBJECT", "ENCODING", "ghost"), ReplyError)
        finally:
            if s is not None:
                s.close()
                srv.close()
            cl.shutdown()

    def test_resp_config_and_info_surface(self, tmp_path):
        cl = _port_client(tmp_path)
        srv = s = None
        try:
            srv, s, cmd = _resp(cl)
            got = dict(zip(*[iter(cmd("CONFIG", "GET", "residency-*"))] * 2))
            assert got[b"residency-device-rows"] == b"0"
            assert cmd("CONFIG", "SET", "residency-device-rows", "8") == b"OK"
            assert cl._engine.residency.device_rows == 8
            assert cl._engine.residency._thread is not None  # budget armed it
            bad = cmd("CONFIG", "SET", "residency-max-host-bytes", "-3")
            assert isinstance(bad, ReplyError)
            bad = cmd("CONFIG", "SET", "residency-device-rows", "x")
            assert isinstance(bad, ReplyError)
            info = cmd("INFO", "memory").decode()
            for line in ("residency_device_rows_budget:8",
                         "residency_host_objects:", "residency_disk_bytes:",
                         "residency_promotions:"):
                assert line in info, line
            tick = cmd("DEBUG", "RESIDENCY", "TICK")
            assert any(r.startswith(b"reclaimed") for r in tick)
        finally:
            if s is not None:
                s.close()
                srv.close()
            cl.shutdown()

    def test_object_is_shed_exempt(self):
        from redisson_tpu_torch.serve.resp import _SHED_EXEMPT

        assert "OBJECT" in _SHED_EXEMPT


BLOOM_POINTS = (
    "dispatch.bloom_mixed", "dispatch.bloom_mixed_keys",
    "dispatch.bloom_mixed_keys_runs",
)


def _await(cond, timeout=8.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.02)
    return True


class TestDegradedServe:
    def test_degraded_flag_in_info_and_debug_inject(self):
        c = _port_client(breaker_failure_threshold=1, breaker_open_ms=60_000)
        c.config.retry_attempts = 2
        c.config.retry_interval_ms = 5
        eng = c._engine
        server = RespServer(c, host="127.0.0.1", port=0)
        s = socket.create_connection((server.host, server.port))
        try:
            def cmd(*parts):
                return exchange(s, [[str(p).encode() for p in parts]])[0]

            # DEBUG INJECT arms a rule; LIST shows it; OFF clears.
            assert cmd("DEBUG", "INJECT", "dispatch.bloom_mixed", "error",
                       "1.0", "7") == b"OK"
            assert chaos.active() == {
                "dispatch.bloom_mixed": ("error", 1.0, 7)
            }
            assert cmd("DEBUG", "INJECT", "LIST") == [
                b"dispatch.bloom_mixed error 1 seed=7"
            ]
            info = cmd("INFO", "stats").decode()
            assert "degraded:0" in info
            assert "breakers_open:0" in info
            assert cmd("DEBUG", "INJECT", "OFF") == b"OK"
            assert chaos.active() == {}
            # Degrade for real and read the flag back through INFO.
            chaos.install(chaos.ChaosSchedule(seed=2, rate=1.0, points=BLOOM_POINTS))
            bf = c.get_bloom_filter("info-bf")
            bf.try_init(1000, 0.01)
            for i in range(4):
                try:
                    bf.add(f"x{i}")
                except Exception:
                    pass
                if eng.health.any_degraded:
                    break
            assert _await(lambda: eng.health.any_degraded)
            assert bf.add("seed-mirror") is True  # lazily seeds the mirror
            info = cmd("INFO", "stats").decode()
            assert "degraded:1" in info
            assert "degraded_objects:1" in info
        finally:
            chaos.clear()
            s.close()
            server.close()
            c.shutdown()

    def test_debug_inject_gated_like_scripting(self):
        c = _port_client()
        server = RespServer(c, host="127.0.0.1", port=0)
        try:
            # Simulate a non-loopback unauthenticated bind.
            server._inject_allowed = False
            with pytest.raises(RespError, match="requirepass"):
                server._cmd_DEBUG([b"INJECT", b"dispatch", b"error", b"1"])
            with pytest.raises(RespError, match="requirepass"):
                server._cmd_DEBUG([b"RESIDENCY", b"TICK"])
            # Loopback (the real bind here) allows it.
            server._inject_allowed = True
            server._cmd_DEBUG([b"INJECT", b"OFF"])
        finally:
            server.close()
            c.shutdown()


def test_scripting_switch_refused_on_an_open_bind():
    """As in the JAX package: enable_python_scripts on a non-loopback
    bind without requirepass refuses to start; on loopback it starts
    (scripting itself answers as an unknown command)."""
    c = _port_client()
    try:
        c.config.set_enable_python_scripts(True)
        with pytest.raises(ValueError, match="requirepass"):
            RespServer(c, host="0.0.0.0")
        srv = RespServer(c)
        try:
            s = socket.create_connection((srv.host, srv.port))
            assert exchange(s, [[b"EVAL", b"return 1", b"0"]])[0].code == "ERR"
            s.close()
        finally:
            srv.close()
    finally:
        c.shutdown()
