"""The port's RESP front door against the JAX package's, byte for byte.

The fixture table of ``tests/test_resp_wire_fixtures.py`` (connection,
strings, counters, keyspace, bitmaps, HLL, Bloom, CMS, Top-K,
transactions; then lists, hashes, sets, sorted sets with the SCAN family
and the STORE commands, streams with a consumer group, geo and WRONGTYPE
across the families), extended with more commands of each family, runs
as sessions against a JAX ``RespServer`` (CPU backend) and a port
``RespServer`` (``device="cpu"``): every reply must equal the JAX
server's bytes, and the literal Redis reply where the table gives one.
TTL-valued replies are compared by range; replies of the random commands
(HRANDFIELD, SRANDMEMBER, ZRANDMEMBER) and of XPENDING's idle times by
shape.  Pub/sub runs across two connections on both servers.  A command
of a family the port does not carry yet (scripting, cluster, replication,
the telemetry verbs) gets exactly the reply the JAX server gives a
command it lacks.  The family tests of ``tests/test_resp_scan_family.py``
and the stream/geo half of ``tests/test_resp_streams_geo_script.py`` run
on a port server.

Also here: the admin surfaces earlier slices left for the front door —
``INFO nearcache`` and ``CONFIG SET nearcache*`` (tests/test_nearcache.py
``TestRespSurface``), OBJECT FREQ/IDLETIME/ENCODING, ``DEBUG RESIDENCY``
and ``CONFIG SET residency-*`` (tests/test_residency.py), and the
degraded flag with ``DEBUG INJECT`` and its loopback/requirepass gate
(tests/test_chaos.py ``TestDegradedServe``).
"""

import socket
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
import test_resp_scan_family as _ref_scan  # noqa: E402
import test_resp_streams_geo_script as _ref_sg  # noqa: E402
from test_resp_server import RespClient  # noqa: E402
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

# The grid families: lists, hashes, sets, sorted sets (SCAN family, STORE
# commands), streams with a consumer group, geo, and WRONGTYPE between a
# Bloom key and a list key.  ("shape", prefix) = both replies start with
# the prefix (random picks, idle times).  Stream ids are explicit: XADD *
# ids are milliseconds of the wall clock.
GRID = [
    # the literal pairs of tests/test_resp_wire_fixtures.py
    ([b"RPUSH", b"l", b"a", b"b"], b":2\r\n"),
    ([b"LPUSH", b"l", b"z"], b":3\r\n"),
    ([b"LRANGE", b"l", b"0", b"-1"], b"*3\r\n$1\r\nz\r\n$1\r\na\r\n$1\r\nb\r\n"),
    ([b"LPOP", b"l"], b"$1\r\nz\r\n"),
    ([b"LLEN", b"l"], b":2\r\n"),
    ([b"HSET", b"h", b"f1", b"v1"], b":1\r\n"),
    ([b"HGET", b"h", b"f1"], b"$2\r\nv1\r\n"),
    ([b"HEXISTS", b"h", b"f1"], b":1\r\n"),
    ([b"HLEN", b"h"], b":1\r\n"),
    ([b"SADD", b"s", b"a", b"b"], b":2\r\n"),
    ([b"SISMEMBER", b"s", b"a"], b":1\r\n"),
    ([b"SISMEMBER", b"s", b"q"], b":0\r\n"),
    ([b"SCARD", b"s"], b":2\r\n"),
    ([b"ZADD", b"z", b"1.5", b"m"], b":1\r\n"),
    ([b"ZSCORE", b"z", b"m"], b"$3\r\n1.5\r\n"),
    ([b"ZCARD", b"z"], b":1\r\n"),
    ([b"HSET", b"s", b"f"], ("prefix", b"-ERR")),
    ([b"LPOP", b"h"], ("prefix", b"-WRONGTYPE")),
    # lists
    ([b"RPUSH", b"l", b"c", b"a", b"d"], b":5\r\n"),
    ([b"LINDEX", b"l", b"-1"], b"$1\r\nd\r\n"),
    ([b"LINDEX", b"l", b"99"], b"$-1\r\n"),
    ([b"LSET", b"l", b"1", b"B"], b"+OK\r\n"),
    ([b"LSET", b"l", b"99", b"B"], ("prefix", b"-ERR")),
    ([b"LPOS", b"l", b"a"], b":0\r\n"),
    ([b"LPOS", b"l", b"a", b"RANK", b"2"], b":3\r\n"),
    ([b"LPOS", b"l", b"a", b"COUNT", b"0"], b"*2\r\n:0\r\n:3\r\n"),
    ([b"LREM", b"l", b"1", b"a"], b":1\r\n"),
    ([b"LRANGE", b"l", b"0", b"-1"], None),
    ([b"LTRIM", b"l", b"0", b"2"], b"+OK\r\n"),
    ([b"LPUSHX", b"l", b"x"], b":4\r\n"),
    ([b"RPUSHX", b"nolist", b"x"], b":0\r\n"),
    ([b"RPOPLPUSH", b"l", b"l2"], None),
    ([b"LMOVE", b"l", b"l2", b"LEFT", b"RIGHT"], None),
    ([b"LRANGE", b"l2", b"0", b"-1"], None),
    ([b"RPOP", b"l"], None),
    ([b"RPOP", b"ghostlist"], b"$-1\r\n"),
    ([b"BLPOP", b"l2", b"1"], b"*2\r\n$2\r\nl2\r\n$1\r\na\r\n"),
    ([b"BRPOP", b"emptyl", b"l2", b"1"], b"*2\r\n$2\r\nl2\r\n$1\r\nx\r\n"),
    ([b"TYPE", b"l"], b"+list\r\n"),
    # hashes
    ([b"HSET", b"h", b"f2", b"v2", b"f3", b"v3"], b":2\r\n"),
    ([b"HMGET", b"h", b"f1", b"nope", b"f3"], b"*3\r\n$2\r\nv1\r\n$-1\r\n$2\r\nv3\r\n"),
    ([b"HGETALL", b"h"], None),
    ([b"HKEYS", b"h"], None),
    ([b"HVALS", b"h"], None),
    ([b"HSETNX", b"h", b"f1", b"x"], b":0\r\n"),
    ([b"HSETNX", b"h", b"f4", b"x"], b":1\r\n"),
    ([b"HINCRBY", b"h", b"n", b"5"], b":5\r\n"),
    ([b"HINCRBY", b"h", b"n", b"-2"], b":3\r\n"),
    ([b"HINCRBY", b"h", b"f1", b"1"], ("prefix", b"-ERR")),
    ([b"HDEL", b"h", b"f4", b"nope"], b":1\r\n"),
    ([b"HSCAN", b"h", b"0", b"COUNT", b"100"], None),
    ([b"HSCAN", b"h", b"0", b"MATCH", b"f*", b"COUNT", b"1"], None),
    ([b"HSCAN", b"h", b"0", b"NOVALUES"], None),
    ([b"HRANDFIELD", b"h", b"-3"], ("shape", b"*3\r\n")),
    ([b"TYPE", b"h"], b"+hash\r\n"),
    # sets
    ([b"SADD", b"s2", b"b", b"c"], b":2\r\n"),
    ([b"SMISMEMBER", b"s", b"a", b"c"], b"*2\r\n:1\r\n:0\r\n"),
    ([b"SINTER", b"s", b"s2"], b"*1\r\n$1\r\nb\r\n"),
    ([b"SUNION", b"s", b"s2"], None),
    ([b"SDIFF", b"s", b"s2"], b"*1\r\n$1\r\na\r\n"),
    ([b"SINTERCARD", b"2", b"s", b"s2"], b":1\r\n"),
    ([b"SUNIONSTORE", b"su", b"s", b"s2"], b":3\r\n"),
    ([b"SDIFFSTORE", b"sd", b"s", b"s2"], b":1\r\n"),
    ([b"SINTERSTORE", b"si", b"s", b"s2"], b":1\r\n"),
    ([b"SMEMBERS", b"sd"], b"*1\r\n$1\r\na\r\n"),
    ([b"SMOVE", b"s", b"s2", b"a"], b":1\r\n"),
    ([b"SREM", b"s2", b"a", b"zz"], b":1\r\n"),
    ([b"SSCAN", b"su", b"0", b"COUNT", b"100"], None),
    ([b"SSCAN", b"su", b"0", b"MATCH", b"[ab]"], None),
    ([b"SRANDMEMBER", b"su", b"-2"], ("shape", b"*2\r\n")),
    ([b"SPOP", b"si"], b"$1\r\nb\r\n"),
    ([b"TYPE", b"su"], b"+set\r\n"),
    # sorted sets
    ([b"ZADD", b"z", b"2", b"n", b"3", b"o", b"0.25", b"p"], b":3\r\n"),
    ([b"ZRANGE", b"z", b"0", b"-1", b"WITHSCORES"], None),
    ([b"ZREVRANGE", b"z", b"0", b"1", b"WITHSCORES"], None),
    ([b"ZRANK", b"z", b"o"], b":3\r\n"),
    ([b"ZREVRANK", b"z", b"o"], b":0\r\n"),
    ([b"ZCOUNT", b"z", b"1", b"(3"], b":2\r\n"),
    ([b"ZRANGEBYSCORE", b"z", b"-inf", b"+inf", b"WITHSCORES", b"LIMIT", b"1", b"2"], None),
    ([b"ZINCRBY", b"z", b"0.5", b"m"], b"$1\r\n2\r\n"),
    ([b"ZADD", b"z2", b"10", b"m", b"20", b"q"], b":2\r\n"),
    ([b"ZUNIONSTORE", b"zu", b"2", b"z", b"z2", b"WEIGHTS", b"1", b"2"], b":5\r\n"),
    ([b"ZINTERSTORE", b"zi", b"2", b"z", b"z2", b"AGGREGATE", b"MAX"], b":1\r\n"),
    ([b"ZRANGE", b"zu", b"0", b"-1", b"WITHSCORES"], None),
    ([b"ZSCORE", b"zi", b"m"], b"$2\r\n10\r\n"),
    ([b"ZSCAN", b"zu", b"0", b"COUNT", b"100"], None),
    ([b"ZSCAN", b"zu", b"0", b"MATCH", b"m*"], None),
    ([b"ZADD", b"lex", b"0", b"a", b"0", b"b", b"0", b"c", b"0", b"d"], b":4\r\n"),
    ([b"ZRANGEBYLEX", b"lex", b"[b", b"(d"], b"*2\r\n$1\r\nb\r\n$1\r\nc\r\n"),
    ([b"ZRANGEBYLEX", b"lex", b"-", b"+", b"LIMIT", b"1", b"2"], None),
    ([b"ZRANDMEMBER", b"z", b"-2"], ("shape", b"*2\r\n")),
    ([b"ZPOPMIN", b"z"], b"*2\r\n$1\r\np\r\n$4\r\n0.25\r\n"),
    ([b"ZPOPMAX", b"z", b"2"], None),
    ([b"ZREMRANGEBYSCORE", b"zu", b"-inf", b"(20"], b":3\r\n"),
    ([b"ZREM", b"zu", b"q", b"zz"], b":1\r\n"),
    ([b"TYPE", b"z"], b"+zset\r\n"),
    # streams with a consumer group
    ([b"XADD", b"st", b"1-1", b"f", b"v1"], b"$3\r\n1-1\r\n"),
    ([b"XADD", b"st", b"2-0", b"f", b"v2", b"g", b"w"], b"$3\r\n2-0\r\n"),
    ([b"XADD", b"st", b"3-0", b"f", b"v3"], b"$3\r\n3-0\r\n"),
    ([b"XADD", b"st", b"1-0", b"f", b"bad"], ("prefix", b"-ERR")),
    ([b"XLEN", b"st"], b":3\r\n"),
    ([b"XRANGE", b"st", b"-", b"+"], None),
    ([b"XRANGE", b"st", b"-", b"+", b"COUNT", b"1"], None),
    ([b"XREVRANGE", b"st", b"+", b"-"], None),
    ([b"XGROUP", b"CREATE", b"st", b"g1", b"0"], b"+OK\r\n"),
    ([b"XGROUP", b"CREATE", b"st", b"g1", b"0"], ("prefix", b"-BUSYGROUP")),
    ([b"XREADGROUP", b"GROUP", b"g1", b"c1", b"COUNT", b"2", b"STREAMS", b"st", b">"], None),
    ([b"XPENDING", b"st", b"g1"], None),
    ([b"XPENDING", b"st", b"g1", b"-", b"+", b"10"],
     ("shape", b"*2\r\n*4\r\n$3\r\n1-1\r\n$2\r\nc1\r\n:")),
    ([b"XACK", b"st", b"g1", b"1-1"], b":1\r\n"),
    ([b"XACK", b"st", b"g1", b"1-1"], b":0\r\n"),
    ([b"XAUTOCLAIM", b"st", b"g1", b"c2", b"0", b"0"], None),
    ([b"XCLAIM", b"st", b"g1", b"c3", b"0", b"2-0"], None),
    ([b"XREAD", b"COUNT", b"10", b"STREAMS", b"st", b"1-1"], None),
    ([b"XINFO", b"STREAM", b"st"], None),
    ([b"XDEL", b"st", b"3-0"], b":1\r\n"),
    ([b"XTRIM", b"st", b"MAXLEN", b"1"], b":1\r\n"),
    ([b"XLEN", b"st"], b":1\r\n"),
    ([b"XREADGROUP", b"GROUP", b"nog", b"c1", b"STREAMS", b"st", b">"], ("prefix", b"-NOGROUP")),
    ([b"TYPE", b"st"], b"+stream\r\n"),
    # geo
    ([b"GEOADD", b"Sicily", b"13.361389", b"38.115556", b"Palermo",
      b"15.087269", b"37.502669", b"Catania"], b":2\r\n"),
    ([b"GEODIST", b"Sicily", b"Palermo", b"Catania"], b"$11\r\n166274.1516\r\n"),
    ([b"GEODIST", b"Sicily", b"Palermo", b"Catania", b"km"], b"$8\r\n166.2742\r\n"),
    ([b"GEODIST", b"Sicily", b"Palermo", b"Nowhere"], b"$-1\r\n"),
    ([b"GEOPOS", b"Sicily", b"Palermo", b"Nowhere"], None),
    ([b"GEOHASH", b"Sicily", b"Palermo", b"Catania"], b"*2\r\n$11\r\nsqc8b49rnyw\r\n$11\r\nsqdtr74hyu4\r\n"),
    ([b"GEOSEARCH", b"Sicily", b"FROMLONLAT", b"15", b"37", b"BYRADIUS",
      b"200", b"km", b"ASC", b"WITHCOORD", b"WITHDIST"], None),
    ([b"GEOSEARCH", b"Sicily", b"FROMMEMBER", b"Palermo", b"BYBOX",
      b"400", b"400", b"km", b"DESC", b"COUNT", b"1"], None),
    ([b"GEOSEARCHSTORE", b"near", b"Sicily", b"FROMLONLAT", b"15", b"37",
      b"BYRADIUS", b"100", b"km", b"STOREDIST"], b":1\r\n"),
    ([b"ZRANGE", b"near", b"0", b"-1", b"WITHSCORES"], None),
    ([b"GEOADD", b"Sicily", b"XX", b"CH", b"13.5", b"38.0", b"Palermo"], b":1\r\n"),
    ([b"GEOADD", b"Sicily", b"200", b"100", b"bad"], ("prefix", b"-ERR")),
    # one keyspace: WRONGTYPE between a Bloom key and a list key
    ([b"BF.RESERVE", b"bfk", b"0.01", b"100"], b"+OK\r\n"),
    ([b"LPUSH", b"bfk", b"x"], ("prefix", b"-WRONGTYPE")),
    ([b"SADD", b"bfk", b"x"], ("prefix", b"-WRONGTYPE")),
    ([b"BF.ADD", b"l2", b"x"], ("prefix", b"-ERR")),
    ([b"BF.RESERVE", b"l", b"0.01", b"100"], ("prefix", b"-WRONGTYPE")),
    ([b"HSET", b"s", b"f", b"v"], ("prefix", b"-WRONGTYPE")),
    ([b"XADD", b"h", b"*", b"f", b"v"], ("prefix", b"-WRONGTYPE")),
    ([b"GEOADD", b"l", b"1", b"1", b"m"], ("prefix", b"-WRONGTYPE")),
    ([b"SCAN", b"0", b"COUNT", b"1000"], None),
    ([b"DBSIZE"], b":17\r\n"),
    # transactions over the grid
    ([b"MULTI"], b"+OK\r\n"),
    ([b"RPUSH", b"tl", b"1", b"2"], b"+QUEUED\r\n"),
    ([b"HSET", b"th", b"f", b"v"], b"+QUEUED\r\n"),
    ([b"BLPOP", b"tl", b"0"], b"+QUEUED\r\n"),
    ([b"BLPOP", b"tnone", b"0"], b"+QUEUED\r\n"),
    ([b"EXEC"], b"*4\r\n:2\r\n:1\r\n*2\r\n$2\r\ntl\r\n$1\r\n1\r\n*-1\r\n"),
    ([b"MULTI"], b"+OK\r\n"),
    ([b"SUBSCRIBE", b"ch"], ("prefix", b"-ERR")),
    ([b"EXEC"], ("prefix", b"-EXECABORT")),
]

# Families the port does not carry yet: each must answer exactly as the
# JAX server answers a command it lacks.
WAITING = [
    [b"EVAL", b"return 1", b"0"], [b"FUNCTION", b"LIST"],
    [b"CLUSTER", b"INFO"], [b"SLOWLOG", b"GET"], [b"MONITOR"],
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


def _check_table(table, got_j, got_t):
    diff = [(c, t, j) for (c, w), j, t in zip(table, got_j, got_t)
            if t != j and not (isinstance(w, tuple) and w[0] in ("ttl", "shape"))]
    assert not diff, diff
    for (cmd, want), j, t in zip(table, got_j, got_t):
        if isinstance(want, tuple) and want[0] == "shape":
            assert j.startswith(want[1]) and t.startswith(want[1]), (cmd, j, t)
            continue
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


def test_wire_fixtures_byte_exact_on_both_servers(servers):
    js, ts = servers
    cmds = [c for c, _ in FIXTURES]
    _check_table(FIXTURES, _session(js, cmds), _session(ts, cmds))


@pytest.mark.parametrize("reactor", [True, False])
def test_grid_families_byte_exact_on_both_servers(reactor):
    """The grid session on fresh servers (reactor and thread path): every
    reply equals the JAX server's bytes, and the literal Redis reply
    where the table gives one."""
    jc, js = _jax_pair()
    tc = rt.create(rt.Config().use_gpu_sketch(device="cpu", min_bucket=64))
    tc.config.resp_reactor = reactor
    ts = RespServer(tc)
    try:
        cmds = [c for c, _ in GRID]
        _check_table(GRID, _session(js, cmds), _session(ts, cmds))
    finally:
        ts.close()
        tc.shutdown()
        js.close()
        jc.shutdown()


def _pubsub_session(server):
    """Two subscribers (RESP2 and RESP3) and a publisher: the acks, the
    PUBLISH counts and every pushed frame, in order."""
    sub = socket.create_connection((server.host, server.port))
    sub3 = socket.create_connection((server.host, server.port))
    pub = socket.create_connection((server.host, server.port))
    out = []
    try:
        sub.sendall(wire_command([b"SUBSCRIBE", b"ch"]))
        out += _read_frames(sub, 1)
        sub.sendall(wire_command([b"SUBSCRIBE", b"ch", b"ch2"]))
        out += _read_frames(sub, 2)
        # HELLO 3 answers a RESP3 map ('%'): read up to the PING after it.
        sub3.sendall(wire_command([b"HELLO", b"3"]) + wire_command([b"PING"]))
        sub3.settimeout(30)
        hello = b""
        while not hello.endswith(b"+PONG\r\n"):
            chunk = sub3.recv(1 << 16)
            assert chunk, "connection closed during HELLO 3"
            hello += chunk
        sub3.sendall(wire_command([b"SUBSCRIBE", b"ch2"]))
        out += _read_frames(sub3, 1)
        out += exchange_frames(pub, [[b"PUBLISH", b"ch", b"hello"]])
        out += _read_frames(sub, 1)
        out += exchange_frames(pub, [[b"PUBLISH", b"ch2", b"x" * 300]])
        out += _read_frames(sub, 1) + _read_frames(sub3, 1)
        out += exchange_frames(pub, [[b"PUBLISH", b"nobody", b"m"]])
        sub.sendall(wire_command([b"UNSUBSCRIBE", b"ch"]))
        out += _read_frames(sub, 1)
        out += exchange_frames(pub, [[b"PUBLISH", b"ch", b"gone"]])
        sub.sendall(wire_command([b"UNSUBSCRIBE"]))
        out += _read_frames(sub, 1)
        out += exchange_frames(pub, [[b"PUBLISH", b"ch2", b"last"]])
        out += _read_frames(sub3, 1)
        # A subscriber that disconnects drops its listener with it.
        sub3.close()
        deadline = time.monotonic() + 5
        while True:
            n = exchange_frames(pub, [[b"PUBLISH", b"ch2", b"after"]])[0]
            if n == b":0\r\n" or time.monotonic() > deadline:
                break
            time.sleep(0.01)
        out.append(n)
        return out
    finally:
        for s in (sub, sub3, pub):
            s.close()


def exchange_frames(sock, cmds):
    for c in cmds:
        sock.sendall(wire_command(c))
    return _read_frames(sock, len(cmds))


def test_pubsub_fixture_on_both_servers(servers):
    """The pub/sub fixture of ``tests/test_resp_wire_fixtures.py`` (the
    subscribe ack frame), extended to PUBLISH counts, message pushes on
    RESP2 and RESP3 ('>' frames), UNSUBSCRIBE acks and the drop of a
    disconnected subscriber's listener: byte-identical on both servers."""
    js, ts = servers
    got_j, got_t = _pubsub_session(js), _pubsub_session(ts)
    assert got_t == got_j
    assert got_t[0] == b"*3\r\n$9\r\nsubscribe\r\n$2\r\nch\r\n:1\r\n"
    assert got_t[4] == b":1\r\n"  # PUBLISH ch reaches one subscriber
    assert got_t[5] == b"*3\r\n$7\r\nmessage\r\n$2\r\nch\r\n$5\r\nhello\r\n"
    assert got_t[6] == b":2\r\n"
    assert got_t[8].startswith(b">3\r\n$7\r\nmessage\r\n")
    assert got_t[-1] == b":0\r\n"


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


# -- the family tests of test_resp_scan_family.py and the stream/geo half of
# -- test_resp_streams_geo_script.py, on a port server ------------------------

@pytest.fixture
def resp():
    client = _port_client()
    server = RespServer(client)
    conn = RespClient(server.host, server.port)
    yield conn
    conn.close()
    server.close()
    client.shutdown()


@pytest.fixture
def stack():
    client = _port_client()
    server = RespServer(client)
    conn = RespClient(server.host, server.port)
    yield client, conn
    conn.close()
    server.close()
    client.shutdown()


class TestHscan(_ref_scan.TestHscan):
    pass


class TestSscanZscan(_ref_scan.TestSscanZscan):
    pass


class TestZsetStores(_ref_scan.TestZsetStores):
    pass


class TestZrangebylex(_ref_scan.TestZrangebylex):
    pass


class TestScanReviewFixes(_ref_scan.TestReviewFixes):
    pass


class TestRespStreams(_ref_sg.TestRespStreams):
    pass


class TestRespGeo(_ref_sg.TestRespGeo):
    pass


def _blocked_xread(client, conn, args):
    """Run a blocking XREAD on ``conn`` in a thread; return it once the
    server parks it on the grid store's condition (polled with a
    deadline) — a parked read has not returned."""
    got = []
    t = threading.Thread(target=lambda: got.append(conn.cmd(*args)))
    t.start()
    deadline = time.monotonic() + 5
    while not client._grid.cond._waiters:
        assert time.monotonic() < deadline, "XREAD never parked"
        time.sleep(0.005)
    assert t.is_alive()  # parked, not an instant nil
    return t, got


class TestStreamGeoReviewFixes(_ref_sg.TestReviewFixes):
    def test_xread_block_zero_means_forever(self, stack):
        """BLOCK 0 must wait (Redis semantics), not return instantly —
        an entry added by another connection releases it."""
        client, c = stack
        t, got = _blocked_xread(client, c, ("XREAD", "BLOCK", 0, "STREAMS", "bk", "$"))
        c2 = RespClient(c._sock.getpeername()[0], c._sock.getpeername()[1])
        try:
            eid = c2.cmd("XADD", "bk", "*", "f", "v").decode()
        finally:
            c2.close()
        t.join(10)
        assert not t.is_alive()
        assert got[0][0][1][0][0].decode() == eid


class TestHighSweepFixes(_ref_sg.TestHighSweepFixes):
    # Scripting waits for its slice (EVAL answers as an unknown command).
    test_eval_numkeys_validation = None
    test_script_flush_unregisters_python_side = None

    def test_xread_block_multiple_streams(self, stack):
        """BLOCK must work across >1 stream (it silently returned nil)."""
        client, c = stack
        t, got = _blocked_xread(
            client, c, ("XREAD", "BLOCK", 5000, "STREAMS", "ms1", "ms2", "$", "$"))
        c2 = RespClient(c._sock.getpeername()[0], c._sock.getpeername()[1])
        try:
            c2.cmd("XADD", "ms2", "*", "f", "v")
        finally:
            c2.close()
        t.join(10)
        assert not t.is_alive()
        assert got[0][0][0] == b"ms2"
