"""RESP scripting on the port against the JAX package's.

* The JAX package's scripting tests run again on a port server: every
  test of ``tests/test_script_gating.py`` (``port_module``),
  ``TestRespScripting`` of ``tests/test_resp_streams_geo_script.py``
  (``port_class``) and its two scripting cases of ``TestHighSweepFixes``.
  None is skipped.
* A seeded script session (EVAL in both forms with every reply type,
  EVALSHA and NOSCRIPT, SCRIPT LOAD|EXISTS|FLUSH, FUNCTION LOAD|REPLACE|
  LIST|DELETE|FLUSH, FCALL and FCALL_RO, redis.call and redis.pcall of
  the Bloom, CMS and string commands) goes to a JAX server (CPU backend)
  and a port server (``device="cpu"``): every reply byte-equal, then the
  Bloom and CMS rows byte-equal.
* The watchdog: BUSY on another connection while a script runs past
  ``script_timeout_ms``; SCRIPT KILL of a pure loop, of a redis.call
  loop (at the dispatch boundary alone), of a runaway FCALL and of a
  nested EVAL (converted only at the outer frame); NOTBUSY with nothing
  running; the slot free after every kill.  Waits poll under a deadline.
* A kill during launches: a BF.MADD loop killed mid-run leaves the row of
  its completed MADDs, plus at most one MADD's keys whole.
"""

import hashlib
import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
import test_resp_streams_geo_script as _ref_sg  # noqa: E402
import test_script_gating as _ref_gate  # noqa: E402
from redisson_tpu.serve.resp import RespServer as JaxRespServer  # noqa: E402
from redisson_tpu_torch import codecs  # noqa: E402
from redisson_tpu_torch.ops import golden  # noqa: E402
from redisson_tpu_torch.serve.resp import RespServer  # noqa: E402
from redisson_tpu_torch.serve.wireutil import skip_reply_frame, wire_command  # noqa: E402
from redisson_tpu_torch.utils import hashing  # noqa: E402
from test_resp_server import RespClient  # noqa: E402
from test_torch_grid_coordination import (  # noqa: E402,F401
    _one_torch_thread,
    port_case,
    port_class,
)
from test_torch_observability import port_module  # noqa: E402

KILLED = b"-ERR Script killed by user with SCRIPT KILL...\r\n"


def _port_client(**kw):
    kw.setdefault("min_bucket", 64)
    return rt.create(rt.Config().use_gpu_sketch(device="cpu", **kw))


# -- the JAX package's scripting tests, on a port server ----------------------

port_module(_ref_gate, globals())


@pytest.fixture
def stack():
    client = _port_client()
    server = RespServer(client, enable_python_scripts=True)
    conn = RespClient(server.host, server.port)
    yield client, conn
    conn.close()
    server.close()
    client.shutdown()


class TestRespScripting(port_class(_ref_sg.TestRespScripting)):
    pass


class TestHighSweepScripting:
    test_eval_numkeys_validation = port_case(
        _ref_sg.TestHighSweepFixes.test_eval_numkeys_validation)
    test_script_flush_unregisters_python_side = port_case(
        _ref_sg.TestHighSweepFixes.test_script_flush_unregisters_python_side)


# -- a seeded session, byte-equal on both servers ------------------------------


def _read_frame(sock, timeout=30.0):
    sock.settimeout(timeout)
    buf = b""
    while True:
        try:
            end = skip_reply_frame(buf, 0)
            assert end == len(buf), "extra bytes after one reply"
            return buf
        except (IndexError, ValueError):
            pass
        chunk = sock.recv(1 << 16)
        assert chunk, "connection closed"
        buf += chunk


def _session(server, cmds):
    s = socket.create_connection((server.host, server.port))
    try:
        out = []
        for c in cmds:
            s.sendall(wire_command(c))
            out.append(_read_frame(s))
        return out
    finally:
        s.close()


def _row(client, name):
    """A sketch's pool row as uint32 words (either package)."""
    eng = client._engine
    if hasattr(eng, "_drain"):
        eng._drain()
    e = eng.registry.lookup(name)
    return np.asarray(eng.executor.read_row(e.pool, e.row)).view(np.uint32)


LIB = (
    b"#!python name=slib\n"
    b"def add(keys, args):\n"
    b"    return redis.call('BF.MADD', keys[0], *args)\n"
    b"def look(keys, args):\n"
    b"    return redis.call('BF.MEXISTS', keys[0], *args)\n"
    b"def bump(keys, args):\n"
    b"    return redis.call('CMS.INCRBY', keys[0], args[0], 7)\n"
    b"register_function('add', add)\n"
    b"register_function('look', look, flags=('no-writes',))\n"
    b"register_function('bump', bump)\n"
)
LIB2 = LIB.replace(b"7)", b"9)")
OTHER = b"#!python name=other\nregister_function('one', lambda k, a: 1)\n"


def session_cmds(seed: int) -> list:
    rng = np.random.default_rng(seed)
    keys = [b"%d" % v for v in rng.integers(0, 1 << 40, 64)]
    items = [b"i%d" % v for v in rng.integers(0, 50, 12)]
    cms_args = [x for it in items for x in (it, b"%d" % rng.integers(1, 9))]
    add_body = b"int(ARGV[0]) + 1"
    add_sha = hashlib.sha1(add_body).hexdigest().encode()
    len_sha = hashlib.sha1(b"len(KEYS)").hexdigest().encode()
    return [
        [b"BF.RESERVE", b"sbf", b"0.01", b"5000"],
        [b"CMS.INITBYDIM", b"scms", b"2048", b"4"],
        # expression form: every _script_reply type
        [b"EVAL", b"None", b"0"], [b"EVAL", b"False", b"0"],
        [b"EVAL", b"True", b"0"], [b"EVAL", b"-42", b"0"],
        [b"EVAL", b"2.5", b"0"], [b"EVAL", b"3.0", b"0"],
        [b"EVAL", b"1e20", b"0"], [b"EVAL", b"b'raw'", b"0"],
        [b"EVAL", b"'text'", b"0"],
        [b"EVAL", b"[1, b'x', [None, True], (2, 'y')]", b"0"],
        [b"EVAL", b"{'a': 1, 'b': [2.25]}", b"0"],
        [b"EVAL", b"redis.pcall('NOPE')", b"0"],
        [b"EVAL", b"range(3)", b"0"],
        [b"EVAL", b"KEYS + ARGV", b"2", b"k1", b"k2", b"a"],
        # exec form
        [b"EVAL", b"x = int(ARGV[0])\nresult = [x, x * 2]", b"0", b"21"],
        [b"EVAL", b"y = 1", b"0"],
        [b"EVAL", b"1 / 0", b"0"],
        # EVALSHA after EVAL, NOSCRIPT, SCRIPT LOAD|EXISTS|FLUSH
        [b"EVAL", add_body, b"0", b"1"], [b"EVALSHA", add_sha, b"0", b"5"],
        [b"EVALSHA", b"f" * 40, b"0"],
        [b"SCRIPT", b"LOAD", b"len(KEYS)"],
        [b"SCRIPT", b"EXISTS", len_sha, b"0" * 40, add_sha],
        [b"EVALSHA", len_sha, b"2", b"a", b"b"],
        [b"SCRIPT", b"FLUSH"], [b"SCRIPT", b"EXISTS", len_sha, add_sha],
        [b"EVALSHA", len_sha, b"0"],
        # FUNCTION LOAD | REPLACE | LIST | DELETE | FLUSH, FCALL, FCALL_RO
        [b"FUNCTION", b"LOAD", LIB], [b"FUNCTION", b"LOAD", LIB],
        [b"FUNCTION", b"LOAD", b"REPLACE", LIB2],
        [b"FUNCTION", b"LOAD", b"#!lua name=x\nreturn 1"],
        [b"FUNCTION", b"LOAD", OTHER],
        [b"FUNCTION", b"LIST"], [b"FUNCTION", b"LIST", b"LIBRARYNAME", b"s*"],
        [b"FCALL", b"add", b"1", b"sbf"] + keys[48:64],
        [b"FCALL_RO", b"look", b"1", b"sbf"] + keys[40:64],
        [b"FCALL_RO", b"add", b"1", b"sbf", b"x"],
        [b"FCALL", b"bump", b"1", b"scms", items[0]],
        [b"FUNCTION", b"DELETE", b"other"], [b"FCALL", b"one", b"0"],
        [b"FUNCTION", b"DELETE", b"other"],
        [b"FUNCTION", b"FLUSH"], [b"FUNCTION", b"LIST"],
        # redis.call / redis.pcall of the Bloom, CMS and string commands
        [b"EVAL", b"redis.call('BF.MADD', KEYS[0], *ARGV)", b"1", b"sbf"]
        + keys[:32],
        [b"EVAL", b"redis.pcall('BF.MEXISTS', KEYS[0], *ARGV)", b"1", b"sbf"]
        + keys[16:48],
        [b"EVAL", b"redis.call('SET', KEYS[0], ARGV[0])\n"
         b"result = redis.call('GET', KEYS[0])", b"1", b"skey", b"sval"],
        [b"EVAL", b"redis.call('CMS.INCRBY', KEYS[0], *ARGV)", b"1", b"scms"]
        + cms_args,
        [b"EVAL", b"redis.pcall('CMS.QUERY', KEYS[0], *ARGV)", b"1", b"scms"]
        + items,
        [b"EVAL", b"redis.pcall('BF.MADD', 'sbf')", b"0"],
        [b"EVAL", b"redis.call('BF.MADD', 'sbf')", b"0"],
        [b"BF.MEXISTS", b"sbf"] + keys, [b"GET", b"skey"],
        [b"CMS.QUERY", b"scms"] + items,
    ]


@pytest.fixture
def script_servers():
    jc = redisson_tpu.create(redisson_tpu.Config().use_tpu_sketch(min_bucket=64))
    tc = _port_client()
    js = JaxRespServer(jc, enable_python_scripts=True)
    ts = RespServer(tc, enable_python_scripts=True)
    yield jc, js, tc, ts
    ts.close()
    tc.shutdown()
    js.close()
    jc.shutdown()


def test_seeded_script_session_is_byte_equal(script_servers):
    jc, js, tc, ts = script_servers
    cmds = session_cmds(seed=12)
    want = _session(js, cmds)
    got = _session(ts, cmds)
    for c, w, g in zip(cmds, want, got):
        assert g == w, (c[:3], w, g)
    # Every reply type and error path really ran (not all errors).
    assert sum(f.startswith(b"-") for f in got) < len(got) // 3
    assert np.array_equal(_row(jc, "sbf"), _row(tc, "sbf"))
    assert np.array_equal(_row(jc, "scms"), _row(tc, "scms"))


# -- the watchdog ----------------------------------------------------------------


@pytest.fixture
def watched():
    client = _port_client()
    client.config.script_timeout_ms = 50
    server = RespServer(client, enable_python_scripts=True)
    yield client, server
    server.close()
    client.shutdown()


def _conn(server):
    s = socket.create_connection((server.host, server.port))
    s.settimeout(30)
    return s


def _ask(sock, cmd) -> bytes:
    sock.sendall(wire_command(cmd))
    return _read_frame(sock)


def _until(cond, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.005)


class _Running:
    """One command run on its own connection in a thread."""

    def __init__(self, server, cmd):
        self.sock = _conn(server)
        self.reply = None
        self.thread = threading.Thread(target=self._run, args=(cmd,))
        self.thread.start()

    def _run(self, cmd):
        self.reply = _ask(self.sock, cmd)

    def join(self):
        self.thread.join(30)
        assert not self.thread.is_alive(), "the killed script never replied"
        self.sock.close()
        return self.reply


def _await_busy(sock):
    """Poll another connection until it answers BUSY."""
    got = []

    def busy():
        got.append(_ask(sock, [b"PING"]))
        return got[-1].startswith(b"-BUSY")

    _until(busy, "BUSY")
    return got[-1]


def _slot_free(server, sock):
    assert server._script_run is None and server._script_kill is None
    assert _ask(sock, [b"EVAL", b"6 * 7", b"0"]) == b":42\r\n"


def test_busy_then_kill_of_a_pure_loop(watched):
    _client, server = watched
    other = _conn(server)
    try:
        assert _ask(other, [b"SCRIPT", b"KILL"]).startswith(b"-NOTBUSY")
        run = _Running(server, [b"EVAL", b"while True: pass", b"0"])
        assert _await_busy(other) == (
            b"-BUSY Redis is busy running a script. You can only call "
            b"SCRIPT KILL or SHUTDOWN NOSAVE.\r\n")
        assert _ask(other, [b"SCRIPT", b"KILL"]) == b"+OK\r\n"
        assert run.join() == KILLED
        _slot_free(server, other)
        assert _ask(other, [b"SCRIPT", b"KILL"]).startswith(b"-NOTBUSY")
    finally:
        other.close()


def test_redis_call_loop_dies_at_the_dispatch_boundary(watched, monkeypatch):
    """With the reaper's async exception disabled, the kill flag alone
    stops a script that keeps calling back in."""
    client, server = watched
    monkeypatch.setattr(server, "_script_reaper", lambda run: None)
    other = _conn(server)
    try:
        assert _ask(other, [b"BF.RESERVE", b"wbf", b"0.01", b"1000"]) == b"+OK\r\n"
        run = _Running(server, [
            b"EVAL", b"while True:\n    redis.call('BF.EXISTS', KEYS[0], 'x')",
            b"1", b"wbf"])
        _await_busy(other)
        assert _ask(other, [b"SCRIPT", b"KILL"]) == b"+OK\r\n"
        assert run.join() == KILLED
        _slot_free(server, other)
    finally:
        other.close()


def test_runaway_fcall_is_killed(watched):
    _client, server = watched
    other = _conn(server)
    try:
        lib = (b"#!python name=spin\n"
               b"def spin(keys, args):\n    while True:\n        pass\n"
               b"register_function('spin', spin)\n")
        assert _ask(other, [b"FUNCTION", b"LOAD", lib]) == b"$4\r\nspin\r\n"
        run = _Running(server, [b"FCALL", b"spin", b"0"])
        _await_busy(other)
        assert _ask(other, [b"SCRIPT", b"KILL"]) == b"+OK\r\n"
        assert run.join() == KILLED
        _slot_free(server, other)
    finally:
        other.close()


def test_nested_eval_is_killed_at_the_outer_frame(watched):
    """The inner frame re-raises the BaseException: the outer script's
    blanket ``except Exception`` cannot swallow the kill."""
    _client, server = watched
    other = _conn(server)
    try:
        outer = (b"try:\n    redis.call('EVAL', 'while True: pass', '0')\n"
                 b"except Exception:\n    result = 'swallowed'\n")
        run = _Running(server, [b"EVAL", outer, b"0"])
        _await_busy(other)
        assert _ask(other, [b"SCRIPT", b"KILL"]) == b"+OK\r\n"
        assert run.join() == KILLED
        _slot_free(server, other)
    finally:
        other.close()


def _golden_words(client, items, m, k, row_words):
    """The golden Bloom bitmap of ``items`` as the server hashes them."""
    h1, h2 = hashing.km_reduce_mod(
        *hashing.hash128_np(*codecs.encode_batch(client.config.codec, items)), m)
    g = golden.GoldenBloomFilter(m, k)
    g.bits[g._indexes(h1, h2).reshape(-1)] = True
    bits = np.zeros(row_words * 32, bool)
    bits[:m] = g.bits
    return np.packbits(bits, bitorder="little").view(np.uint32)


def test_kill_during_launches_lands_whole_madds(watched):
    """A script looping BF.MADD with fresh keys is killed after at least 8
    MADDs: the row equals the golden bitmap of the MADDs it completed
    (its counter), plus at most one more MADD's keys whole."""
    client, server = watched
    per = 64
    madds = []
    orig = server._cmd_BF_MADD

    def counted(args):
        out = orig(args)
        madds.append(len(args) - 1)
        return out

    server._cmd_BF_MADD = counted
    other = _conn(server)
    try:
        assert _ask(other, [b"BF.RESERVE", b"kbf", b"0.01", b"100000"]) == b"+OK\r\n"
        body = (b"i = 0\nwhile True:\n"
                b"    redis.call('BF.MADD', KEYS[0], "
                b"*[b'%d' % (i * 64 + j) for j in range(64)])\n"
                b"    i += 1\n    redis.call('SET', KEYS[1], str(i))\n")
        run = _Running(server, [b"EVAL", body, b"2", b"kbf", b"kdone"])
        _until(lambda: len(madds) >= 8, "8 MADDs")
        assert _ask(other, [b"SCRIPT", b"KILL"]) == b"+OK\r\n"
        assert run.join() == KILLED
        _slot_free(server, other)
        done = int(_ask(other, [b"GET", b"kdone"]).split(b"\r\n")[1])
        assert done >= 8 and all(n == per for n in madds)
        assert len(madds) in (done, done + 1)
        bf = client.get_bloom_filter("kbf")
        m, k = bf.get_size(), bf.get_hash_iterations()
        row = _row(client, "kbf")
        fits = [
            np.array_equal(row, _golden_words(
                client, [b"%d" % i for i in range(n * per)], m, k, row.shape[0]))
            for n in (done, done + 1)
        ]
        assert fits[len(madds) - done]
    finally:
        other.close()
