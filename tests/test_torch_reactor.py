"""The port's reactor front door against the JAX package's.

Counterparts of ``tests/test_reactor.py``: replacing
thread-per-connection serving with the reactor pool must be INVISIBLE on
the wire — every connection's reply stream is byte-identical to the
thread path's (and to the JAX server's), whatever the tick boundaries,
the cross-connection fusion or the worker handoffs — while the serving
thread count stays FIXED as connections scale.

A parked BLPOP and a SUBSCRIBE ride worker threads off the event loop
(``test_blocking_command_does_not_stall_other_connections``,
``test_pubsub_across_reactor_connections``), and the multi-connection
soak carries the reference's RPOPLPUSH/BLPOP worker-handoff commands.
"""

import random
import socket
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
from redisson_tpu.serve.resp import RespServer as JaxRespServer  # noqa: E402
from redisson_tpu_torch import chaos  # noqa: E402
from redisson_tpu_torch.serve.resp import RespServer, _ConnCtx  # noqa: E402
from redisson_tpu_torch.serve.wireutil import (  # noqa: E402
    skip_reply_frame as _skip_frame,
    wire_command as _wire,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk_server(reactor: bool, retry_attempts=None, max_connections=256,
               idle_timeout_s=300.0, **kw):
    cfg = rt.Config().use_gpu_sketch(device="cpu", min_bucket=64, **kw)
    cfg.resp_reactor = reactor
    if retry_attempts is not None:
        cfg.retry_attempts = retry_attempts
        cfg.retry_interval_ms = 5
    client = rt.create(cfg)
    server = RespServer(client, max_connections=max_connections,
                        idle_timeout_s=idle_timeout_s)
    return client, server


def _mk_jax_server(reactor: bool):
    cfg = redisson_tpu.Config().use_tpu_sketch(min_bucket=64)
    cfg.resp_reactor = reactor
    client = redisson_tpu.create(cfg)
    return client, JaxRespServer(client)


def _recv_replies(sock, n, timeout=60.0):
    sock.settimeout(timeout)
    data = b""
    frames = []
    pos = 0
    deadline = time.monotonic() + timeout
    while len(frames) < n:
        try:
            while len(frames) < n:
                end = _skip_frame(data, pos)
                frames.append(data[pos:end])
                pos = end
        except (IndexError, ValueError):
            pass
        if len(frames) >= n:
            break
        if time.monotonic() > deadline:
            raise AssertionError(f"timeout with {len(frames)}/{n} replies")
        chunk = sock.recv(1 << 16)
        if not chunk:
            raise AssertionError(f"connection closed with {len(frames)}/{n} replies")
        data += chunk
    return frames, data[pos:]


def _roundtrip(server, cmds, sock=None):
    own = sock is None
    if own:
        sock = socket.create_connection((server.host, server.port))
    try:
        sock.sendall(b"".join(_wire(c) for c in cmds))
        frames, rest = _recv_replies(sock, len(cmds))
        assert rest == b""
        return frames
    finally:
        if own:
            sock.close()


def _serving_threads():
    """Names of live RESP serving threads (reactors, per-conn readers,
    detach workers)."""
    return [t.name for t in threading.enumerate() if t.name.startswith("rtpu-resp")]


@pytest.fixture(scope="module")
def rx():
    client, server = _mk_server(True)
    yield client, server
    server.close()
    client.shutdown()


class TestReactorBasics:
    def test_reactor_active_by_default(self, rx):
        client, server = rx
        assert server.reactor is not None
        assert server.reactor.nthreads == client.config.resp_reactor_threads
        frames = _roundtrip(server, [[b"PING"], [b"SET", b"rxk", b"v"], [b"GET", b"rxk"]])
        assert frames == [b"+PONG\r\n", b"+OK\r\n", b"$1\r\nv\r\n"]

    def test_fixed_thread_count_many_idle_connections(self, rx):
        _client, server = rx
        before = _serving_threads()
        socks = [socket.create_connection((server.host, server.port)) for _ in range(30)]
        try:
            for s in socks[::7]:
                assert _roundtrip(server, [[b"PING"]], sock=s) == [b"+PONG\r\n"]
            after = _serving_threads()
            # 30 idle connections ride the same fixed reactor pool.
            assert not any(n == "rtpu-resp-conn" for n in after)
            assert len(after) <= len(before) + 1  # tolerate a worker blip
        finally:
            for s in socks:
                s.close()

    def test_detached_command_does_not_stall_other_connections(self, rx):
        """A long command rides a worker thread (the detach gate BLPOP
        uses in the JAX package): the event loop keeps serving."""
        _client, server = rx
        slow = socket.create_connection((server.host, server.port))
        other = socket.create_connection((server.host, server.port))
        try:
            slow.sendall(_wire([b"DEBUG", b"SLEEP", b"1.5"]))
            time.sleep(0.1)
            t0 = time.monotonic()
            assert _roundtrip(server, [[b"PING"]], sock=other) == [b"+PONG\r\n"]
            assert time.monotonic() - t0 < 1.0, "reactor stalled by a detached command"
            frames, _ = _recv_replies(slow, 1)
            assert frames[0] == b"+OK\r\n"
        finally:
            slow.close()
            other.close()

    def test_blocking_command_does_not_stall_other_connections(self, rx):
        """A parked BLPOP rides a worker thread: other connections keep
        being served — 1000 pipelined reads answered while it waits, with
        no serving thread added — and an LPUSH from another connection
        wakes it."""
        _client, server = rx
        blocker = socket.create_connection((server.host, server.port))
        other = socket.create_connection((server.host, server.port))
        try:
            blocker.sendall(_wire([b"BLPOP", b"rx-q", b"5"]))
            deadline = time.monotonic() + 5
            while not _client._grid.cond._waiters:  # parked on a worker
                assert time.monotonic() < deadline, "BLPOP never parked"
                time.sleep(0.005)
            threads = _serving_threads()
            t0 = time.monotonic()
            assert _roundtrip(server, [[b"PING"]], sock=other) == [b"+PONG\r\n"]
            assert time.monotonic() - t0 < 2.0, "reactor stalled by BLPOP"
            frames = _roundtrip(server, [[b"GET", b"rx-none"]] * 1000, sock=other)
            assert frames == [b"$-1\r\n"] * 1000
            assert _serving_threads() == threads
            _roundtrip(server, [[b"LPUSH", b"rx-q", b"v"]], sock=other)
            frames, _ = _recv_replies(blocker, 1)
            assert frames[0] == b"*2\r\n$4\r\nrx-q\r\n$1\r\nv\r\n"
        finally:
            blocker.close()
            other.close()

    def test_pubsub_across_reactor_connections(self, rx):
        _client, server = rx
        sub = socket.create_connection((server.host, server.port))
        pub = socket.create_connection((server.host, server.port))
        try:
            sub.sendall(_wire([b"SUBSCRIBE", b"rx-chan"]))
            frames, _ = _recv_replies(sub, 1)
            assert b"subscribe" in frames[0]
            _roundtrip(server, [[b"PUBLISH", b"rx-chan", b"hello"]], sock=pub)
            frames, _ = _recv_replies(sub, 1)
            assert frames[0] == (
                b"*3\r\n$7\r\nmessage\r\n$7\r\nrx-chan\r\n$5\r\nhello\r\n"
            )
        finally:
            sub.close()
            pub.close()

    def test_large_reply_requeue_path(self, rx):
        _client, server = rx
        big = b"x" * (300 << 10)
        frames = _roundtrip(server, [[b"SET", b"rx-big", big]] + [[b"GET", b"rx-big"]] * 8)
        want = b"$%d\r\n%s\r\n" % (len(big), big)
        assert frames[0] == b"+OK\r\n" and all(f == want for f in frames[1:])

    def test_protocol_error_replies_then_closes(self, rx):
        _client, server = rx
        s = socket.create_connection((server.host, server.port))
        try:
            s.sendall(b"*-3\r\n")
            s.settimeout(5)
            data = s.recv(4096)
            assert data.startswith(b"-ERR Protocol error")
            assert s.recv(4096) == b""  # server closed the stream
        finally:
            s.close()

    def test_multi_exec_on_reactor(self, rx):
        _client, server = rx
        frames = _roundtrip(server, [
            [b"MULTI"], [b"SET", b"rx-m", b"1"], [b"GET", b"rx-m"],
            [b"EXEC"], [b"GET", b"rx-m"],
        ])
        assert frames[0] == b"+OK\r\n"
        assert frames[1] == frames[2] == b"+QUEUED\r\n"
        assert frames[3] == b"*2\r\n+OK\r\n$1\r\n1\r\n"
        assert frames[4] == b"$1\r\n1\r\n"

    def test_idle_timeout_reclaims_connection(self):
        client, server = _mk_server(True, idle_timeout_s=0.3)
        try:
            s = socket.create_connection((server.host, server.port))
            assert _roundtrip(server, [[b"PING"]], sock=s) == [b"+PONG\r\n"]
            s.settimeout(5)
            assert s.recv(16) == b""  # closed by the idle sweep
            s.close()
        finally:
            server.close()
            client.shutdown()


class TestConnLimitObservability:
    def test_conn_limit_refusal_counted(self):
        client, server = _mk_server(True, max_connections=2)
        try:
            keep = [socket.create_connection((server.host, server.port)) for _ in range(2)]
            for s in keep:
                assert _roundtrip(server, [[b"PING"]], sock=s)
            over = socket.create_connection((server.host, server.port))
            over.settimeout(5)
            assert over.recv(4096).startswith(b"-ERR max number of clients")
            over.close()
            deadline = time.monotonic() + 5
            while server._conns_refused == 0 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert server._conns_refused == 1
            shed = {lv[0]: int(c.value) for lv, c in server.obs.resp_ingress_shed.items()}
            assert shed.get("conn_limit") == 1
            info = _roundtrip(server, [[b"INFO", b"clients"]], sock=keep[0])[0]
            assert b"rejected_connections:1" in info
            for s in keep:
                s.close()
        finally:
            server.close()
            client.shutdown()


class TestCmsQueryFusion:
    def test_cms_run_fuses_and_matches_sequential(self):
        client, server = _mk_server(True)
        ref_client, ref_server = _mk_server(False)
        ref_server.vectorize = False
        jc, js = _mk_jax_server(True)
        try:
            seed = [[b"CMS.INITBYDIM", b"rx-cms", b"512", b"4"]]
            seed += [[b"CMS.INCRBY", b"rx-cms", b"it%d" % i, b"%d" % (i + 1)]
                     for i in range(10)]
            queries = [
                [b"CMS.QUERY", b"rx-cms", b"it1", b"it2"],
                [b"CMS.QUERY", b"rx-cms", b"it3"],
                [b"CMS.QUERY", b"rx-cms", b"it9", b"missing", b"it0"],
                [b"CMS.QUERY", b"rx-cms", b"it1", b"it2"],  # cache hit
            ]
            got = _roundtrip(server, seed + queries)[len(seed):]
            want = _roundtrip(ref_server, seed + queries)[len(seed):]
            assert got == want == _roundtrip(js, seed + queries)[len(seed):]
            assert got[0] == b"*2\r\n:2\r\n:3\r\n"
            fused = {lv[0]: int(c.value) for lv, c in server.obs.resp_fused_runs.items()}
            assert fused.get("cms", 0) >= 1
        finally:
            for s_, c_ in ((server, client), (ref_server, ref_client), (js, jc)):
                s_.close()
                c_.shutdown()

    def test_uninitialized_cms_errors_per_command(self):
        client, server = _mk_server(True)
        try:
            frames = _roundtrip(server, [
                [b"CMS.QUERY", b"rx-no-cms", b"a"],
                [b"CMS.QUERY", b"rx-no-cms", b"b", b"c"],
            ])
            assert all(f.startswith(b"-") for f in frames)
            assert len(set(frames)) == 1
        finally:
            server.close()
            client.shutdown()


class TestCrossConnFusion:
    def test_merged_window_counts_cross_conn_ops(self):
        """Items from two connections fuse into one run and the
        cross-connection counter sees their ops."""
        client, server = _mk_server(True)
        try:
            _roundtrip(server, [[b"BF.RESERVE", b"xf", b"0.01", b"1000"],
                                [b"BF.ADD", b"xf", b"a"]])
            a_srv, b_srv = socket.socket(), socket.socket()
            ctx_a = _ConnCtx(a_srv, server=server)
            ctx_b = _ConnCtx(b_srv, server=server)

            def tot():
                return sum(int(c.value) for _, c in server.obs.cross_conn_fused_ops.items())

            before = tot()
            frames, consumed = server._dispatch_merged(
                [[b"BF.EXISTS", b"xf", b"a"], [b"BF.EXISTS", b"xf", b"zz"]],
                [ctx_a, ctx_b],
            )
            assert consumed == 2
            assert frames == [b":1\r\n", b":0\r\n"]
            assert tot() - before == 2
            a_srv.close()
            b_srv.close()
        finally:
            server.close()
            client.shutdown()

    def test_multi_connection_barrier_not_fused(self):
        """A connection mid-MULTI contributes no items to a fused run —
        its command must QUEUE, not execute."""
        client, server = _mk_server(True)
        try:
            _roundtrip(server, [[b"BF.RESERVE", b"xm", b"0.01", b"1000"]])
            a_srv = socket.socket()
            ctx_a = _ConnCtx(a_srv, server=server)
            ctx_m = _ConnCtx(a_srv, server=server)
            ctx_m.in_multi = True
            ctx_m.queued = []
            frames, consumed = server._dispatch_merged(
                [[b"BF.EXISTS", b"xm", b"q"], [b"BF.EXISTS", b"xm", b"q"]],
                [ctx_a, ctx_m],
            )
            assert consumed == 2
            assert frames[0] == b":0\r\n"
            assert frames[1] == b"+QUEUED\r\n"
            assert ctx_m.queued == [[b"BF.EXISTS", b"xm", b"q"]]
            a_srv.close()
        finally:
            server.close()
            client.shutdown()


class TestSlowClient:
    def test_stalled_reader_does_not_block_other_ticks(self):
        client, server = _mk_server(True)
        try:
            big = b"y" * (2 << 20)
            _roundtrip(server, [[b"SET", b"rx-slow-big", big]])
            lazy = socket.create_connection((server.host, server.port))
            lazy.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 16384)
            lazy.sendall(_wire([b"GET", b"rx-slow-big"]))  # never read
            time.sleep(0.3)
            for _ in range(5):
                t0 = time.monotonic()
                assert _roundtrip(server, [[b"PING"]]) == [b"+PONG\r\n"]
                assert time.monotonic() - t0 < 2.0
            lazy.close()
        finally:
            server.close()
            client.shutdown()

    def test_reactor_output_limit_disconnects_stalled_reader(self):
        client, server = _mk_server(True)
        try:
            _roundtrip(server, [[b"SET", b"rx-lim-big", b"z" * (4 << 20)],
                                [b"CONFIG", b"SET", b"client-output-buffer-limit", b"8192",
                                 b"client-output-buffer-soft-seconds", b"1"]])
            lazy = socket.create_connection((server.host, server.port))
            lazy.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 16384)
            lazy.sendall(_wire([b"GET", b"rx-lim-big"]))
            deadline = time.monotonic() + 10
            while server._slow_client_kills == 0 and time.monotonic() < deadline:
                time.sleep(0.05)
            assert server._slow_client_kills == 1
            lazy.close()
        finally:
            server.close()
            client.shutdown()


# -- randomized multi-connection differential soak ---------------------------

_N_CONNS = 6
_N_CMDS = 120


def _seed_cmds():
    """Shared read-only fixtures every soak connection probes: reads on
    them are deterministic AND fuse across connections."""
    cmds = [[b"BF.RESERVE", b"sh-bf", b"0.01", b"4000"]]
    cmds += [[b"BF.ADD", b"sh-bf", b"it%d" % i] for i in range(0, 40, 2)]
    cmds += [[b"SETBIT", b"sh-bs", b"%d" % i, b"1"] for i in range(0, 64, 3)]
    cmds += [[b"SET", b"sh-s%d" % i, b"val-%d" % i] for i in range(4)]
    cmds += [[b"CMS.INITBYDIM", b"sh-cms", b"512", b"4"]]
    cmds += [[b"CMS.INCRBY", b"sh-cms", b"it%d" % i, b"%d" % (i + 1)] for i in range(16)]
    cmds += [[b"PFADD", b"sh-h"] + [b"e%d" % i for i in range(32)]]
    return cmds


def _conn_stream(conn_id: int, rng: random.Random, n: int):
    """Deterministic per-connection stream: reads hit the SHARED
    immutable fixtures (cross-connection fusion), writes stay on keys
    PRIVATE to this connection."""
    p = b"c%d" % conn_id
    cmds = [[b"BF.RESERVE", p + b"-bf", b"0.01", b"2000"],
            [b"LPUSH", p + b"-q", b"seed"]]
    it = lambda: b"it%d" % rng.randrange(40)  # noqa: E731

    def one():
        r = rng.random()
        if r < 0.28:  # shared bloom reads
            if rng.random() < 0.75:
                return [b"BF.EXISTS", b"sh-bf", it()]
            return [b"BF.MEXISTS", b"sh-bf"] + [it() for _ in range(rng.randrange(1, 4))]
        if r < 0.42:  # shared bitset / string / cms / hll reads
            k = rng.random()
            if k < 0.3:
                return [b"GETBIT", b"sh-bs", b"%d" % rng.randrange(64)]
            if k < 0.6:
                return [b"GET", b"sh-s%d" % rng.randrange(4)]
            if k < 0.85:
                return [b"CMS.QUERY", b"sh-cms"] + [it() for _ in range(rng.randrange(1, 4))]
            return [b"PFCOUNT", b"sh-h"]
        if r < 0.60:  # private bloom writes/reads
            if rng.random() < 0.5:
                return [b"BF.ADD", p + b"-bf", it()]
            return [b"BF.EXISTS", p + b"-bf", it()]
        if r < 0.72:  # private bitset
            off = b"%d" % rng.randrange(128)
            if rng.random() < 0.5:
                return [b"SETBIT", p + b"-bs", off, b"1" if rng.random() < 0.8 else b"0"]
            return [b"GETBIT", p + b"-bs", off]
        if r < 0.84:  # private strings
            k = p + b"-s%d" % rng.randrange(3)
            q = rng.random()
            if q < 0.4:
                return [b"SET", k, b"v%d" % rng.randrange(100)]
            if q < 0.9:
                return [b"GET", k]
            return [b"APPEND", k, b"x"]
        if r < 0.90:  # worker-handoff coverage: non-empty blocking pop
            return [b"RPOPLPUSH", p + b"-q", p + b"-q"]
        if r < 0.94:
            return [b"BLPOP", p + b"-q", b"1"]
        if r < 0.97:  # structural barrier on private keys
            return [b"DEL", p + b"-s%d" % rng.randrange(3)]
        return [b"STRLEN", p + b"-s0"]

    cmds += [one() for _ in range(n)]
    # BLPOP consumes the queue seed: re-prime so later BLPOPs stay
    # deterministic (the RPOPLPUSH rotation keeps length constant).
    fixed = []
    for c in cmds:
        fixed.append(c)
        if c[0] == b"BLPOP":
            fixed.append([b"LPUSH", p + b"-q", b"seed"])
    return fixed


def _run_soak(server, streams):
    """Each stream rides its own connection UNPIPELINED (one command in
    flight at a time); returns the concatenated reply bytes per
    connection."""
    results = [None] * len(streams)
    errors = []

    def worker(idx):
        try:
            sock = socket.create_connection((server.host, server.port))
            sock.settimeout(60)
            out = []
            for cmd in streams[idx]:
                sock.sendall(_wire(cmd))
                frames, rest = _recv_replies(sock, 1)
                assert rest == b""
                out.append(frames[0])
            results[idx] = b"".join(out)
            sock.close()
        except Exception as e:  # pragma: no cover - failure surface
            errors.append((idx, e))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(streams))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise AssertionError(f"soak connection failed: {errors[0]}")
    return results


class TestMultiConnDifferentialSoak:
    def _streams(self, seed):
        return [_conn_stream(i, random.Random(seed * 97 + i), _N_CMDS)
                for i in range(_N_CONNS)]

    def test_soak_byte_identical_per_connection(self):
        rx_c, rx_s = _mk_server(True)
        ref_c, ref_s = _mk_server(False)
        jx_c, jx_s = _mk_jax_server(True)
        try:
            for srv in (rx_s, ref_s, jx_s):
                _roundtrip(srv, _seed_cmds())
            streams = self._streams(3)
            got = _run_soak(rx_s, streams)
            want = _run_soak(ref_s, streams)
            jax_got = _run_soak(jx_s, streams)
            for i in range(_N_CONNS):
                assert got[i] == want[i], (
                    f"connection {i} diverged (reactor vs thread-per-connection)")
                assert got[i] == jax_got[i], f"connection {i} diverged from the JAX server"
            assert rx_s.reactor is not None and ref_s.reactor is None
        finally:
            for s_, c_ in ((rx_s, rx_c), (ref_s, ref_c), (jx_s, jx_c)):
                s_.close()
                c_.shutdown()

    def test_soak_byte_identical_under_chaos(self):
        """Chaos error injection at the fused dispatch points: the
        coalescer's retry discipline absorbs injected faults, so both
        serving modes still answer byte-identically per connection."""
        rx_c, rx_s = _mk_server(True, retry_attempts=8)
        ref_c, ref_s = _mk_server(False, retry_attempts=8)
        try:
            for srv in (rx_s, ref_s):
                _roundtrip(srv, _seed_cmds())
            for point in (
                "dispatch.bloom_mixed_keys",
                "dispatch.bloom_mixed_keys_runs",
                "dispatch.bitset_mixed",
                "dispatch.bitset_mixed_runs",
                "dispatch.cms_update_estimate",
            ):
                chaos.inject(point, kind="error", rate=0.03, seed=41)
            streams = self._streams(7)
            got = _run_soak(rx_s, streams)
            want = _run_soak(ref_s, streams)
            for i in range(_N_CONNS):
                assert got[i] == want[i], f"chaos soak diverged (conn {i})"
        finally:
            chaos.clear()
            for s_, c_ in ((rx_s, rx_c), (ref_s, ref_c)):
                s_.close()
                c_.shutdown()

    def test_soak_with_stalled_reader(self):
        """A stalled reader (never reads its big reply) must not block
        the other connections' ticks — they complete their streams."""
        rx_c, rx_s = _mk_server(True)
        try:
            _roundtrip(rx_s, _seed_cmds())
            big = b"z" * (1 << 20)
            _roundtrip(rx_s, [[b"SET", b"sh-stall", big]])
            lazy = socket.create_connection((rx_s.host, rx_s.port))
            lazy.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 16384)
            lazy.sendall(_wire([b"GET", b"sh-stall"]))
            time.sleep(0.2)
            t0 = time.monotonic()
            got = _run_soak(rx_s, self._streams(11))
            assert all(r is not None for r in got)
            assert time.monotonic() - t0 < 120
            lazy.close()
        finally:
            rx_s.close()
            rx_c.shutdown()


class TestRequireReactorEnv:
    def test_require_reactor_env_guards_silent_fallback(self, monkeypatch):
        """RTPU_REQUIRE_REACTOR turns a reactor-init failure into a hard
        error instead of a silent thread-per-connection fallback; without
        it the server falls back and still serves."""
        import redisson_tpu_torch.serve.reactor as reactor_mod

        client = rt.create(rt.Config().use_gpu_sketch(device="cpu", min_bucket=64))
        try:
            monkeypatch.setattr(
                reactor_mod.ReactorPool, "__init__",
                lambda self, *a, **k: (_ for _ in ()).throw(OSError("no epoll")),
            )
            monkeypatch.delenv("RTPU_REQUIRE_REACTOR", raising=False)
            server = RespServer(client)
            try:
                assert server.reactor is None
                assert _roundtrip(server, [[b"PING"]]) == [b"+PONG\r\n"]
            finally:
                server.close()
            monkeypatch.setenv("RTPU_REQUIRE_REACTOR", "1")
            with pytest.raises(OSError):
                RespServer(client)
        finally:
            client.shutdown()
