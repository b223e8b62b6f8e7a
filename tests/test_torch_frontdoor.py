"""The port's front-door vectorization against the JAX package's.

Counterparts of ``tests/test_frontdoor.py``: fusing runs of adjacent
pipelined commands into single engine calls must be INVISIBLE on the
wire.  Each fused-run case sends the same pipeline to a JAX
``RespServer`` (CPU backend) and a port ``RespServer`` (``device="cpu"``)
and requires equal reply bytes, plus the case's literal expectations.
The randomized differential soak holds the port's fused server to its
own sequential (``resp_vectorize=False``) arm and to the JAX server,
also under chaos at the fused dispatch points; a seeded config-6 stream
(``chip_smoke.config6_batches``, four pipelined connections) is
byte-identical per connection between the two packages' servers, with
the vectorizer on and off.  ``TestRespOverload`` mirrors the RESP cases
of ``tests/test_overload.py``.
"""

import random
import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
from redisson_tpu.serve.resp import RespServer as JaxRespServer  # noqa: E402
from redisson_tpu_torch import chaos  # noqa: E402
from redisson_tpu_torch.serve.resp import RespServer  # noqa: E402
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


@pytest.fixture(autouse=True)
def _chaos_off():
    chaos.clear()
    yield
    chaos.clear()


def _recv_replies(sock, n, timeout=60.0):
    """Read exactly ``n`` complete reply frames; returns (frames, rest)."""
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
            raise AssertionError(
                f"connection closed with {len(frames)}/{n} replies"
            )
        data += chunk
    return frames, data[pos:]


def _mk_server(vectorize: bool, retry_attempts=None, **kw):
    cfg = rt.Config().use_gpu_sketch(device="cpu", min_bucket=64, **kw)
    cfg.resp_vectorize = vectorize
    if retry_attempts is not None:
        cfg.retry_attempts = retry_attempts
        cfg.retry_interval_ms = 5
    client = rt.create(cfg)
    return client, RespServer(client)


def _mk_jax_server(vectorize: bool):
    cfg = redisson_tpu.Config().use_tpu_sketch(min_bucket=64)
    cfg.resp_vectorize = vectorize
    client = redisson_tpu.create(cfg)
    return client, JaxRespServer(client)


def _roundtrip(server, cmds, chunks=None, sock=None):
    """Send ``cmds`` pipelined (optionally split at ``chunks`` byte
    offsets) and return the reply frames."""
    own = sock is None
    if own:
        sock = socket.create_connection((server.host, server.port))
    try:
        payload = b"".join(_wire(c) for c in cmds)
        if chunks:
            pos = 0
            for cut in chunks:
                sock.sendall(payload[pos:cut])
                pos = cut
                time.sleep(0.001)
            sock.sendall(payload[pos:])
        else:
            sock.sendall(payload)
        frames, rest = _recv_replies(sock, len(cmds))
        assert rest == b""
        return frames
    finally:
        if own:
            sock.close()


@pytest.fixture(scope="module")
def vec():
    """A vectorizing port server and a JAX server, side by side."""
    client, server = _mk_server(True)
    jclient, jserver = _mk_jax_server(True)
    yield client, server, jserver
    server.close()
    client.shutdown()
    jserver.close()
    jclient.shutdown()


def _row(client, name):
    """A sketch's pool row as uint32 words (either package)."""
    eng = client._engine
    if hasattr(eng, "_drain"):
        eng._drain()
    e = eng.registry.lookup(name)
    return np.asarray(eng.executor.read_row(e.pool, e.row)).view(np.uint32)


def _both(vec, cmds):
    _client, server, jserver = vec
    frames = _roundtrip(server, cmds)
    assert frames == _roundtrip(jserver, cmds)
    return frames


class TestFusedRuns:
    def test_bf_mixed_run_exact_semantics(self, vec):
        _client, server, _ = vec
        cmds = [[b"BF.RESERVE", b"fd-f1", b"0.01", b"5000"]]
        cmds += [[b"BF.ADD", b"fd-f1", b"a"]]
        cmds += [[b"BF.EXISTS", b"fd-f1", b"a"]]   # added one cmd ago
        cmds += [[b"BF.ADD", b"fd-f1", b"a"]]      # duplicate: 0
        cmds += [[b"BF.EXISTS", b"fd-f1", b"zzz-never"]]
        cmds += [[b"BF.MADD", b"fd-f1", b"b", b"a", b"c"]]
        cmds += [[b"BF.MEXISTS", b"fd-f1", b"a", b"b", b"c", b"nope2"]]
        frames = _both(vec, cmds)
        assert frames[0] == b"+OK\r\n"
        assert frames[1] == b":1\r\n"
        assert frames[2] == b":1\r\n"   # intra-run read-your-writes
        assert frames[3] == b":0\r\n"   # duplicate add
        assert frames[4] == b":0\r\n"
        assert frames[5] == b"*3\r\n:1\r\n:0\r\n:1\r\n"  # a already in
        assert frames[6] == b"*4\r\n:1\r\n:1\r\n:1\r\n:0\r\n"
        # The whole mixed span fused into runs.
        st = server.obs.resp_fused_cmds
        assert sum(int(c.value) for _, c in st.items()) >= 6

    def test_bitset_run_prev_values(self, vec):
        cmds = [
            [b"SETBIT", b"fd-bs", b"5", b"1"],
            [b"GETBIT", b"fd-bs", b"5"],
            [b"SETBIT", b"fd-bs", b"5", b"0"],  # prev 1
            [b"GETBIT", b"fd-bs", b"5"],
            [b"SETBIT", b"fd-bs", b"9", b"1"],
            [b"GETBIT", b"fd-bs", b"9"],
            [b"GETBIT", b"fd-bs", b"1000"],     # out of range: 0
        ]
        assert _both(vec, cmds) == [
            b":0\r\n", b":1\r\n", b":1\r\n", b":0\r\n",
            b":0\r\n", b":1\r\n", b":0\r\n",
        ]

    def test_get_run_and_response_cache(self, vec):
        cmds = [[b"SET", b"fd-k", b"v1"]]
        cmds += [[b"GET", b"fd-k"]] * 5
        cmds += [[b"SET", b"fd-k", b"v2"]]     # epoch bump mid-batch
        cmds += [[b"GET", b"fd-k"]] * 3
        cmds += [[b"MGET", b"fd-k", b"fd-missing"]]
        frames = _both(vec, cmds)
        assert frames[0] == b"+OK\r\n"
        assert all(f == b"$2\r\nv1\r\n" for f in frames[1:6])
        assert frames[6] == b"+OK\r\n"
        # The cached v1 reply must NOT survive the write.
        assert all(f == b"$2\r\nv2\r\n" for f in frames[7:10])
        assert frames[10] == b"*2\r\n$2\r\nv2\r\n$-1\r\n"

    def test_mixed_run_read_frames_never_cached_stale(self, vec):
        # A mixed fused run computes its read frames in run order, so a
        # GETBIT that PRECEDED a same-key SETBIT must not be installed
        # into the response cache.
        cmds = [
            [b"GETBIT", b"fd-stale", b"5"],      # 0 (pre-write)
            [b"SETBIT", b"fd-stale", b"5", b"1"],
            [b"PING"],                            # barrier, no epoch bump
            [b"GETBIT", b"fd-stale", b"5"],      # must be 1, never cached 0
        ]
        assert _both(vec, cmds) == [b":0\r\n", b":0\r\n", b"+PONG\r\n", b":1\r\n"]

    def test_get_run_respects_reply_buffer_bound(self, vec):
        # A fused GET run stops buffering at the 1 MB reply bound (the
        # tail re-queues) — and every reply still arrives, in order.
        big = b"x" * (300 << 10)
        frames = _both(vec, [[b"SET", b"fd-big", big]] + [[b"GET", b"fd-big"]] * 8)
        assert frames[0] == b"+OK\r\n"
        want = b"$%d\r\n%s\r\n" % (len(big), big)
        assert all(f == want for f in frames[1:])

    def test_uninitialized_filter_errors_per_command(self, vec):
        cmds = [
            [b"BF.EXISTS", b"fd-missing-f", b"x"],
            [b"BF.ADD", b"fd-missing-f", b"y"],
            [b"BF.EXISTS", b"fd-missing-f", b"z"],
        ]
        frames = _both(vec, cmds)
        # One fused call raised once; every command still gets its own
        # error frame — same bytes the sequential path produces.
        assert all(f.startswith(b"-ERR") for f in frames)
        assert len(set(frames)) == 1

    def test_multi_exec_inside_pipeline(self, vec):
        cmds = [
            [b"SET", b"fd-m", b"1"],
            [b"GET", b"fd-m"],
            [b"MULTI"],
            [b"GET", b"fd-m"],
            [b"SET", b"fd-m", b"2"],
            [b"EXEC"],
            [b"GET", b"fd-m"],
        ]
        frames = _both(vec, cmds)
        assert frames[2] == b"+OK\r\n"
        assert frames[3] == frames[4] == b"+QUEUED\r\n"
        assert frames[5] == b"*2\r\n$1\r\n1\r\n+OK\r\n"
        assert frames[6] == b"$1\r\n2\r\n"


def test_vectorize_off_still_correct():
    client, server = _mk_server(False)
    try:
        cmds = [[b"BF.RESERVE", b"nf", b"0.01", b"100"]]
        cmds += [[b"BF.ADD", b"nf", b"x"], [b"BF.EXISTS", b"nf", b"x"]]
        frames = _roundtrip(server, cmds)
        assert frames == [b"+OK\r\n", b":1\r\n", b":1\r\n"]
        fused = sum(int(c.value) for _, c in server.obs.resp_fused_cmds.items())
        assert fused == 0
    finally:
        server.close()
        client.shutdown()


# -- randomized differential soak --------------------------------------------


def _gen_stream(rng: random.Random, n_cmds: int):
    """Interleaved pipelined command stream: fusable reads/writes,
    structural barriers, repeated reads (cache hits) — everything
    deterministic (no TTLs, no randomized replies)."""
    filters = [b"soak-f0", b"soak-f1"]
    bitsets = [b"soak-b0", b"soak-b1"]
    strkeys = [b"soak-s%d" % i for i in range(4)]
    cmds = [[b"BF.RESERVE", f, b"0.01", b"4000"] for f in filters]
    item = lambda: b"it%d" % rng.randrange(60)  # noqa: E731

    def one():
        r = rng.random()
        if r < 0.30:
            f = rng.choice(filters)
            k = rng.random()
            if k < 0.35:
                return [b"BF.ADD", f, item()]
            if k < 0.75:
                return [b"BF.EXISTS", f, item()]
            if k < 0.88:
                return [b"BF.MADD", f] + [item() for _ in range(rng.randrange(1, 5))]
            return [b"BF.MEXISTS", f] + [item() for _ in range(rng.randrange(1, 5))]
        if r < 0.55:
            b = rng.choice(bitsets)
            off = b"%d" % rng.randrange(256)
            if rng.random() < 0.5:
                return [b"SETBIT", b, off, b"1" if rng.random() < 0.8 else b"0"]
            return [b"GETBIT", b, off]
        if r < 0.80:
            s = rng.choice(strkeys)
            k = rng.random()
            if k < 0.3:
                return [b"SET", s, b"v%d" % rng.randrange(1000)]
            if k < 0.8:
                return [b"GET", s]
            if k < 0.9:
                return [b"MGET"] + rng.sample(strkeys, 2)
            return [b"STRLEN", s]
        if r < 0.86:  # structural barriers
            k = rng.random()
            if k < 0.4:
                return [b"DEL", rng.choice(strkeys)]
            if k < 0.7:
                return [b"DEL", rng.choice(filters)]
            return [b"BF.RESERVE", rng.choice(filters), b"0.01", b"4000"]
        if r < 0.93:
            return [b"PFADD", b"soak-h", item()]
        if r < 0.97:
            return [b"PFCOUNT", b"soak-h"]
        return [b"APPEND", rng.choice(strkeys), b"x"]

    cmds += [one() for _ in range(n_cmds)]
    return cmds


def _run_stream(server, cmds, rng: random.Random):
    """Send the stream in random chunk splits (varying the parse-ahead
    batch boundaries) and return the concatenated reply bytes."""
    payload = b"".join(_wire(c) for c in cmds)
    cuts = sorted(rng.sample(range(1, len(payload)), min(12, len(payload) - 1)))
    return b"".join(_roundtrip(server, cmds, chunks=cuts))


class TestDifferentialSoak:
    def test_soak_byte_identical(self):
        vc, vs = _mk_server(True)
        rc, rs = _mk_server(False)
        jc, js = _mk_jax_server(True)
        try:
            for seed in (11, 23):
                rng = random.Random(seed)
                cmds = _gen_stream(rng, 400)
                got = _run_stream(vs, cmds, random.Random(seed + 1))
                want = _run_stream(rs, cmds, random.Random(seed + 2))
                jax_got = _run_stream(js, cmds, random.Random(seed + 3))
                assert got == want, f"fused vs sequential diverged (seed {seed})"
                assert got == jax_got, f"port vs JAX server diverged (seed {seed})"
                for c_ in (vc, rc, jc):
                    c_.get_keys().flushall()
        finally:
            for s_, c_ in ((vs, vc), (rs, rc), (js, jc)):
                s_.close()
                c_.shutdown()

    def test_soak_byte_identical_under_chaos(self):
        """Fault injection at the fused dispatch points: the coalescer's
        retry discipline absorbs injected dispatch errors, so the fused
        and sequential servers still answer byte-identically."""
        # Deep retry budget: the soak asserts EQUALITY, so an exhausted
        # retry must be statistically impossible, not just rare.
        vc, vs = _mk_server(True, retry_attempts=8)
        rc, rs = _mk_server(False, retry_attempts=8)
        try:
            for point in (
                "dispatch.bloom_mixed_keys",
                "dispatch.bloom_mixed_keys_runs",
                "dispatch.bitset_mixed",
                "dispatch.bitset_mixed_runs",
            ):
                chaos.inject(point, kind="error", rate=0.04, seed=97)
            rng = random.Random(5)
            cmds = _gen_stream(rng, 300)
            got = _run_stream(vs, cmds, random.Random(6))
            want = _run_stream(rs, cmds, random.Random(7))
            assert got == want, "chaos soak diverged"
            assert sum(chaos.counts().values()) > 0, "no fault was injected"
        finally:
            chaos.clear()
            vs.close()
            vc.shutdown()
            rs.close()
            rc.shutdown()


# -- config 6's stream, the two packages' servers -----------------------------


@pytest.mark.parametrize("vectorize", [True, False], ids=["fused", "sequential"])
def test_config6_stream_byte_identical_to_jax_per_connection(vectorize):
    """Config 6's seeded traffic (four pipelined connections, 256-deep
    batches of zipf(1.3) spans over Bloom, strings and a bitmap): after a
    warm pass in which every write of the stream lands once, each
    connection's reply stream is byte-identical between the port's server
    and the JAX package's, and so are the filter and bitmap rows."""
    P, nb, depth = 4, 2, 256
    batches = chip_smoke.config6_batches(3, P * nb, depth)
    per_conn = [batches[c * nb:(c + 1) * nb] for c in range(P)]
    tc, ts = _mk_server(vectorize)
    jc, js = _mk_jax_server(vectorize)
    try:
        got = {}
        for name, srv in (("torch", ts), ("jax", js)):
            _roundtrip(srv, chip_smoke.config6_seed_cmds())
            chip_smoke.config6_pass(srv, per_conn)
            got[name], _ = chip_smoke.config6_pass(srv, per_conn)
        for c in range(P):
            assert got["torch"][c] == got["jax"][c], f"connection {c} diverged"
        for name in ("fd-bf", "fd-bs"):
            assert np.array_equal(_row(jc, name), _row(tc, name)), name
        if vectorize:
            fused = sum(int(c.value) for _, c in ts.obs.resp_fused_cmds.items())
            assert fused > 0
    finally:
        ts.close()
        tc.shutdown()
        js.close()
        jc.shutdown()


# -- the RESP overload surface (tests/test_overload.py TestRespOverload) -------


class _Resp:
    """Minimal RESP2 wire client (the test_resp_server idiom)."""

    def __init__(self, host, port, timeout=10):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self._buf = b""

    def cmd(self, *args):
        out = b"*" + str(len(args)).encode() + b"\r\n"
        for a in args:
            if not isinstance(a, bytes):
                a = str(a).encode()
            out += b"$" + str(len(a)).encode() + b"\r\n" + a + b"\r\n"
        self.sock.sendall(out)
        return self._read()

    def _recv(self):
        data = self.sock.recv(65536)
        if not data:
            raise ConnectionError("closed")
        self._buf += data

    def _line(self):
        while b"\r\n" not in self._buf:
            self._recv()
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read(self):
        line = self._line()
        t, body = line[:1], line[1:]
        if t == b"+":
            return body.decode()
        if t == b"-":
            raise RuntimeError(body.decode())
        if t == b":":
            return int(body)
        if t == b"$":
            n = int(body)
            if n < 0:
                return None
            while len(self._buf) < n + 2:
                self._recv()
            out, self._buf = self._buf[:n], self._buf[n + 2:]
            return out
        if t == b"*":
            n = int(body)
            return None if n < 0 else [self._read() for _ in range(n)]
        raise RuntimeError(f"bad reply {t!r}")

    def close(self):
        self.sock.close()


def make_client(**kw):
    kw.setdefault("batch_window_us", 100)
    kw.setdefault("min_bucket", 64)
    # Keep breakers out of the way: a surprise degradation would change
    # which layer answers.
    kw.setdefault("breaker_failure_threshold", 10_000)
    cfg = rt.Config().use_gpu_sketch(device="cpu", **kw)
    cfg.retry_attempts = 2
    cfg.retry_interval_ms = 5
    return rt.create(cfg)


@pytest.fixture
def served():
    client = make_client()
    server = RespServer(client)
    conn = _Resp(server.host, server.port)
    yield client, server, conn
    conn.close()
    server.close()
    client.shutdown()


class TestRespOverload:
    def test_client_deadline_admission_shed_and_clear(self, served):
        _client, _server, conn = served
        conn.cmd("BF.RESERVE", "f", "0.01", "1000")
        conn.cmd("BF.ADD", "f", "warm")
        chaos.inject("overload.pressure", kind="pressure", rate=1.0, latency_s=30.0)
        assert conn.cmd("CLIENT", "DEADLINE") == b"default"
        assert conn.cmd("CLIENT", "DEADLINE", "50") == "OK"
        assert conn.cmd("CLIENT", "DEADLINE") == b"50"
        with pytest.raises(RuntimeError, match="BUSY.*deadline"):
            conn.cmd("BF.ADD", "f", "x")
        # CLIENT DEADLINE 0: no deadline -> no admission check -> flows.
        assert conn.cmd("CLIENT", "DEADLINE", "0") == "OK"
        assert conn.cmd("BF.ADD", "f", "x") in (0, 1)
        chaos.clear()

    def test_default_op_deadline_from_config(self):
        client = make_client(op_deadline_ms=50)
        server = RespServer(client)
        conn = _Resp(server.host, server.port)
        try:
            conn.cmd("CLIENT", "DEADLINE", "0")
            conn.cmd("BF.RESERVE", "f", "0.01", "1000")
            conn.cmd("BF.ADD", "f", "warm")
            conn.cmd("CLIENT", "DEADLINE", "-1")
            chaos.inject("overload.pressure", kind="pressure", rate=1.0, latency_s=30.0)
            with pytest.raises(RuntimeError, match="BUSY.*deadline"):
                conn.cmd("BF.ADD", "f", "x")
        finally:
            chaos.clear()
            conn.close()
            server.close()
            client.shutdown()

    def test_ingress_watermark_sheds_nonexempt_only(self, served):
        client, server, conn = served
        conn.cmd("SET", "k", "v")
        c = client._engine.coalescer
        server.admission_watermark = 0.5
        # Simulate a deep queue (white-box: pressure reads _queued_ops;
        # the idle flush thread won't touch a fabricated count).
        c._queued_ops += 100 * c.max_queued_ops
        try:
            with pytest.raises(RuntimeError, match="BUSY.*overloaded"):
                conn.cmd("GET", "k")
            with pytest.raises(RuntimeError, match="BUSY.*overloaded"):
                conn.cmd("BF.ADD", "f", "x")
            # Exempt: the operator can still see and fix the overload.
            assert conn.cmd("PING") == "PONG"
            assert b"overload_pressure" in conn.cmd("INFO", "overload")
            assert conn.cmd("CONFIG", "GET", "admission-watermark")
            # MULTI/EXEC cannot bypass the door: the transaction is
            # judged (and consumed) at EXEC.
            assert conn.cmd("MULTI") == "OK"
            assert conn.cmd("SET", "k", "w") == "QUEUED"
            with pytest.raises(RuntimeError, match="BUSY.*transaction"):
                conn.cmd("EXEC")
            with pytest.raises(RuntimeError, match="without MULTI"):
                conn.cmd("EXEC")
        finally:
            c._queued_ops -= 100 * c.max_queued_ops
        assert conn.cmd("GET", "k") == b"v"  # the shed SET never ran
        shed = {lv[0]: int(v.value) for lv, v in server.obs.resp_ingress_shed.items()}
        assert shed.get("pressure", 0) >= 3

    def test_tenant_over_quota_shed_at_ingress(self, served):
        client, server, conn = served
        conn.cmd("BF.RESERVE", "burst", "0.01", "1000")
        gov = client._engine.governor
        gov.set_limits(rate_limit=1.0, burst=2.0)
        try:
            for i in range(8):
                try:
                    conn.cmd("BF.MADD", "burst", *[f"k{i}-{j}" for j in range(4)])
                except RuntimeError:
                    pass
            with pytest.raises(RuntimeError, match="BUSY.*tenant"):
                conn.cmd("BF.ADD", "burst", "more")
            assert conn.cmd("PING") == "PONG"
        finally:
            gov.set_limits(rate_limit=0.0, burst=0.0)

    def test_config_set_validation_and_live_apply(self, served):
        client, server, conn = served
        for key, bad in (
            ("op-deadline-ms", "-5"),
            ("admission-watermark", "0"),
            ("admission-watermark", "-0.5"),
            ("admission-watermark", "1.5"),
            ("fetch-timeout-ms", "0"),
            ("tenant-rate-limit", "-1"),
            ("client-output-buffer-limit", "-1"),
            ("client-output-buffer-soft-seconds", "-2"),
            ("op-deadline-ms", "abc"),
            ("appendonly", "yes"),
            ("no-such-knob", "1"),
        ):
            with pytest.raises(RuntimeError):
                conn.cmd("CONFIG", "SET", key, bad)
        assert conn.cmd("CONFIG", "SET", "tenant-rate-limit", "0.5") == "OK"
        assert client._engine.governor.rate_limit == 0.5
        assert conn.cmd(
            "CONFIG", "SET", "op-deadline-ms", "250",
            "admission-watermark", "0.75",
            "fetch-timeout-ms", "30000",
            "tenant-rate-limit", "5000",
            "tenant-max-inflight", "4096",
            "client-output-buffer-limit", "65536",
            "client-output-buffer-soft-seconds", "2.5",
        ) == "OK"
        assert server.op_deadline_ms == 250
        assert server.admission_watermark == 0.75
        assert client._engine.coalescer.fetch_timeout_s == 30.0
        gov = client._engine.governor
        assert gov.rate_limit == 5000 and gov.max_inflight == 4096
        assert server.output_buffer_limit == 65536
        assert server.output_buffer_soft_seconds == 2.5
        assert conn.cmd("CONFIG", "GET", "op-deadline-ms") == [b"op-deadline-ms", b"250"]
        assert conn.cmd("CONFIG", "GET", "appendonly") == [b"appendonly", b"no"]

    def test_info_overload_section(self, served):
        _client, _server, conn = served
        info = conn.cmd("INFO", "overload").decode()
        for key in (
            "overload_op_deadline_ms", "overload_admission_watermark",
            "overload_pressure", "overload_est_wait_us",
            "overload_shed_ops", "overload_deadline_exceeded",
            "overload_tenant_throttled", "overload_fetch_timeouts",
            "overload_slow_client_disconnects",
            "overload_output_buffer_limit",
        ):
            assert key in info, key
        # Default INFO includes the section too.
        assert "# Overload" in conn.cmd("INFO").decode()

    def test_slow_client_disconnected_at_output_buffer_limit(self, served):
        _client, server, conn = served
        big = b"x" * (4 << 20)
        conn.cmd("SET", "big", big)
        assert conn.cmd(
            "CONFIG", "SET", "client-output-buffer-limit", "8192",
            "client-output-buffer-soft-seconds", "1",
        ) == "OK"
        lazy = socket.create_connection((server.host, server.port), timeout=10)
        lazy.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 16384)
        lazy.sendall(b"*2\r\n$3\r\nGET\r\n$3\r\nbig\r\n")
        deadline = time.monotonic() + 10.0
        while server._slow_client_kills == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert server._slow_client_kills > 0, "slow client was not disconnected"
        lazy.close()
        info = conn.cmd("INFO", "overload").decode()
        assert "overload_slow_client_disconnects:0" not in info
        # A well-behaved client still gets the big value.
        assert conn.cmd("GET", "big") == big

    def test_hard_only_limit_still_disconnects_underlimit_stall(self):
        """With ONLY the hard byte limit set, a stall whose pending
        remainder is under the limit still falls back to the idle
        timeout instead of holding the connection forever."""
        client = make_client()
        server = RespServer(client, idle_timeout_s=1.0)
        conn = _Resp(server.host, server.port)
        try:
            conn.cmd("SET", "big", b"x" * (4 << 20))
            assert conn.cmd(
                "CONFIG", "SET", "client-output-buffer-limit", str(64 << 20),
            ) == "OK"
            lazy = socket.create_connection((server.host, server.port), timeout=10)
            lazy.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 16384)
            lazy.sendall(b"*2\r\n$3\r\nGET\r\n$3\r\nbig\r\n")
            deadline = time.monotonic() + 10.0
            while server._slow_client_kills == 0 and time.monotonic() < deadline:
                time.sleep(0.05)
            assert server._slow_client_kills > 0
            lazy.close()
        finally:
            conn.close()
            server.close()
            client.shutdown()

    def test_fast_clients_unaffected_by_buffer_limits(self, served):
        _client, server, conn = served
        conn.cmd("CONFIG", "SET", "client-output-buffer-limit", "4096",
                 "client-output-buffer-soft-seconds", "1")
        conn.cmd("SET", "k", "v" * 100_000)
        for _ in range(5):
            assert len(conn.cmd("GET", "k")) == 100_000
        assert server._slow_client_kills == 0
