"""RESP front door — the serving layer: a RESP2/RESP3 TCP server over the
client, so stock Redis clients (redis-cli, redis-py, a stock Redisson) can
drive the keyspace and the sketch objects without the Python API.  The
port's copy of ``redisson_tpu/serve/resp.py``, with the same machinery
(wire codecs, the reader, slow-client bounds, ingress shedding, the
write epoch, fused pipelined runs and the response cache) and the same
reply bytes, for the command families this package carries:

  PING ECHO QUIT SELECT RESET AUTH HELLO CLIENT COMMAND MULTI EXEC DISCARD
  DEL EXISTS EXPIRE PEXPIRE EXPIREAT PEXPIREAT TTL PTTL PERSIST RENAME
  RENAMENX RANDOMKEY TYPE DUMP RESTORE KEYS SCAN DBSIZE FLUSHALL COPY
  GET SET MGET MSET SETNX SETEX PSETEX GETSET GETDEL GETEX APPEND STRLEN
  GETRANGE SETRANGE  INCR INCRBY DECR INCRBYFLOAT
  SETBIT GETBIT BITCOUNT BITPOS  PFADD PFCOUNT PFMERGE
  BF.RESERVE BF.ADD BF.MADD BF.EXISTS BF.MEXISTS BF.INFO
  CMS.INITBYDIM CMS.INCRBY CMS.QUERY CMS.MERGE CMS.INFO
  TOPK.RESERVE TOPK.ADD TOPK.INCRBY TOPK.QUERY TOPK.COUNT TOPK.LIST TOPK.INFO
  SAVE BGSAVE LASTSAVE INFO CONFIG DEBUG OBJECT
  LPUSH RPUSH LPUSHX RPUSHX LPOP RPOP LLEN LRANGE LINDEX LSET LREM
  LTRIM RPOPLPUSH LMOVE LPOS  BLPOP BRPOP        (condvar blocking pops)
  HSET HGET HDEL HLEN HGETALL HMGET HKEYS HVALS HEXISTS HSETNX HINCRBY
  HRANDFIELD
  SADD SREM SISMEMBER SCARD SMEMBERS SMISMEMBER SPOP SRANDMEMBER SMOVE
  SINTER SUNION SDIFF SINTERSTORE SUNIONSTORE SDIFFSTORE SINTERCARD
  ZADD ZSCORE ZRANGE ZCARD ZREM ZINCRBY ZRANK ZCOUNT ZRANGEBYSCORE
  ZPOPMIN ZPOPMAX ZREVRANGE ZREVRANK ZREMRANGEBYSCORE ZRANDMEMBER
  ZUNIONSTORE ZINTERSTORE ZRANGEBYLEX        (weights/aggregate; lex)
  HSCAN SSCAN ZSCAN                  (tagged resume cursors, MATCH/COUNT)
  XADD XLEN XRANGE XREVRANGE XDEL XTRIM XREAD XREADGROUP XGROUP XACK
  XPENDING XCLAIM XAUTOCLAIM XINFO                 (streams + groups/PEL)
  GEOADD GEOPOS GEODIST GEOHASH GEOSEARCH GEOSEARCHSTORE
  PUBLISH SUBSCRIBE UNSUBSCRIBE           (push replies; '>' on RESP3)
  WAIT BGREWRITEAOF REPLCONF RTPU.PSYNC RTPU.REPLFETCH FAILOVER
                    (the journal fence and the replication stream; a
                    replica answers writes -READONLY)

Any other command (scripting and cluster verbs) answers
exactly as the JAX package answers a command it lacks: ``-ERR unknown
command 'NAME'``.

Values travel as raw bytes (RESP bulk strings) through a ByteArray-style
codec boundary: what a foreign client SETs is exactly what it GETs.  The
reactor (serve/reactor.py) serves connections by default; the
thread-per-connection path stays selectable (``resp_reactor=False``).
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Optional

import numpy as np

from redisson_tpu_torch import chaos
from redisson_tpu_torch import overload as _overload
from redisson_tpu_torch.cluster.slots import command_keys as _command_keys
from redisson_tpu_torch.executor.failures import (
    DeadlineExceededError,
    TenantThrottledError,
)


class RespError(Exception):
    pass


class ProtocolError(Exception):
    """Unrecoverable wire-format violation: reply once, then close (the
    Redis 'Protocol error' behavior)."""


def _encode_simple(s: str) -> bytes:
    return b"+" + s.encode() + b"\r\n"


# Error codes that travel verbatim as their own RESP code (Redis sends
# '-BUSYKEY ...', not '-ERR BUSYKEY ...').  An explicit allowlist — a
# shape heuristic would hijack messages that merely START with a command
# name ('EXEC without MULTI' must stay '-ERR EXEC without MULTI').
_ERROR_CODES = (
    "BUSYKEY", "NOPROTO", "WRONGTYPE", "NOSCRIPT", "EXECABORT",
    "NOAUTH", "WRONGPASS", "NOGROUP", "BUSYGROUP", "BUSY", "NOTBUSY",
    # Cluster redirect protocol: these travel verbatim so
    # stock cluster clients parse the slot/address payload.
    "MOVED", "ASK", "CROSSSLOT", "TRYAGAIN", "CLUSTERDOWN",
    # Per-core front door: a broken in-node handoff leg
    # surfaces with its own code so clients can retry-distinguish it.
    "HANDOFFBROKEN",
    # Replication + failover: NOJOURNAL = the primary has no
    # journal to stream; NOBACKLOG = the requested offset fell off every
    # retention tier (replica must FULLRESYNC); READONLY = write against
    # a replica (verbatim Redis code); STALEREAD = the bounded-staleness
    # gate refused a replica read whose lag exceeds the configured bound.
    "NOJOURNAL", "NOBACKLOG", "READONLY", "STALEREAD",
)

# Commands EXEMPT from ingress shedding (the overload control plane):
# connection handshake, admin, and introspection — exactly the surface an
# operator needs to SEE and FIX an overload (shedding INFO /
# CONFIG during the incident they diagnose would be self-defeating).
# Everything else is refused with -BUSY once queue pressure crosses the
# admission watermark.
_SHED_EXEMPT = frozenset((
    "PING", "ECHO", "AUTH", "HELLO", "QUIT", "RESET", "SELECT",
    "INFO", "CONFIG", "CLIENT", "COMMAND", "SLOWLOG", "DEBUG",
    "SHUTDOWN", "SCRIPT", "WAIT", "MULTI", "EXEC", "DISCARD",
    "SUBSCRIBE", "UNSUBSCRIBE",
    # Residency introspection: OBJECT FREQ/IDLETIME/ENCODING
    # is how an operator reads the tier ladder DURING the overload that
    # heat-based demotion exists to survive.
    "OBJECT",
    # Cluster control plane: topology surgery and the
    # per-key migration pump must keep running DURING an overload —
    # resharding is how an operator relieves one.
    "CLUSTER", "ASKING", "MIGRATE",
    # Fleet telemetry plane: the trace/latency/monitor
    # surfaces are exactly what an operator reads DURING the overload,
    # and the RTPU.TRACE prelude is metadata, not work.
    "LATENCY", "TRACE", "MONITOR", "RTPU.TRACE",
    # Load-attribution plane: HOTKEYS is how an operator
    # finds the key causing the overload being shed.
    "HOTKEYS",
    # Flight recorder: the causal event timeline is exactly
    # what an operator replays DURING the incident being shed around.
    "EVENTS",
    # Replication + failover plane: the stream, the acks,
    # and the cluster bus must keep flowing DURING an overload — a shed
    # replication fetch turns node pressure into replica lag, and a
    # shed CLUSTERPING turns it into a spurious failover.
    "REPLCONF", "RTPU.PSYNC", "RTPU.REPLFETCH", "RTPU.CLUSTERPING",
    "RTPU.FAILOVER.AUTH", "RTPU.TAKEOVER", "FAILOVER",
))

# -- front-door vectorization tables ----------------------

# Commands that may not be dispatched from inside a buffered pipelined
# batch: blocking commands would hold earlier replies hostage; pub/sub
# handlers write to the socket themselves (their pushes must not overtake
# buffered replies).
_PIPELINE_STOP = frozenset((
    b"BLPOP", b"BRPOP", b"XREAD", b"XREADGROUP",
    b"SUBSCRIBE", b"UNSUBSCRIBE",
    # MONITOR turns the connection into a push stream, like
    # SUBSCRIBE — its ack must not overtake buffered replies, and the
    # reactor hands it to a worker through the same _DETACH gate.
    b"MONITOR",
))

# NON-MUTATING commands: dispatching one cannot change any keyspace-read
# result, so it does not bump the server's write epoch (the response
# cache's invalidation clock).  Conservative ALLOWLIST — anything absent
# counts as a write.
_NONMUTATING = frozenset((
    "GET", "MGET", "STRLEN", "GETRANGE", "EXISTS", "TTL", "PTTL", "TYPE",
    "KEYS", "DBSIZE", "RANDOMKEY", "GETBIT", "BITCOUNT", "BITPOS",
    "PFCOUNT", "BF.EXISTS", "BF.MEXISTS", "BF.INFO", "CMS.QUERY",
    "CMS.INFO", "TOPK.QUERY", "TOPK.COUNT", "TOPK.LIST", "TOPK.INFO",
    "LLEN", "LRANGE", "LINDEX", "LPOS", "HGET", "HMGET", "HGETALL",
    "HKEYS", "HVALS", "HLEN", "HEXISTS", "HRANDFIELD", "SCARD",
    "SISMEMBER", "SMISMEMBER", "SMEMBERS", "SRANDMEMBER", "SINTER",
    "SUNION", "SDIFF", "SINTERCARD", "ZSCORE", "ZRANGE", "ZCARD",
    "ZRANK", "ZCOUNT", "ZRANGEBYSCORE", "ZREVRANGE", "ZREVRANK",
    "ZRANGEBYLEX", "ZRANDMEMBER", "XLEN", "XRANGE", "XREVRANGE", "XINFO",
    "XPENDING", "GEOPOS", "GEODIST", "GEOHASH", "GEOSEARCH", "HSCAN",
    "SSCAN", "ZSCAN", "SCAN", "OBJECT", "DUMP", "PING", "ECHO", "SELECT",
    "TIME", "COMMAND", "CLIENT", "INFO", "SLOWLOG", "WAIT", "AUTH",
    "HELLO", "QUIT", "SAVE", "BGSAVE", "LASTSAVE", "BGREWRITEAOF",
    "ASKING", "LATENCY", "TRACE", "MONITOR", "RTPU.TRACE", "HOTKEYS",
    "EVENTS",
    # Replication plane: stream/ack/bus verbs never change a
    # keyspace-read result on THIS node (a replica's keyspace changes
    # through the apply path, not through the dispatched verb).
    "REPLCONF", "RTPU.PSYNC", "RTPU.REPLFETCH", "RTPU.CLUSTERPING",
    "RTPU.FAILOVER.AUTH",
))

# Commands a READ-ONLY replica still serves beyond the _NONMUTATING read
# surface: admin and replication control.  NOT the write surface — a
# replica's keyspace mutates only through its replication link, or the
# -READONLY contract (and the no-dual-primary invariant it underwrites)
# is fiction.
_REPLICA_ADMIN = frozenset((
    "CONFIG", "DEBUG", "CLUSTER", "REPLCONF", "SHUTDOWN", "RESET",
    "MULTI", "EXEC", "DISCARD", "SUBSCRIBE", "UNSUBSCRIBE", "FAILOVER",
))

# Response-CACHEABLE subset: deterministic pure keyspace reads whose
# reply depends only on (argv, keyspace state) — no cursors, no
# randomness, no wall-clock.  Served from the per-connection response
# cache while the write epoch is unmoved.
_CACHEABLE = frozenset((
    "GET", "MGET", "STRLEN", "GETRANGE", "EXISTS", "TYPE", "GETBIT",
    "BITCOUNT", "BITPOS", "PFCOUNT", "BF.EXISTS", "BF.MEXISTS",
    "CMS.QUERY", "LLEN", "LRANGE", "LINDEX", "HGET", "HMGET", "HGETALL",
    "HLEN", "HEXISTS", "SCARD", "SISMEMBER", "SMISMEMBER", "SMEMBERS",
    "ZSCORE", "ZCARD", "ZRANK",
))

# Fusable families: runs of ADJACENT commands in one parsed-ahead batch
# that target the same (object, opcode family) fuse into one engine call.
# name -> (is_add, takes_many_items)
_BF_RUN = {
    b"BF.ADD": (True, False),
    b"BF.MADD": (True, True),
    b"BF.EXISTS": (False, False),
    b"BF.MEXISTS": (False, True),
}
_BIT_RUN = frozenset((b"SETBIT", b"GETBIT"))
_GET_RUN = frozenset((b"GET", b"MGET"))

# Bound on ops one fused run may carry (memory + keeps fused launches in
# the pre-warmed bucket ladder; a longer run simply splits).
_RUN_MAX_OPS = 1 << 14


def _encode_error(s: str) -> bytes:
    if s.split(" ", 1)[0] in _ERROR_CODES:
        return b"-" + s.encode() + b"\r\n"
    return b"-ERR " + s.encode() + b"\r\n"


def _encode_int(n: int) -> bytes:
    return b":" + str(int(n)).encode() + b"\r\n"


def _fmt_score(score: float) -> str:
    """Redis-style double formatting: integral scores print as integers
    ('1', not '1.0'); non-finite as 'inf'/'-inf'/'nan'; everything else
    %.17g (the shortest exact form Redis emits)."""
    import math

    if not math.isfinite(score):
        return repr(score)  # 'inf' / '-inf' / 'nan' — Redis spelling
    if score == int(score) and abs(score) < 1e17:
        return "%d" % int(score)
    return "%.17g" % score


def _encode_bulk(v) -> bytes:
    if v is None:
        return b"$-1\r\n"
    if isinstance(v, str):
        v = v.encode()
    return b"$" + str(len(v)).encode() + b"\r\n" + v + b"\r\n"


_int_encoder = None
_int_encoder_loaded = False


def _encode_array(items) -> bytes:
    global _int_encoder, _int_encoder_loaded
    out = b"*" + str(len(items)).encode() + b"\r\n"
    if len(items) >= 8:
        if not _int_encoder_loaded:
            from redisson_tpu_torch.serve import native_codec

            _int_encoder = native_codec.get_parser()
            _int_encoder_loaded = True
        if _int_encoder is not None:
            if all(type(it) is int for it in items):
                # Batch integer replies (BF.MADD / BF.MEXISTS / CMS.QUERY
                # pipelines) serialize in one native call
                # (rtpu_resp_encode_ints).
                return out + _int_encoder.encode_ints(items)
            if all(it is None or type(it) is bytes for it in items):
                # Batch bulk replies (MGET / HGETALL / LRANGE pipelines):
                # one native call builds every `$len\r\n...\r\n` frame
                # (rtpu_resp_encode_bulks; None on a stale .so).
                enc = _int_encoder.encode_bulks(items)
                if enc is not None:
                    return out + enc
    for it in items:
        if isinstance(it, int):
            out += _encode_int(it)
        else:
            out += _encode_bulk(it)
    return out



class _Reader:
    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = b""
        # True while a multi-part frame is partially parsed: an idle
        # timeout that fires here must close the connection (continuing
        # would desync the protocol stream), see _serve_conn.
        self.frame_started = False
        # Native batch parser (serve/native_codec.py): one C call frames
        # a whole pipelined recv; parsed-ahead commands queue here.  None
        # → pure-Python slow path (no compiler / RTPU_NO_NATIVE_RESP).
        from collections import deque

        from redisson_tpu_torch.serve import native_codec

        self._native = native_codec.get_parser()
        self._pending: "deque[list[bytes]]" = deque()

    def at_frame_boundary(self) -> bool:
        return not self.frame_started and not self._buf and not self._pending

    def _read_line(self) -> Optional[bytes]:
        while b"\r\n" not in self._buf:
            data = self._sock.recv(65536)
            if not data:
                return None
            self._buf += data
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> Optional[bytes]:
        while len(self._buf) < n + 2:
            data = self._sock.recv(65536)
            if not data:
                return None
            self._buf += data
        out, self._buf = self._buf[:n], self._buf[n + 2 :]
        return out

    def read_command(self) -> Optional[list[bytes]]:
        if self._native is not None:
            return self._read_command_native()
        return self._read_command_py()

    def _read_command_native(self) -> Optional[list[bytes]]:
        from redisson_tpu_torch.serve import native_codec

        while True:
            if self._pending:
                self.frame_started = False
                return self._pending.popleft()
            if self._buf:
                frames, consumed, err = self._native.parse(self._buf)
                if frames:
                    self._buf = self._buf[consumed:]
                    self._pending.extend(frames)
                    continue
                if err != native_codec.PARSE_OK:
                    # Inline command or malformed frame: hand the bytes
                    # to the slow path, which reproduces the Python
                    # behavior exactly (split / RespError path).
                    return self._read_command_py()
                # Incomplete frame: block for more bytes.  Flag it so an
                # idle timeout firing here closes the connection instead
                # of desyncing the stream (see _serve_conn).
                self.frame_started = True
            data = self._sock.recv(65536)
            if not data:
                return None
            self._buf += data

    def _read_command_py(self) -> Optional[list[bytes]]:
        self.frame_started = False
        line = self._read_line()
        if line is None:
            return None
        # Set until the frame parses COMPLETELY — a timeout propagating
        # out mid-frame leaves it set and the caller must close (resuming
        # would desync the stream).
        self.frame_started = True
        if not line.startswith(b"*"):
            # inline command (redis-cli fallback)
            self.frame_started = False
            return line.split()
        try:
            n = int(line[1:])
        except ValueError:
            raise ProtocolError("invalid multibulk length")
        if n < 0:
            # '*-1' etc. would silently desync the stream (mirrors the
            # native parser, which already rejects negative counts).
            raise ProtocolError("invalid multibulk length")
        args = []
        for _ in range(n):
            hdr = self._read_line()
            if hdr is None or not hdr.startswith(b"$"):
                return None
            try:
                size = int(hdr[1:])
            except ValueError:
                raise ProtocolError("invalid bulk length")
            if size < 0:
                # '$-1' reaching _read_exact(-1) would slice buf[:-1]
                # and desync the connection into parsing garbage.
                raise ProtocolError("invalid bulk length")
            data = self._read_exact(size)
            if data is None:
                return None
            args.append(data)
        self.frame_started = False
        return args


class _ConnCtx:
    """Per-connection state: serialized writes (pub/sub pushes interleave
    with replies), this connection's channel subscriptions, the MULTI/EXEC
    transaction queue, protocol version, name and deadline override."""

    def __init__(self, sock: socket.socket, server: "RespServer" = None):
        self.sock = sock
        self.server = server  # live output-buffer limits (CONFIG SET)
        self.lock = threading.Lock()
        try:  # for SLOWLOG entries; the peer may already be gone
            peer = sock.getpeername()
            if isinstance(peer, tuple):
                self.addr = "%s:%d" % peer[:2]
            else:  # AF_UNIX peername is a (often empty) path string
                self.addr = "unix:%s" % (peer or "peer")
        except OSError:
            self.addr = ""
        self.authed = True  # server flips to False when requirepass set
        self.in_multi = False
        self.queued: list = []  # commands queued since MULTI
        self.in_exec = False  # replaying an EXEC (blocking cmds don't block)
        self.subs: dict[str, int] = {}  # channel -> bus listener id
        self.proto = 2  # RESP protocol version; HELLO 3 upgrades
        self.client_name: Optional[str] = None
        # Per-connection op-deadline override (CLIENT DEADLINE):
        # None = server default (op_deadline_ms), 0 = no deadline.
        self.op_deadline_ms: Optional[int] = None
        # Replication: set by REPLCONF IDENT — this connection belongs to
        # a replica with that id; its ACKs land in the hub's per-replica
        # table under this name.
        self.repl_ident: Optional[str] = None
        self.repl_listening_port = 0

    def _kill(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def send(self, frame: bytes) -> None:
        with self.lock:
            srv = self.server
            hard = getattr(srv, "output_buffer_limit", 0) if srv else 0
            soft_s = (
                getattr(srv, "output_buffer_soft_seconds", 0.0)
                if srv else 0.0
            )
            if not hard and not soft_s:
                try:
                    # rtpulint: disable=RT001 the conn write lock EXISTS to serialize whole-frame socket writes (worker and reactor replies interleave); blocking here is its purpose, and the socket timeout / output-buffer limits bound the stall
                    self.sock.sendall(frame)
                except OSError:
                    # Includes socket.timeout: the connection's timeout
                    # covers sendall too, and a timed-out/failed send may
                    # have written a PARTIAL frame — continuing would
                    # desync the reply stream.  Kill the socket; the read
                    # loop reclaims the slot.
                    self._kill()
                return
            self._send_bounded(frame, srv, hard, soft_s)

    def _send_bounded(self, frame: bytes, srv, hard: int,
                      soft_s: float) -> None:
        """Slow-client protection (the client-output-buffer-limit
        analog): replies are written through, so the server-side
        'buffer' is the unsent remainder of the current frame.  A frame
        still holding more than ``hard`` bytes unsent after its grace
        (soft-seconds when set, else ~1 s) — or one making NO progress
        for ``soft_s`` seconds — disconnects the client instead of
        parking a connection thread (and the engine results it holds)
        behind a receiver that never (or barely) reads.

        Waits use select(), NOT settimeout(): the socket's timeout is
        shared state the connection's reader thread relies on
        (idle_timeout_s semantics), and this method runs cross-thread
        for cross-thread sends."""
        import select

        view = memoryview(frame)
        frame_t0 = last_progress = time.monotonic()
        # No-progress stall bound: soft-seconds when configured, else
        # the socket's own timeout (the idle_timeout_s the legacy
        # sendall path died under) — with only the hard byte limit set,
        # an under-limit stall must NOT loop forever where the old path
        # disconnected.
        stall_s = soft_s or self.sock.gettimeout() or 0.0
        # The hard byte limit gets its OWN time gate (soft-seconds when
        # set, else ~1 s): gating it on continuous stall alone lets a
        # one-byte-per-tick trickler reset the clock forever, and tying
        # it to idle_timeout made it a 300 s (or never, at idle 0) wait.
        hard_grace_s = soft_s or 1.0
        while view:
            now = time.monotonic()
            if (
                hard and len(view) > hard
                and now - frame_t0 > hard_grace_s
            ):
                srv._note_slow_client("hard-bytes", len(view))
                self._kill()
                return
            tick = 1.0
            if stall_s:
                rem = stall_s - (now - last_progress)
                if rem <= 0:
                    srv._note_slow_client(
                        "soft-seconds" if soft_s else "idle-timeout",
                        len(view),
                    )
                    self._kill()
                    return
                tick = min(tick, rem)
            if hard and len(view) > hard:
                tick = min(tick, max(0.01, hard_grace_s - (now - frame_t0)))
            try:
                _r, writable, _x = select.select((), (self.sock,), (), tick)
                if not writable:
                    continue  # loop re-checks the stall / hard gates
                # Blocking socket + select-says-writable: send() takes
                # whatever buffer space exists and returns promptly.
                n = self.sock.send(view)
            except (OSError, ValueError):
                self._kill()
                return
            if n > 0:
                last_progress = time.monotonic()
                view = view[n:]




class RespServer:
    """Embedded RESP2 endpoint over a RedissonTpuClient.

    Bounded (SURVEY §2.1 pub/sub + pools rows): at most
    ``max_connections`` concurrent connections (excess are refused with
    an error, the ``maxclients`` behavior) and an ``idle_timeout_s``
    after which a silent connection is closed — subscriber connections
    are exempt, like Redis's default timeout handling for blocked/
    subscribed clients."""

    def __init__(self, client, host: str = "127.0.0.1", port: int = 0,
                 max_connections: int = 256, idle_timeout_s: float = 300.0,
                 requirepass: Optional[str] = None):
        """Serves whatever device ``client`` was built on (its engine's
        pools and kernels); the front door itself is host code."""
        self._client = client
        # Auth: explicit arg wins, else the client Config's requirepass.
        # A network-exposed server with FLUSHALL and no auth is not
        # shippable — set one.
        self._requirepass = (
            requirepass
            if requirepass is not None
            else getattr(client.config, "requirepass", None)
        )
        # Scripting's bind rule (the JAX package's): script bodies are
        # arbitrary Python, so enabling them on a non-loopback bind without
        # requirepass is refused.  The port carries no scripting yet
        # (EVAL answers as an unknown command); the refusal keeps a
        # config that the JAX package would refuse from starting here.
        if client.config.enable_python_scripts and not (
            self._requirepass or self._is_loopback(host)
        ):
            raise ValueError(
                "enable_python_scripts on a non-loopback bind requires "
                "requirepass: RESP scripts are arbitrary Python (RCE)"
            )
        # DEBUG INJECT / DEBUG RESIDENCY (fault injection, tier forcing)
        # share scripting's gate: allowed on a loopback bind or behind
        # requirepass — a fault injector on an open unauthenticated
        # socket is a denial-of-service surface.
        self._inject_allowed = bool(
            self._requirepass or self._is_loopback(host)
        )
        self.max_connections = max_connections
        self.idle_timeout_s = idle_timeout_s
        # Overload control plane.  Deadline default stamped on every
        # command at ingress (CLIENT DEADLINE overrides per connection);
        # ingress shedding once coalescer queue pressure crosses the
        # watermark; slow-client output-buffer limits.  All live-settable
        # via CONFIG SET.
        gsk = client.config.gpu_sketch
        self.op_deadline_ms = int(gsk.op_deadline_ms or 0)
        self.admission_watermark = float(gsk.admission_watermark or 0.9)
        self.output_buffer_limit = int(
            client.config.client_output_buffer_limit or 0
        )
        self.output_buffer_soft_seconds = float(
            client.config.client_output_buffer_soft_seconds or 0.0
        )
        self._ingress_shed = 0  # lifetime commands shed at ingress
        self._slow_client_kills = 0
        # Front-door vectorization: fuse runs of adjacent pipelined
        # commands into single engine calls; the response cache serves
        # repeated identical reads inside one pipeline window.  Both
        # live-togglable via attributes (A/B runs).
        self.vectorize = bool(client.config.resp_vectorize)
        self.response_cache_size = int(client.config.resp_response_cache_size)
        # Write epoch: bumped by every mutating RESP command on ANY
        # connection; response-cache entries serve only while it is
        # unmoved since install.  Guarded — a lost increment would let a
        # stale cached reply outlive the write that obsoleted it.
        self._write_epoch = 0
        self._epoch_lock = threading.Lock()
        # Per-command stats record into the CLIENT's bundle (the
        # engine's registry, so one exposition carries both).
        self.obs = client.obs
        self._started = time.monotonic()
        self._conns_accepted = 0
        self._nconn = 0
        self._conn_lock = threading.Lock()
        self._conn_idle = threading.Condition(self._conn_lock)
        self._conns: set = set()  # live sockets, for shutdown drain
        # SCAN resume state: cursor id -> last key returned (see _cmd_SCAN).
        self._scan_states: dict[int, str] = {}
        self._scan_next = 0
        self._scan_lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(512)
        self.host, self.port = self._sock.getsockname()
        self._closed = False
        # Connection-limit refusals: counted so reactor capacity tuning
        # is observable (INFO clients rejected_connections +
        # rtpu_resp_ingress_shed{conn_limit}).
        self._conns_refused = 0
        # Reactor front door: a small fixed pool of selector event-loop
        # threads replaces thread-per-connection serving — each tick
        # drains recv buffers across ALL ready connections and feeds one
        # merged parse -> vectorize -> dispatch pass, so same-family ops
        # from different connections fuse into single engine calls and
        # idle connections cost a file descriptor, not a thread.
        # resp_reactor=False keeps the thread path selectable for
        # differential testing; RTPU_REQUIRE_REACTOR makes a silent
        # fallback a hard error (the analog of RTPU_REQUIRE_NATIVE_RESP).
        self.reactor = None
        if bool(client.config.resp_reactor):
            import os as _os

            try:
                from redisson_tpu_torch.serve.reactor import ReactorPool

                self.reactor = ReactorPool(
                    self,
                    nthreads=int(client.config.resp_reactor_threads or 1),
                )
            except Exception:
                if _os.environ.get("RTPU_REQUIRE_REACTOR"):
                    self._sock.close()
                    raise
                self.reactor = None
        # Replication plane: the primary-side hub (journal tap → backlog
        # ring → RTPU.REPLFETCH) exists whenever a journal does — a node
        # is a streaming-capable primary by default.  ``replica_link`` is
        # set when THIS node replicates from a primary (config.replica_of
        # or start_replication_from); the link's presence IS the role bit
        # (role:slave, the -READONLY gate, bounded-staleness refusals).
        self.repl_hub = None
        self.replica_link = None
        self._repl_hub()  # eager when the journal is already attached
        self.obs.repl_offset_source = self._repl_offset
        self.obs.repl_lag_source = self._repl_lag
        master = client.config.replica_of
        if master:
            host_m, _, port_m = str(master).rpartition(":")
            self.start_replication_from(host_m, int(port_m))
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="rtpu-resp-accept", daemon=True
        )
        self._accept_thread.start()

    # -- plumbing ----------------------------------------------------------

    @staticmethod
    def _is_loopback(host: str) -> bool:
        return host in ("localhost", "::1") or host.startswith("127.")

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            try:
                # redis-server sets TCP_NODELAY on accepted sockets:
                # small reply frames must not sit behind Nagle.
                conn.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                )
            except OSError:
                pass
            with self._conn_lock:
                refused = self._nconn >= self.max_connections
                if not refused:
                    self._nconn += 1
                    self._conns_accepted += 1
                    self._conns.add(conn)
            if refused:
                # Count the refusal: reactor-mode
                # capacity tuning needs conn-limit sheds visible next to
                # the command-level ingress sheds, and INFO clients
                # carries the lifetime total (rejected_connections).
                self._conns_refused += 1
                if self.obs is not None:
                    self.obs.resp_ingress_shed.inc(("conn_limit",))
                # Refusal send OUTSIDE _conn_lock (rtpulint RT001): a
                # stalled rejected peer must not park the accept thread
                # while it holds the lock every disconnecting
                # connection needs for slot teardown.
                try:
                    conn.sendall(
                        b"-ERR max number of clients reached\r\n"
                    )
                except OSError:
                    pass
                finally:
                    # close in finally (RT013): a refusal send that
                    # raises must still release the fd — the old shape
                    # leaked it to GC time.
                    conn.close()
                continue
            if self.reactor is not None:
                self.reactor.assign(conn)
            else:
                threading.Thread(
                    target=self._serve_conn, args=(conn,),
                    name="rtpu-resp-conn", daemon=True,
                ).start()


    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            reader = _Reader(conn)
            ctx = _ConnCtx(conn, server=self)
            if self._requirepass:
                ctx.authed = False
        except Exception:
            # Constructor failure must not leak the connection slot.
            conn.close()
            with self._conn_lock:
                self._nconn -= 1
                self._conns.discard(conn)
                self._conn_idle.notify_all()
            raise
        if self.idle_timeout_s:
            conn.settimeout(self.idle_timeout_s)
        try:
            while True:
                try:
                    cmd = reader.read_command()
                except socket.timeout:
                    # Subscribers may idle legitimately — but only at a
                    # frame boundary; a timeout mid-frame (or with bytes
                    # buffered) would desync the protocol on resume.
                    if ctx.subs and reader.at_frame_boundary():
                        continue
                    return  # reclaim the slot
                except OSError:
                    return  # peer reset/aborted: plain disconnect
                except ProtocolError as e:
                    ctx.send(_encode_error(f"Protocol error: {e}"))
                    return  # desynced stream: close, Redis-style
                if cmd is None:
                    return
                if not cmd:
                    # Empty multibulk ('*0\r\n') / blank inline line:
                    # Redis silently skips these with NO reply — emitting
                    # one would desync a pipelining client's reply count.
                    continue
                # Pipelined batch: commands the reader already parsed
                # ahead reply in ONE sendall (the CommandBatchEncoder
                # role) — syscall count stops scaling with pipeline
                # depth; the vectorizer additionally fuses runs of
                # adjacent same-family commands into single engine
                # launches.  Bounded so a huge pipeline cannot
                # buffer unbounded reply bytes.
                pending = reader._pending
                if pending:
                    batch = [cmd]
                    while pending and len(batch) < 1024:
                        # Collect up to the first command that blocks
                        # (BLPOP would hold earlier replies hostage) or
                        # whose handler writes to the socket ITSELF
                        # (SUBSCRIBE's ack would overtake buffered
                        # replies — reply order must be command order).
                        if not pending[0]:
                            # Empty frame in a pipeline: skip, no reply.
                            pending.popleft()
                            continue
                        if pending[0][0].upper() in _PIPELINE_STOP:
                            break
                        batch.append(pending.popleft())
                    frames, consumed = self._dispatch_pipeline(batch, ctx)
                    if consumed < len(batch):
                        # Reply-buffer cap hit: the unprocessed tail goes
                        # back to the FRONT of the parse-ahead queue, in
                        # order, for the next loop pass.
                        pending.extendleft(reversed(batch[consumed:]))
                    ctx.send(b"".join(frames))
                else:
                    ctx.send(self._safe_dispatch(cmd, ctx))
        finally:
            # Drop this connection's subscriptions with it.
            for channel, lid in list(ctx.subs.items()):
                self._client._topic_bus.unsubscribe(channel, lid)
            conn.close()
            with self._conn_lock:
                self._nconn -= 1
                self._conns.discard(conn)
                self._conn_idle.notify_all()

    def close(self, drain_timeout_s: float = 10.0) -> None:
        """Stop accepting, force-close live connections, and wait for
        their threads to finish the command in flight.  Ordering matters
        for snapshot-on-shutdown: every reply already on the wire was
        dispatched before its connection thread exits, so a snapshot
        taken AFTER this drain contains every acked write."""
        self._closed = True
        try:
            # shutdown wakes the accept thread (close alone leaves it
            # blocked in accept() on Linux).
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        import time as _time

        with self._conn_lock:
            for c in list(self._conns):
                try:
                    c.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            deadline = _time.monotonic() + drain_timeout_s
            while self._nconn > 0:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    break
                self._conn_idle.wait(timeout=remaining)
        link, self.replica_link = self.replica_link, None
        if link is not None:
            link.stop()
        if self.repl_hub is not None:
            self.repl_hub.detach()
        # Reactors stop AFTER the drain: they are the threads that
        # observe the shutdowns above and tear each connection down.
        if self.reactor is not None:
            self.reactor.close()

    # -- command dispatch ---------------------------------------------------

    def _safe_dispatch(self, cmd: list[bytes], ctx: "_ConnCtx") -> bytes:
        """Dispatch with the error-encoding contract: command errors
        never kill the connection; known codes pass through verbatim.

        Every dispatch is timed here — ONE clock read pair per command
        feeds the per-command counters and latency histogram (INFO
        commandstats / latencystats, the registry families).

        Commands merely QUEUED under MULTI are not recorded (EXEC's
        replay re-enters here and records the real execution)."""
        t0 = time.perf_counter()
        err = False
        name = cmd[0].decode("latin-1", "replace").upper()
        queueing = ctx.in_multi and name not in (
            "EXEC", "DISCARD", "MULTI", "RESET",
        )
        if not queueing:
            self._monitor_feed(name, cmd, ctx)
        tspan = None if queueing else self._trace_begin(name, ctx)
        try:
            reply = self._dispatch_deadlined(cmd, ctx, name)
        except Exception as e:
            # RespError / TypeError-WRONGTYPE / generic all map through
            # the ONE shared helper the fused-run demux also uses.
            err = True
            reply = self._fused_error_frame(e)
        if not queueing and name not in _NONMUTATING:
            # Any executed command that may have changed keyspace state
            # retires every response-cache entry (coarse, cheap, safe —
            # the cache's whole window is one parsed-ahead batch).
            self._bump_write_epoch()
        dt = time.perf_counter() - t0
        if tspan is not None:
            tspan.end(error=err)
        if not queueing:
            if self._blocked(name, cmd, ctx):
                # Condvar-parked wait is not execution time: a routine
                # `BLPOP q 30` would otherwise drive latencystats to
                # +Inf (Redis also excludes blocked time).  Calls and
                # errors still count.
                self.obs.resp_commands.inc((name,))
                if err:
                    self.obs.resp_errors.inc((name,))
            else:
                self.obs.record_resp_command(name, dt, err)
        return reply

    def _dispatch_deadlined(self, cmd: list, ctx: "_ConnCtx",
                            name: str) -> bytes:
        """Deadline attach: every command gets its own fresh
        end-to-end deadline — connection override first, else the server
        default; 0/None → no deadline (ops block, the pre-overload
        behavior)."""
        dl_s = self._op_deadline_s(ctx)
        if dl_s is not None:
            with _overload.deadline_scope(dl_s):
                return self._dispatch(cmd, ctx, name)
        return self._dispatch(cmd, ctx, name)

    # -- telemetry hooks ----------------------------------------------------

    def _trace_begin(self, name: str, ctx: "_ConnCtx"):
        """A command's ingress span: a no-op (None) until the port has
        the tracing plane (``obs/trace``, ROADMAP queue 1 item 6), whose
        head-sampled span the JAX package opens here."""
        return None

    @staticmethod
    def _blocked(name: str, cmd: list, ctx: "_ConnCtx") -> bool:
        """True when this invocation may have parked waiting for data —
        its wall time is wait, not work, so it must not feed latency
        histograms.  Inside EXEC every command runs non-blocking
        (recorded normally), and XREAD/XREADGROUP block only with an
        explicit BLOCK option."""
        if ctx.in_exec:
            return False
        if name in ("BLPOP", "BRPOP"):
            return True
        if name in ("XREAD", "XREADGROUP"):
            return any(a.upper() == b"BLOCK" for a in cmd[1:])
        return False

    def _monitor_feed(self, name: str, cmd: list, ctx: "_ConnCtx") -> None:
        """The MONITOR stream's feed point: a no-op until MONITOR lands
        with the tracing plane (ROADMAP queue 1 item 6)."""

    # -- overload control plane ----------------------------------

    def _op_deadline_s(self, ctx: "_ConnCtx") -> Optional[float]:
        """Effective op deadline for this connection, in relative
        seconds, or None for no deadline."""
        ms = ctx.op_deadline_ms
        if ms is None:
            ms = self.op_deadline_ms
        return ms / 1000.0 if ms and ms > 0 else None

    def _pressure(self) -> float:
        """Coalescer queue pressure (0 when the fronted engine has no
        coalescer — host engine / direct-dispatch mode)."""
        c = getattr(getattr(self._client, "_engine", None),
                    "coalescer", None)
        return c.pressure() if c is not None else 0.0

    def _pressure_over(self) -> bool:
        w = self.admission_watermark
        return w > 0 and self._pressure() > w

    def _count_ingress_shed(self, reason: str = "pressure") -> None:
        # Commands, not ops: a shed command's engine op count is
        # unknowable pre-parse, and mixing units into the ops-
        # denominated rtpu_shed_ops family would make its total
        # meaningless — ingress has its own command-denominated counter.
        self._ingress_shed += 1
        if self.obs is not None:
            self.obs.resp_ingress_shed.inc((reason,))

    def _ingress_tenant(self, cmd: list) -> Optional[str]:
        """Keyspace→tenant peek for the door (ROADMAP overload item
        (b)): the first argument of a keyed command IS the tenant name
        in this keyspace (per-tenant quotas are object-name-keyed), so
        the door can judge a tenant BEFORE any command parse.  None for
        keyless commands."""
        if len(cmd) < 2:
            return None
        return cmd[1].decode("latin-1", "replace")

    def _shed_at_ingress(self, name: str, cmd: list,
                         ctx: "_ConnCtx") -> Optional[str]:
        """The shed reason when this command must be refused with -BUSY
        (None = admit): exempt commands and in-flight transactions
        always pass (EXEC completes atomically once started; MULTI
        queueing is free — the whole transaction is judged once, at
        EXEC, in _cmdctx_EXEC).

        Tenant-aware shedding comes FIRST (ROADMAP
        overload item (b)): an over-quota tenant — token bucket empty or
        in-flight quota full — is refused at the door before its command
        even parses, so during one tenant's burst the burst is what gets
        shed, not the well-behaved tenants' traffic.  The general
        pressure watermark then sheds everyone non-exempt as before."""
        if name in _SHED_EXEMPT or ctx.in_exec or ctx.in_multi:
            return None
        gov = getattr(
            getattr(self._client, "_engine", None), "governor", None
        )
        if gov is not None and gov.active:
            tenant = self._ingress_tenant(cmd)
            if tenant is not None and gov.peek_over_quota(tenant):
                self._count_ingress_shed("tenant")
                return "tenant"
        if not self._pressure_over():
            return None
        self._count_ingress_shed("pressure")
        return "pressure"

    def _note_slow_client(self, cause: str, pending: int) -> None:
        self._slow_client_kills += 1
        if self.obs is not None:
            self.obs.slow_client_disconnects.inc((cause,))

    # -- front-door vectorization -----------------------

    def _bump_write_epoch(self) -> None:
        with self._epoch_lock:
            self._write_epoch += 1

    @staticmethod
    def _fused_error_frame(e: BaseException) -> bytes:
        """THE exception → reply-frame mapping, shared by
        _safe_dispatch's except arms and the fused-run demux — one
        implementation, so a fused run's per-command error bytes can
        never drift from what sequential dispatch would have replied
        (the byte-identical contract).  Kind guards raise TypeError —
        clients key on the WRONGTYPE code (redis-py maps it to a
        dedicated exception class)."""
        if isinstance(e, RespError):
            return _encode_error(str(e))
        if isinstance(e, DeadlineExceededError):
            # Overload control plane: deadline sheds surface
            # as the retryable -BUSY family, like redis-server's
            # busy-state refusals.
            return _encode_error(f"BUSY RTPU op deadline exceeded: {e}")
        if isinstance(e, TenantThrottledError):
            return _encode_error(f"BUSY RTPU tenant throttled: {e}")
        if isinstance(e, TypeError):
            return _encode_error(
                "WRONGTYPE Operation against a key holding the wrong kind "
                f"of value ({e})"
            )
        return _encode_error(f"{type(e).__name__}: {e}")

    def _dispatch_pipeline(self, batch, ctx: "_ConnCtx"):
        """Vectorized dispatch of one parsed-ahead batch from ONE
        connection (the thread-per-connection path): every item shares
        the connection's ctx."""
        return self._dispatch_merged(batch, [ctx] * len(batch))

    @staticmethod
    def _ctx_fusable(ctx: "_ConnCtx") -> bool:
        """Whether this connection's items may join a fused run right
        now: an unauthenticated connection must see NOAUTH per command,
        and a MULTI-queued command must queue, not execute."""
        return ctx.authed and not ctx.in_multi

    @classmethod
    def _fuse_compat(cls, head_ctx: "_ConnCtx", ctx: "_ConnCtx") -> bool:
        """Whether ``ctx``'s items may join a run HEADED by
        ``head_ctx``'s: fusable, and carrying the SAME per-connection
        deadline override — the run executes under ONE deadline scope
        (the head's), so a CLIENT DEADLINE connection fused into a
        no-deadline run would silently lose its overload contract."""
        return (
            cls._ctx_fusable(ctx)
            and ctx.op_deadline_ms == head_ctx.op_deadline_ms
        )

    def _dispatch_merged(self, batch, ctxs):
        """Vectorized dispatch of one command window.  ``batch[i]``
        belongs to connection ``ctxs[i]`` — the thread-per-connection
        path passes one shared ctx, the reactor passes one tick's merged
        cross-connection batch (each connection's items appear in its
        own arrival order, so per-connection ordering is preserved by
        construction).  Scans for runs of adjacent same-family commands
        — ACROSS connection boundaries — and fuses each run into one
        engine call, demuxing the packed result into per-command replies
        in window order; everything else (and every command while its
        connection is in MULTI / unauthenticated / script-BUSY state)
        dispatches sequentially, so per-connection semantics are
        bit-identical to the unfused path.  Returns (frames, consumed):
        ``consumed`` < len(batch) when the bounded reply buffer filled —
        the caller re-queues the tail (``frames[k]`` answers
        ``batch[k]`` for k < consumed)."""
        out: list = []
        size = 0
        i = 0
        n = len(batch)
        # Overload: while pressure is over the watermark,
        # skip run fusion so every command flows through _safe_dispatch
        # and the ingress shed check there — a fused run would bypass
        # it.  (Checked once per parsed-ahead batch; the per-command
        # check re-reads live pressure.)
        overloaded = self._pressure_over()
        # Per-window response cache: (name, *argv) -> reply frame, valid
        # while the write epoch is unmoved.  Shared across the window's
        # connections on purpose: entries key on exact argv and the
        # server-wide write epoch only, so a frame one connection
        # computed is exactly the frame any other would compute in the
        # same epoch.
        rc: dict = {}
        rc_cap = self.response_cache_size
        rc_state = [self._write_epoch]
        obs = self.obs
        while i < n:
            if size >= (1 << 20):
                break
            cmd = batch[i]
            ctx = ctxs[i]
            name = cmd[0].decode("latin-1", "replace").upper()
            # A replica serves every command through _dispatch, whose
            # -READONLY and staleness gates a fused run would bypass.
            plain = (
                self.vectorize and self._ctx_fusable(ctx)
                and self.replica_link is None
            )
            if plain and rc_cap > 0 and name in _CACHEABLE:
                hit = self._rc_probe(rc, rc_state, name, cmd)
                if hit is not None:
                    out.append(hit)
                    size += len(hit)
                    i += 1
                    continue
            run = (
                self._scan_run(batch, i, ctxs)
                if plain and not overloaded else None
            )
            if run is not None:
                if (
                    self._op_deadline_s(ctx) is None
                    and self._run_readonly(run)
                ):
                    # Submit-ahead span: back-to-back READ-ONLY runs
                    # submit their engine calls first, then resolve in
                    # window order — the launches overlap in the
                    # coalescer instead of the window serializing
                    # behind one .result() at a time.  Read-only only:
                    # a write run's epoch bump lands at resolve, and
                    # submitting past it could let a later member's
                    # cache probe serve a stale pre-write frame.
                    # (Span members skip the loop-top response-cache
                    # probe; the frames a run computes are identical to
                    # what the cache held, so bytes cannot differ.)
                    spans = [(i, run, self._submit_run(run))]
                    jj = run[1]
                    span_conns = {id(c) for c in ctxs[i:jj]}
                    while jj < n and len(spans) < 8:
                        if not (
                            self.vectorize
                            and self._ctx_fusable(ctxs[jj])
                            and self._op_deadline_s(ctxs[jj]) is None
                        ):
                            # (A deadline-carrying connection's run must
                            # execute under its deadline_scope — the
                            # _exec_run path — never as a bare span
                            # member.)
                            break
                        nxt = self._scan_run(batch, jj, ctxs)
                        if nxt is None or not self._run_readonly(nxt):
                            break
                        nxt_conns = {id(c) for c in ctxs[jj:nxt[1]]}
                        if span_conns & nxt_conns:
                            # One in-flight run per CONNECTION: a
                            # connection's later run submitted before
                            # its earlier run's observation point could
                            # show a concurrent writer's effects out of
                            # program order (later command reflecting
                            # OLDER state).  Runs of disjoint
                            # connections carry no mutual ordering
                            # contract — they overlap freely.
                            break
                        spans.append((jj, nxt, self._submit_run(nxt)))
                        span_conns |= nxt_conns
                        jj = nxt[1]
                    for pos, r, sub in spans:
                        frames, rj = self._resolve_run(
                            r, sub, batch, pos, ctxs, rc, rc_state
                        )
                        if obs is not None and len(
                            {id(c) for c in ctxs[pos:rj]}
                        ) > 1:
                            obs.cross_conn_fused_ops.inc(
                                (r[0],), self._run_nops(r, pos, rj)
                            )
                        out.extend(frames)
                        size += sum(len(f) for f in frames)
                        i = rj
                        if rj < r[1]:
                            # mget reply-byte cut: the tail (and any
                            # later READ-ONLY span member — re-running
                            # a read is free) re-queues.
                            break
                    continue
                frames, j = self._exec_run(run, batch, i, ctxs, rc, rc_state)
                if obs is not None and len(
                    {id(c) for c in ctxs[i:j]}
                ) > 1:
                    # Cross-connection fusion: these ops
                    # launched together with ops from other connections
                    # — single-command clients got batch economics.
                    obs.cross_conn_fused_ops.inc(
                        (run[0],), self._run_nops(run, i, j)
                    )
                out.extend(frames)
                size += sum(len(f) for f in frames)
                i = j
                continue
            frame = self._safe_dispatch(cmd, ctx)
            if (
                plain and rc_cap > 0 and name in _CACHEABLE
                and not frame.startswith(b"-")
            ):
                self._rc_install(rc, rc_state, name, cmd, frame)
            out.append(frame)
            size += len(frame)
            i += 1
        return out, i

    @staticmethod
    def _run_nops(run, i: int, end: int) -> int:
        """Engine ops a fused-run descriptor carried — ``end`` is the
        position execution actually reached (an mget run can be cut by
        the reply-byte bound; its requeued tail must not be counted
        here AND again when it re-dispatches)."""
        fam = run[0]
        if fam == "mget":
            return end - i
        return len(run[3])

    # response-cache plumbing: rc_state[0] holds the epoch the window's
    # entries were installed under; any bump wipes the window.

    def _rc_probe(self, rc, rc_state, name, cmd):
        cur = self._write_epoch
        if cur != rc_state[0]:
            rc.clear()
            rc_state[0] = cur
            if self.obs is not None:
                self.obs.resp_cache_misses.inc()
            return None
        hit = rc.get((name, *cmd[1:]))
        obs = self.obs
        if obs is not None:
            if hit is not None:
                obs.resp_cache_hits.inc()
                # The command "executed" from the cache: calls still
                # count (INFO commandstats parity).
                obs.resp_commands.inc((name,))
            else:
                obs.resp_cache_misses.inc()
        return hit

    def _rc_install(self, rc, rc_state, name, cmd, frame) -> None:
        if len(frame) > (8 << 10):  # bound per-entry bytes
            return
        cur = self._write_epoch
        if cur != rc_state[0]:
            # A write landed between this command's probe and now: the
            # window dies — and THIS frame may predate that write, so it
            # must be dropped, never re-homed under the new epoch (a
            # pre-write reply cached under the post-write epoch would
            # outlive the write that obsoleted it).
            rc.clear()
            rc_state[0] = cur
            return
        if len(rc) < self.response_cache_size:
            rc[(name, *cmd[1:])] = frame

    # -- run scanning ------------------------------------------------------

    def _scan_run(self, batch, i, ctxs):
        """A fused-run descriptor starting at ``batch[i]``, or None.
        Runs are maximal spans of adjacent commands of one family (same
        target object for bf/bitset/cms), possibly spanning CONNECTION
        boundaries in a merged window; any non-member — including a
        malformed member whose sequential dispatch would error, or a
        member whose connection is mid-MULTI / unauthenticated — ends
        the run and dispatches sequentially (a run barrier)."""
        first = batch[i][0].upper()
        if first in _BF_RUN:
            return self._collect_bf_run(batch, i, ctxs)
        if first in _BIT_RUN:
            return self._collect_bit_run(batch, i, ctxs)
        if first in _GET_RUN:
            return self._collect_get_run(batch, i, ctxs)
        if first == b"CMS.QUERY":
            return self._collect_cms_run(batch, i, ctxs)
        return None

    @classmethod
    def _collect_bf_run(cls, batch, i, ctxs):
        cmd = batch[i]
        if len(cmd) < 3:
            return None
        key = cmd[1]
        items: list = []
        flags: list = []
        shape: list = []  # (upper name str, nops, many) per command
        j = i
        while j < len(batch) and len(items) < _RUN_MAX_OPS:
            c = batch[j]
            spec = _BF_RUN.get(c[0].upper())
            if (
                spec is None or len(c) < 3 or c[1] != key
                or not cls._fuse_compat(ctxs[i], ctxs[j])
            ):
                break
            is_add, many = spec
            ops = c[2:] if many else c[2:3]
            items.extend(ops)
            flags.extend([is_add] * len(ops))
            shape.append(
                (c[0].decode("latin-1", "replace").upper(), len(ops), many)
            )
            j += 1
        if j - i < 2:
            return None
        return ("bloom", j, key, items, flags, shape)

    @classmethod
    def _collect_bit_run(cls, batch, i, ctxs):
        key = batch[i][1] if len(batch[i]) >= 2 else None
        idx: list = []
        kinds: list = []  # 0 = get, 1 = clear, 2 = set
        names: list = []
        j = i
        while j < len(batch) and len(idx) < _RUN_MAX_OPS:
            c = batch[j]
            nm = c[0].upper()
            if not cls._fuse_compat(ctxs[i], ctxs[j]):
                break
            if nm == b"GETBIT":
                if len(c) < 3 or c[1] != key:
                    break
                try:
                    off = int(c[2])
                except ValueError:
                    break
                if off < 0:
                    break
                idx.append(off)
                kinds.append(0)
            elif nm == b"SETBIT":
                if len(c) < 4 or c[1] != key:
                    break
                try:
                    off, val = int(c[2]), int(c[3])
                except ValueError:
                    break
                if off < 0:
                    break
                idx.append(off)
                kinds.append(2 if val else 1)
            else:
                break
            names.append(c[0].decode("latin-1", "replace").upper())
            j += 1
        if j - i < 2:
            return None
        return ("bitset", j, key, idx, kinds, names)

    @classmethod
    def _collect_get_run(cls, batch, i, ctxs):
        j = i
        while j < len(batch):
            c = batch[j]
            if (
                c[0].upper() not in _GET_RUN or len(c) < 2
                or not cls._fuse_compat(ctxs[i], ctxs[j])
            ):
                break
            j += 1
        if j - i < 2:
            return None
        return ("mget", j, None, None, None, None)

    @classmethod
    def _collect_cms_run(cls, batch, i, ctxs):
        """Adjacent CMS.QUERY commands on one sketch fuse into a single
        ``estimate_all`` call (the near cache's reach): the merged item vector rides the engine's
        ``lookup_batch`` partial-hit split — cached estimates answer
        from the near cache, ONLY the misses ride the coalescer."""
        cmd = batch[i]
        if len(cmd) < 3:
            return None
        key = cmd[1]
        items: list = []
        shape: list = []  # nops per command
        j = i
        while j < len(batch) and len(items) < _RUN_MAX_OPS:
            c = batch[j]
            if (
                c[0].upper() != b"CMS.QUERY" or len(c) < 3 or c[1] != key
                or not cls._fuse_compat(ctxs[i], ctxs[j])
            ):
                break
            items.extend(c[2:])
            shape.append(len(c) - 2)
            j += 1
        if j - i < 2:
            return None
        return ("cms", j, key, items, shape, None)

    # -- run execution -----------------------------------------------------

    def _exec_run(self, run, batch, i, ctxs, rc, rc_state):
        # The fused run is ONE engine call serving many commands: one
        # shared deadline covers it — the run's FIRST connection's
        # deadline, when the run spans connections (per-command scopes
        # re-stamp inside the mget fam's _safe_dispatch calls).
        dl_s = self._op_deadline_s(ctxs[i])
        if dl_s is None:
            return self._exec_run_inner(run, batch, i, ctxs, rc, rc_state)
        with _overload.deadline_scope(dl_s):
            return self._exec_run_inner(run, batch, i, ctxs, rc, rc_state)

    def _exec_run_inner(self, run, batch, i, ctxs, rc, rc_state):
        return self._resolve_run(
            run, self._submit_run(run), batch, i, ctxs, rc, rc_state
        )

    @staticmethod
    def _run_readonly(run) -> bool:
        """True when executing this run cannot mutate keyspace state —
        the submit-ahead span condition (_dispatch_merged): a WRITE
        run's epoch bump lands at resolve time, so submitting past one
        could let a later span member's response-cache probe serve a
        stale pre-write frame."""
        fam = run[0]
        if fam in ("mget", "cms"):
            return True
        if fam == "bloom":
            return not any(run[4])
        return all(k == 0 for k in run[4])  # bitset

    def _submit_run(self, run):
        """Phase 1 of a fused run: build and SUBMIT the engine call(s)
        without waiting; returns an opaque token for _resolve_run.
        Back-to-back read-only runs submit ahead of the first resolve
        (_dispatch_merged), so their launches overlap in the coalescer
        instead of serializing the window behind one .result() at a
        time (a reactor tick is the whole front door — a
        blocked tick blocks every connection)."""
        fam = run[0]
        t0 = time.perf_counter()
        if fam == "mget":
            return (t0, None, None)  # host-side: executes at resolve
        if fam == "cms":
            try:
                return (t0, self._cms(run[2]).estimate_all_async(run[3]),
                        None)
            except Exception as e:
                return (t0, None, e)
        if fam == "bloom":
            _, _, key, items, flags, _shape = run
            try:
                bf = self._client.get_bloom_filter(self._s(key))
                if not any(flags):
                    fut = bf.contains_all_async(items)
                elif all(flags):
                    fut = bf.add_all_async(items)
                else:
                    fut = bf.mixed_async(items, np.asarray(flags, bool))
                return (t0, fut, None)
            except Exception as e:
                return (t0, None, e)
        # fam == "bitset"
        _, _, key, idx, kinds, _names = run
        err = None
        groups: list = []  # (start, end, future-or-exception)
        try:
            bs = self._client.get_bit_set(self._s(key))
            p = 0
            while p < len(kinds):
                q = p + 1
                while q < len(kinds) and kinds[q] == kinds[p]:
                    q += 1
                sel = idx[p:q]
                if kinds[p] == 0:
                    groups.append((p, q, bs.get_many_async(sel)))
                else:
                    groups.append(
                        (p, q, bs.set_many_async(sel, kinds[p] == 2))
                    )
                p = q
        except Exception as e:
            # Submit-time failure: nothing later can have applied —
            # every not-yet-grouped op fails with the same error.
            err = e
            done = groups[-1][1] if groups else 0
            groups.append((done, len(kinds), e))
        return (t0, groups, err)

    def _resolve_run(self, run, sub, batch, i, ctxs, rc, rc_state):
        """Phase 2 of a fused run: wait for the submission, demux
        per-command reply frames in window order, feed the response
        cache, bump the write epoch for runs that wrote, and record
        stats."""
        fam, j = run[0], run[1]
        t0, handle, err = sub
        if fam == "mget":
            # One grid pass: the whole read run executes under a single
            # grid-lock hold (handlers re-enter the RLock for free), and
            # repeated identical reads inside the run serve from the
            # response cache.  The run stops early once it has buffered
            # the reply-byte bound — the caller re-queues the tail (same
            # 1 MB discipline the per-command loop enforces).
            frames = []
            size = 0
            grid = self._client._grid
            with grid.lock:
                for k in range(i, j):
                    if size >= (1 << 20):
                        j = k
                        break
                    cmd = batch[k]
                    name = cmd[0].decode("latin-1", "replace").upper()
                    # The run's FIRST command was already probed (and
                    # missed) by the caller — re-probing would double-
                    # count resp_cache_misses.
                    hit = (
                        self._rc_probe(rc, rc_state, name, cmd)
                        if k > i and self.response_cache_size > 0
                        else None
                    )
                    if hit is not None:
                        frames.append(hit)
                        size += len(hit)
                        continue
                    frame = self._safe_dispatch(cmd, ctxs[k])
                    if (
                        self.response_cache_size > 0
                        and not frame.startswith(b"-")
                    ):
                        self._rc_install(rc, rc_state, name, cmd, frame)
                    frames.append(frame)
                    size += len(frame)
            # names=None: each command's stats were recorded by its own
            # _safe_dispatch above (the run is lock-amortization + the
            # response cache, not an engine-call fusion — it still counts
            # toward the "mget" family per the GET/MGET-run
            # definition, so the fusion ratio is interpretable against
            # the per-family breakdown in rtpu_resp_fused_cmds).
            self._count_fused(fam, j - i, j - i, None, 0.0)
            return frames, j
        if fam == "cms":
            # One estimate_all call for the whole run: the merged item
            # vector rides the near cache's lookup_batch partial-hit
            # split, so cached estimates never touch the device and only
            # misses ride the coalescer (ROADMAP near-cache reach).
            _, _, key, items, shape, _ = run
            vals = None
            if err is None:
                try:
                    vals = np.asarray(handle.result())
                except Exception as e:
                    err = e
            frames = []
            pos = 0
            names = []
            for nops in shape:
                names.append("CMS.QUERY")
                if err is not None:
                    frames.append(self._fused_error_frame(err))
                else:
                    frames.append(
                        _encode_array(
                            [int(v) for v in vals[pos : pos + nops]]
                        )
                    )
                pos += nops
            self._install_read_frames(
                rc, rc_state, batch, i, names, frames,
                readable=("CMS.QUERY",), err=err, wrote=False,
            )
            self._count_fused(
                fam, j - i, len(items), names,
                time.perf_counter() - t0, err=err,
            )
            return frames, j
        if fam == "bloom":
            _, _, key, items, flags, shape = run
            vals = None
            any_add = any(flags)
            if err is None:
                try:
                    vals = handle.result()
                except Exception as e:
                    err = e
            if any_add:
                self._bump_write_epoch()
            frames = []
            pos = 0
            names = []
            for nm, nops, many in shape:
                names.append(nm)
                if err is not None:
                    frames.append(self._fused_error_frame(err))
                elif many:
                    frames.append(
                        _encode_array(
                            [int(v) for v in vals[pos : pos + nops]]
                        )
                    )
                else:
                    frames.append(_encode_int(int(vals[pos])))
                pos += nops
            self._install_read_frames(
                rc, rc_state, batch, i, [s[0] for s in shape], frames,
                readable=("BF.EXISTS", "BF.MEXISTS"), err=err,
                wrote=any_add,
            )
            self._count_fused(
                fam, j - i, len(items), names,
                time.perf_counter() - t0, err=err,
            )
            return frames, j
        # fam == "bitset"
        _, _, key, idx, kinds, names = run
        any_write = any(k != 0 for k in kinds)
        groups = handle  # (start, end, future-or-exception) spans
        if any_write:
            self._bump_write_epoch()
        frames: list = [None] * len(kinds)
        # Resolve PER GROUP: consecutive groups joined one coalescer
        # segment (one launch), but a terminal failure can still be
        # group-scoped (a migration-split launch, a breaker opening
        # mid-run) — an earlier group's applied writes must answer their
        # real results, only the failed group's commands get the error
        # (the sequential path's granularity).
        for p, q, fut in groups:
            if isinstance(fut, BaseException):
                e = fut
            else:
                try:
                    vals = np.asarray(fut.result()).reshape(-1)
                    for o in range(p, q):
                        frames[o] = _encode_int(int(bool(vals[o - p])))
                    continue
                except Exception as ex:
                    e = ex
            err = err or e
            ef = self._fused_error_frame(e)
            for o in range(p, q):
                frames[o] = ef
        self._install_read_frames(
            rc, rc_state, batch, i, names, frames,
            readable=("GETBIT",), err=err, wrote=any_write,
        )
        self._count_fused(
            fam, j - i, len(idx), names, time.perf_counter() - t0, err=err,
        )
        return frames, j

    def _install_read_frames(self, rc, rc_state, batch, i, names, frames,
                             readable, err, wrote) -> None:
        """Feed a fused run's READ replies into the response-cache window
        (a later identical read in this pipeline serves for free).
        ``wrote``: the run contained writes — its read frames may have
        been computed BEFORE a same-key write later in the run, so none
        may be cached (the run's own epoch bump also refuses them in
        _rc_install; this skip is the cheap explicit form)."""
        if err is not None or wrote or self.response_cache_size <= 0:
            return
        for off, nm in enumerate(names):
            if nm in readable:
                self._rc_install(
                    rc, rc_state, nm, batch[i + off], frames[off]
                )

    def _count_fused(self, fam, ncmds, nops, names, dt, err=None) -> None:
        obs = self.obs
        if obs is None:
            return
        obs.resp_fused_runs.inc((fam,))
        obs.resp_fused_cmds.inc((fam,), ncmds)
        obs.resp_fused_ops.inc((fam,), nops)
        if names:
            # Per-command stats parity (INFO commandstats): each fused
            # command counts a call, with the run's wall time amortized.
            per = dt / max(1, ncmds)
            for nm in names:
                obs.record_resp_command(nm, per, err is not None)

    def _dispatch(self, cmd: list[bytes], ctx: "_ConnCtx",
                  name: Optional[str] = None) -> bytes:
        if name is None:  # _safe_dispatch passes the decoded name along
            name = cmd[0].decode().upper()
        if not ctx.authed and name not in ("AUTH", "HELLO", "QUIT", "RESET"):
            # Pre-auth surface is AUTH/HELLO/QUIT/RESET, like Redis
            # (pooled clients RESET connections before authenticating).
            raise RespError("NOAUTH Authentication required.")
        link = self.replica_link
        if link is not None:
            # Replica role: reads only.  Writes arrive solely over the
            # replication link — a client write accepted here would fork
            # this replica's history from its primary's.
            if (name not in _NONMUTATING and name not in _REPLICA_ADMIN
                    and not name.startswith("RTPU.")):
                raise RespError(
                    "READONLY You can't write against a read only replica."
                )
            bound = int(self._client.config.repl_max_staleness_ops or 0)
            if (bound > 0 and name in _NONMUTATING
                    and link.lag_ops() > bound and _command_keys(cmd)):
                # Bounded staleness: a keyed read on a replica that has
                # fallen more than the configured op count behind is
                # refused (retryable) instead of served silently stale.
                raise RespError(
                    f"STALEREAD replica is {link.lag_ops()} ops behind "
                    f"its primary (bound {bound}); retry or read the "
                    "primary"
                )
        shed = self._shed_at_ingress(name, cmd, ctx)
        if shed is not None:
            # Overload control plane (plus the tenant peek): refuse
            # engine-bound work at the door (the -BUSY retryable surface)
            # instead of letting it buy unbounded queue wait.  Strictly
            # pre-dispatch: a shed command was never executed, so no
            # acked state is involved.
            if shed == "tenant":
                raise RespError(
                    "BUSY RTPU tenant over quota: command shed at "
                    "ingress; retry later"
                )
            raise RespError(
                "BUSY RTPU overloaded: command shed at ingress (queue "
                f"pressure {self._pressure():.2f} over watermark "
                f"{self.admission_watermark:g}); retry later"
            )
        if ctx.in_multi and name not in ("EXEC", "DISCARD", "MULTI", "RESET"):
            # Redis MULTI semantics: commands queue (validated for
            # existence only) and run contiguously at EXEC.  Pub/sub
            # commands are rejected like Redis does — their push replies
            # would break the EXEC array framing.
            if name in ("SUBSCRIBE", "UNSUBSCRIBE"):
                ctx.queued = None  # poison: EXEC must abort
                raise RespError(
                    f"{name} is not allowed in transactions"
                )
            if getattr(
                self, "_cmd_" + name.replace(".", "_"), None
            ) is None and getattr(
                self, "_cmdctx_" + name.replace(".", "_"), None
            ) is None:
                ctx.queued = None  # poison: EXEC must abort
                raise RespError(f"unknown command '{name}'")
            if ctx.queued is not None:
                ctx.queued.append(cmd)
            return _encode_simple("QUEUED")
        return self._invoke_handler(name, cmd, ctx)

    def _invoke_handler(self, name: str, cmd: list, ctx: "_ConnCtx") -> bytes:
        ctx_handler = getattr(self, "_cmdctx_" + name.replace(".", "_"), None)
        if ctx_handler is not None:  # connection-stateful (pub/sub)
            return ctx_handler([c for c in cmd[1:]], ctx)
        handler = getattr(self, "_cmd_" + name.replace(".", "_"), None)
        if handler is None:
            raise RespError(f"unknown command '{name}'")
        return handler([c for c in cmd[1:]])

    @staticmethod
    def _s(b: bytes) -> str:
        return b.decode()

    @staticmethod
    def _raw(obj):
        """Foreign clients speak raw bytes: bypass the configured codec."""
        obj._enc = lambda v: v if isinstance(v, bytes) else str(v).encode()
        obj._dec = lambda v: v
        return obj

    # transactions (→ the reference's REDIS_WRITE_ATOMIC batch mode,
    # SURVEY §3.4: commands queue client-side and execute contiguously
    # at EXEC on this connection's thread)

    def _cmdctx_MULTI(self, args, ctx: _ConnCtx):
        if ctx.in_multi:
            raise RespError("MULTI calls can not be nested")
        ctx.in_multi = True
        ctx.queued = []
        return _encode_simple("OK")

    def _cmdctx_EXEC(self, args, ctx: _ConnCtx):
        if not ctx.in_multi:
            raise RespError("EXEC without MULTI")
        queued, ctx.queued, ctx.in_multi = ctx.queued, [], False
        if queued is None:  # a queue-time error poisons the transaction
            raise RespError(
                "EXECABORT Transaction discarded because of previous errors"
            )
        if queued and self._pressure_over() and any(
            c[0].decode("latin-1", "replace").upper() not in _SHED_EXEMPT
            for c in queued
        ):
            # Overload door for transactions: MULTI queueing
            # is free, so the judgment lands HERE, before any queued
            # command executes — otherwise wrapping work in MULTI/EXEC
            # would bypass ingress shedding entirely.  The transaction
            # is consumed (EXECABORT semantics), nothing partial ran.
            self._count_ingress_shed()
            raise RespError(
                "BUSY RTPU overloaded: transaction shed at EXEC (queue "
                f"pressure {self._pressure():.2f} over watermark "
                f"{self.admission_watermark:g}); retry later"
            )
        frames = []
        ctx.in_exec = True  # blocking commands act non-blocking (Redis)
        try:
            for c in queued:
                frames.append(self._safe_dispatch(c, ctx))
        finally:
            ctx.in_exec = False
        return b"*" + str(len(frames)).encode() + b"\r\n" + b"".join(frames)

    def _cmdctx_DISCARD(self, args, ctx: _ConnCtx):
        if not ctx.in_multi:
            raise RespError("DISCARD without MULTI")
        ctx.in_multi = False
        ctx.queued = []
        return _encode_simple("OK")

    # connection/admin

    def _cmd_PING(self, args):
        return _encode_simple("PONG") if not args else _encode_bulk(args[0])

    def _cmd_QUIT(self, args):
        # +OK then the read loop closes on the peer's FIN; also legal
        # pre-auth (part of the Redis unauthenticated surface).
        return _encode_simple("OK")

    def _cmd_SELECT(self, args):
        """One logical database (the engine's keyspace is flat): SELECT 0
        succeeds for stock-client handshakes, other indexes error like a
        databases=1 redis-server."""
        if int(args[0]) != 0:
            raise RespError("DB index is out of range")
        return _encode_simple("OK")

    def _cmdctx_RESET(self, args, ctx: _ConnCtx):
        """→ Redis RESET: abort MULTI, drop subscriptions, revert to
        RESP2 defaults, and de-authenticate when a password is set."""
        ctx.in_multi = False
        ctx.queued = []
        for channel, lid in list(ctx.subs.items()):
            self._client._topic_bus.unsubscribe(channel, lid)
        ctx.subs.clear()
        ctx.proto = 2
        ctx.client_name = None
        if self._requirepass:
            ctx.authed = False
        return _encode_simple("RESET")

    # CONFIG: the handful of keys stock clients interrogate on connect.
    # GET answers from this table; SET round-trips into it for the SAME
    # keys only (anything else errors — silently acking unknown tunables
    # would fake capabilities the engine does not have).
    _CONFIG_KEYS = {
        # Client-compat stubs: stock clients interrogate these on
        # connect; they have no live semantics here (writes round-trip
        # through the table, nothing applies), so there is nothing to
        # bounds-validate and no honest INFO line to emit.
        "maxmemory": "0",  # rtpulint: disable=RT004 client-compat stub, no live semantics
        "maxmemory-policy": "noeviction",  # rtpulint: disable=RT004 client-compat stub, no live semantics
        "save": "",  # rtpulint: disable=RT004 client-compat stub, no live semantics
        "databases": "1",  # rtpulint: disable=RT004 client-compat stub, no live semantics
        "timeout": "0",  # rtpulint: disable=RT004 client-compat stub, no live semantics
        "proto-max-bulk-len": "536870912",  # rtpulint: disable=RT004 client-compat stub, no live semantics
    }

    # Near-cache tunables live-apply to the engine's
    # SketchNearCache on CONFIG SET.  Registered only when the fronted
    # engine HAS a near cache (host engine: unknown option — silently
    # acking would fake a capability).
    def _nearcache(self):
        return getattr(getattr(self._client, "_engine", None),
                       "nearcache", None)

    def _residency(self):
        """The fronted engine's residency manager, or None
        on the host engine (no ladder to report or tune)."""
        return getattr(getattr(self._client, "_engine", None),
                       "residency", None)

    def _config_table_init(self) -> dict:
        table = dict(self._CONFIG_KEYS)
        nc = self._nearcache()
        if nc is not None:
            table.update({
                "nearcache": "yes" if nc.enabled else "no",
                "nearcache-max-bytes": str(nc.store.max_bytes),
                "nearcache-tenant-quota-bytes": str(
                    nc.store.tenant_quota_bytes
                ),
                "nearcache-max-batch": str(nc.max_batch),
            })
        # Overload control plane: live-settable everywhere the
        # serve layer applies (output-buffer limits, deadline default,
        # watermark); the engine-side knobs (fetch timeout, tenant
        # quotas) register only when the fronted engine HAS a coalescer/
        # governor — acking them on the host engine would fake the
        # capability.
        table.update({
            "op-deadline-ms": str(self.op_deadline_ms),
            "admission-watermark": f"{self.admission_watermark:g}",
            "client-output-buffer-limit": str(self.output_buffer_limit),
            "client-output-buffer-soft-seconds":
                f"{self.output_buffer_soft_seconds:g}",
        })
        rm = self._residency()
        if rm is not None:
            # Tiered residency: budgets and the promotion
            # threshold live-apply to the manager (arming a budget
            # starts the maintenance thread).
            table.update({
                "residency-device-rows": str(rm.device_rows),
                "residency-max-host-bytes": str(rm.max_host_bytes),
                "residency-max-disk-bytes": str(rm.max_disk_bytes),
                "residency-promote-heat": f"{rm.promote_heat:g}",
            })
        eng = getattr(self._client, "_engine", None)
        # Durability: appendonly/appendfsync are LIVE — CONFIG SET
        # enables/disables journaling and switches the fsync policy on
        # the running engine.
        table["appendonly"] = "yes" if eng.journal is not None else "no"  # rtpulint: disable=RT004 INFO persistence reports it under the Redis name aof_enabled, as the JAX server does
        table["appendfsync"] = str(eng.config.journal_fsync)
        c = getattr(eng, "coalescer", None)
        if c is not None:
            table["fetch-timeout-ms"] = str(
                int(c.fetch_timeout_s * 1000)
            )
        gov = getattr(eng, "governor", None)
        if gov is not None:
            table.update({
                "tenant-rate-limit": str(int(gov.rate_limit)),
                "tenant-burst-ops": str(int(gov._burst_cfg)),
                "tenant-max-inflight": str(int(gov.max_inflight)),
            })
        return table

    def _apply_nearcache_config(self, key: str, val: str) -> None:
        nc = self._nearcache()
        if nc is None:  # validated against the table: can't happen
            return
        if key == "nearcache":
            try:
                nc.set_enabled(val.lower() in ("yes", "1", "true", "on"))
            except ValueError as e:  # forced off under multi-host
                raise RespError(str(e)) from e
        elif key == "nearcache-max-bytes":
            nc.store.resize(max_bytes=int(val))
        elif key == "nearcache-tenant-quota-bytes":
            nc.store.resize(tenant_quota_bytes=int(val))
        elif key == "nearcache-max-batch":
            nc.max_batch = int(val)

    # Residency-ladder knobs with bounds validation before
    # apply (the nearcache/overload pattern): budgets are >= 0 ints
    # (0 disables that tier bound), the promote threshold a >= 0 float.
    _RESIDENCY_KEYS = frozenset((
        "residency-device-rows", "residency-max-host-bytes",
        "residency-max-disk-bytes", "residency-promote-heat",
    ))

    def _validate_residency_config(self, key: str, raw: bytes) -> None:
        try:
            fv = float(raw)
            if key != "residency-promote-heat":
                fv = int(raw)
        except ValueError:
            raise RespError(
                f"Invalid argument '{raw.decode()}' for CONFIG SET "
                f"'{key}'"
            )
        if fv < 0:
            raise RespError(
                f"argument must be >= 0 for CONFIG SET '{key}' "
                f"(0 disables this bound)"
            )

    def _apply_residency_config(self, key: str, val: str) -> None:
        rm = self._residency()
        if rm is None:  # validated against the table: can't happen
            return
        if key == "residency-device-rows":
            rm.set_budget(device_rows=int(val))
        elif key == "residency-max-host-bytes":
            rm.set_budget(max_host_bytes=int(val))
        elif key == "residency-max-disk-bytes":
            rm.set_budget(max_disk_bytes=int(val))
        elif key == "residency-promote-heat":
            rm.set_budget(promote_heat=float(val))

    # Overload knobs with bounds validation: CONFIG SET
    # rejects nonsense (negative deadline, zero watermark) instead of
    # applying it — the nearcache-knob pattern.
    _OVERLOAD_KEYS = frozenset((
        "op-deadline-ms", "admission-watermark", "fetch-timeout-ms",
        "tenant-rate-limit", "tenant-burst-ops", "tenant-max-inflight",
        "client-output-buffer-limit", "client-output-buffer-soft-seconds",
    ))

    def _validate_overload_config(self, key: str, raw: bytes) -> None:
        def bad(msg: str):
            raise RespError(
                f"argument must be {msg} for CONFIG SET '{key}'"
            )

        if key in ("admission-watermark",
                   "client-output-buffer-soft-seconds",
                   "tenant-rate-limit", "tenant-burst-ops"):
            # Float-valued knobs — validated exactly as wide as the
            # setter applies them (the governor takes fractional
            # rates).
            try:
                fv = float(raw)
            except ValueError:
                raise RespError(
                    f"Invalid argument '{raw.decode()}' for CONFIG SET "
                    f"'{key}'"
                )
            if key == "admission-watermark" and not 0.0 < fv <= 1.0:
                bad("in (0, 1] (use 1 to effectively disable shedding)")
            elif key != "admission-watermark" and fv < 0:
                bad(">= 0")
            return
        try:
            iv = int(raw)
        except ValueError:
            raise RespError(
                f"Invalid argument '{raw.decode()}' for CONFIG SET "
                f"'{key}'"
            )
        if key == "fetch-timeout-ms" and iv <= 0:
            bad("positive")
        if iv < 0:
            bad(">= 0")

    def _apply_overload_config(self, key: str, val: str) -> None:
        eng = getattr(self._client, "_engine", None)
        if key == "op-deadline-ms":
            self.op_deadline_ms = int(val)
        elif key == "admission-watermark":
            self.admission_watermark = float(val)
        elif key == "client-output-buffer-limit":
            self.output_buffer_limit = int(val)
        elif key == "client-output-buffer-soft-seconds":
            self.output_buffer_soft_seconds = float(val)
        elif key == "fetch-timeout-ms":
            c = getattr(eng, "coalescer", None)
            if c is not None:
                c.fetch_timeout_s = int(val) / 1000.0
        elif key in ("tenant-rate-limit", "tenant-burst-ops",
                     "tenant-max-inflight"):
            gov = getattr(eng, "governor", None)
            if gov is not None:
                if key == "tenant-rate-limit":
                    gov.set_limits(rate_limit=float(val))
                elif key == "tenant-burst-ops":
                    gov.set_limits(burst=float(val))
                else:
                    gov.set_limits(max_inflight=int(val))

    def _cmd_CONFIG(self, args):
        import fnmatch

        sub = args[0].decode().upper()
        if not hasattr(self, "_config_table"):
            self._config_table = self._config_table_init()
        if sub == "GET":
            pat = args[1].decode().lower()
            flat = []
            for k, v in sorted(self._config_table.items()):
                if fnmatch.fnmatch(k, pat):
                    flat.extend([k.encode(), v.encode()])
            return _encode_array(flat)
        if sub == "SET":
            pairs = args[1:]
            if not pairs or len(pairs) % 2 != 0:
                raise RespError(
                    "wrong number of arguments for 'config|set' command"
                )
            # Validate EVERY pair before applying any (Redis 7 multi-pair
            # form; acking while silently dropping pairs would fake
            # capabilities).
            for i in range(0, len(pairs), 2):
                key = pairs[i].decode().lower()
                if key not in self._config_table:
                    raise RespError(
                        f"Unknown option or number of arguments for "
                        f"CONFIG SET - '{key}'"
                    )
                if key in self._OVERLOAD_KEYS:
                    self._validate_overload_config(key, pairs[i + 1])
                elif key in self._RESIDENCY_KEYS:
                    self._validate_residency_config(key, pairs[i + 1])
                elif key == "appendonly":
                    v = pairs[i + 1].decode().lower()
                    if v not in ("yes", "no"):
                        raise RespError(
                            f"Invalid argument '{pairs[i + 1].decode()}' "
                            f"for CONFIG SET 'appendonly'"
                        )
                    if v == "yes" and not self._client.config.journal_dir:
                        # Refused BEFORE any table write: GET must never
                        # report yes without a live journal behind it.
                        raise RespError(
                            "appendonly needs Config.journal_dir on an "
                            "engine with the durability tier"
                        )
                elif key == "appendfsync":
                    from redisson_tpu_torch.durability import FSYNC_POLICIES

                    v = pairs[i + 1].decode().lower()
                    if v not in FSYNC_POLICIES:
                        raise RespError(
                            f"argument must be one of "
                            f"{'|'.join(FSYNC_POLICIES)} for CONFIG SET "
                            f"'appendfsync'"
                        )
                elif key.startswith("nearcache-"):
                    try:
                        iv = int(pairs[i + 1])
                    except ValueError:
                        raise RespError(
                            f"Invalid argument '{pairs[i + 1].decode()}' "
                            f"for CONFIG SET '{key}'"
                        )
                    # Bounds, like redis-server's out-of-range rejection:
                    # a negative/zero budget or batch cap would silently
                    # kill the cache while acking OK.  Quota 0 is legal
                    # (0 → re-derive the max_bytes/8 default).
                    if key in (
                        "nearcache-max-bytes", "nearcache-max-batch"
                    ) and iv <= 0:
                        raise RespError(
                            f"argument must be positive for CONFIG SET "
                            f"'{key}'"
                        )
                    if key == "nearcache-tenant-quota-bytes" and iv < 0:
                        raise RespError(
                            f"argument must be >= 0 for CONFIG SET "
                            f"'{key}'"
                        )
                elif key == "nearcache":
                    v = pairs[i + 1].decode().lower()
                    if v not in (
                        "yes", "no", "1", "0", "true", "false", "on", "off"
                    ):
                        raise RespError(
                            f"Invalid argument '{pairs[i + 1].decode()}' "
                            f"for CONFIG SET '{key}'"
                        )
                    nc = self._nearcache()
                    if (
                        nc is not None and nc.locked_off
                        and v in ("yes", "1", "true", "on")
                    ):
                        # Refused HERE, before any table write: CONFIG GET
                        # must never report yes while the cache is forced
                        # off (multi-host lockstep).
                        raise RespError(
                            "nearcache is forced off under multi-host "
                            "(a cache hit skips a device dispatch — "
                            "multi-controller lockstep)"
                        )
            for i in range(0, len(pairs), 2):
                key = pairs[i].decode().lower()
                val = pairs[i + 1].decode()
                if key == "appendonly":
                    # APPLY before the table write: journal attach can
                    # fail at runtime (unwritable dir, disk full) though
                    # validation passed — GET must never report yes
                    # without a live journal behind it.
                    try:
                        self._client._engine.journal_set_enabled(
                            val.lower() == "yes"
                        )
                    except (OSError, ValueError) as e:
                        raise RespError(
                            f"appendonly failed to apply: {e}"
                        ) from e
                elif key == "appendfsync":
                    self._client._engine.journal_set_policy(val.lower())
                self._config_table[key] = val
                # Live-apply the validated tunables.
                if key in self._OVERLOAD_KEYS:
                    self._apply_overload_config(key, val)
                elif key in self._RESIDENCY_KEYS:
                    self._apply_residency_config(key, val)
                elif key.startswith("nearcache"):
                    self._apply_nearcache_config(key, val)
            return _encode_simple("OK")
        if sub == "RESETSTAT":
            # Zero the commandstats/latencystats families, like Redis.
            self.obs.reset_command_stats()
            return _encode_simple("OK")
        raise RespError(f"Unknown CONFIG subcommand {sub}")


    def _persist_engine(self):
        eng = getattr(self._client, "_engine", None)
        if eng is None or not hasattr(eng, "snapshot"):
            raise RespError("engine has no snapshot support")
        sdir = getattr(eng.config, "snapshot_dir", None)
        if not sdir:
            raise RespError(
                "snapshot_dir is not configured (set Config.snapshot_dir)"
            )
        return eng, sdir

    def _cmd_SAVE(self, args):
        """Synchronous snapshot (the RDB SAVE analog): returns +OK only
        after the snapshot files are fsynced and renamed in — and, with
        a journal live, after covered segments retired."""
        eng, sdir = self._persist_engine()
        eng.snapshot(sdir)
        return _encode_simple("OK")

    def _bg_snapshot(self, eng, sdir) -> None:
        try:
            eng.snapshot(sdir)
        except Exception:  # pragma: no cover — surfaced via LASTSAVE
            pass

    def _cmd_BGSAVE(self, args):
        eng, sdir = self._persist_engine()
        threading.Thread(
            target=self._bg_snapshot, args=(eng, sdir),
            name="rtpu-bgsave", daemon=True,
        ).start()
        return _encode_simple("Background saving started")

    def _cmd_LASTSAVE(self, args):
        eng = getattr(self._client, "_engine", None)
        return _encode_int(int(getattr(eng, "_last_save_ts", 0.0) or 0))

    def _cmd_BGREWRITEAOF(self, args):
        """The journal's rewrite IS a snapshot: a completed snapshot
        records the journal cut and retires every covered segment
        (mark_snapshot), which is exactly the AOF-rewrite compaction."""
        eng, sdir = self._persist_engine()
        if eng.journal is None:
            raise RespError("appendonly is off (no journal to rewrite)")
        threading.Thread(
            target=self._bg_snapshot, args=(eng, sdir),
            name="rtpu-bgrewrite", daemon=True,
        ).start()
        return _encode_simple("Background append only file rewriting started")

    # -- durability fence and replication plane ----------------------------

    def _cmd_WAIT(self, args):
        """A JOURNAL-FSYNC FENCE plus a replica-ack fence.  With the
        journal live it forces an fsync covering every record appended so
        far — under any appendfsync policy — and blocks (up to the
        command's timeout-ms) until it lands; then, with replicas
        attached, it blocks until <numreplicas> of them ``REPLCONF
        ACK``ed an offset covering every record appended so far, and
        replies with the count that did (0 with no journal: the honest
        standalone answer)."""
        from redisson_tpu_torch.durability import JournalError

        timeout_s = None
        if len(args) >= 2:
            ms = int(args[1])
            timeout_s = ms / 1000.0 if ms > 0 else None
        try:
            if not self._client._engine.journal_fence(timeout=timeout_s):
                raise RespError("BUSY RTPU journal fsync fence timed out")
        except JournalError as e:
            raise RespError(f"journal is broken: {e}") from e
        hub = self._repl_hub()
        if hub is None:
            return _encode_int(0)
        # Fence offset: everything appended up to now, captured AFTER the
        # fsync fence — records appended while we waited are the next
        # WAIT's problem, exactly Redis's WAIT contract.
        fence_seq = hub.journal.last_seq()
        numreplicas = int(args[0]) if args else 0
        if numreplicas <= 0:
            return _encode_int(hub.count_acked(fence_seq))
        return _encode_int(hub.wait_acked(
            fence_seq, numreplicas,
            timeout_s if timeout_s is not None else float("inf"),
        ))

    def _repl_hub(self):
        """The primary-side ReplicationHub over the CURRENT journal —
        rebuilt when the journal object changes (a ``CONFIG SET
        appendonly`` re-attach or a promotion makes a NEW lineage: a
        fresh repl_id, so stale offsets can never partial-resync against
        a different history)."""
        j = self._client._engine.journal
        hub = self.repl_hub
        if j is None:
            if hub is not None:
                hub.detach()
                self.repl_hub = None
            return None
        if hub is None or hub.journal is not j:
            from redisson_tpu_torch.durability.replication import ReplicationHub

            if hub is not None:
                hub.detach()
            hub = self.repl_hub = ReplicationHub(
                j, obs=self.obs,
                backlog_bytes=int(self._client.config.repl_backlog_bytes or (4 << 20)),
            )
        return hub

    def _repl_offset(self) -> int:
        """This node's replication offset: a replica reports what it
        APPLIED; a primary reports its journal head."""
        link = self.replica_link
        if link is not None:
            return int(link.applied)
        j = self._client._engine.journal
        return int(j.last_seq()) if j is not None else 0

    def _repl_lag(self) -> int:
        link = self.replica_link
        return int(link.lag_ops()) if link is not None else 0

    def start_replication_from(self, host: str, port: int,
                               ident: Optional[str] = None,
                               replid: Optional[str] = None):
        """Turn this node into a replica of ``host:port``: start the pull
        link (durability/replica.py).  The link's existence flips the
        role to ``slave`` — the -READONLY gate and the bounded-staleness
        refusals in _dispatch key off it."""
        from redisson_tpu_torch.durability.replica import ReplicaLink

        if ident is None:
            import uuid

            ident = uuid.uuid4().hex[:16]
        link = ReplicaLink(
            self._client, host, int(port), ident,
            listening_port=self.port, obs=self.obs,
            replid=replid or getattr(self._client.config, "_repl_bootstrap_id", None),
        )
        self.replica_link = link
        link.start()
        return link

    def promote_to_primary(self, epoch: int = 0) -> None:
        """Takeover: stop applying the primary's stream, snapshot the
        promoted state — the local journal stayed EMPTY while
        replicating (the apply path never re-journals), so the snapshot
        is what makes this node's own crash recovery self-contained —
        and start a fresh replication lineage for replicas that re-home
        here.  ``epoch`` is the cluster failover epoch (0 without an
        agent)."""
        link, self.replica_link = self.replica_link, None
        if link is not None:
            link.stop()
        sdir = self._client.config.snapshot_dir
        if sdir:
            try:
                self._client.snapshot(sdir)
            except Exception:
                pass  # promotion never fails on snapshot I/O; LASTSAVE shows it
        hub = self.repl_hub
        if hub is not None:
            # Fresh lineage: replicas of the dead primary carry ITS
            # repl_id, which never matches a rebuilt hub — they full-
            # resync against the promoted state.
            hub.detach()
            self.repl_hub = None
        self._repl_hub()
        self._promote_epoch = int(epoch)
        self.obs.failover_takeovers.inc((), 1)

    def _cmdctx_REPLCONF(self, args, ctx: "_ConnCtx"):
        if not args:
            raise RespError(
                "wrong number of arguments for 'replconf' command"
            )
        sub = args[0].decode("latin-1", "replace").upper()
        if sub == "IDENT":
            # REPLCONF IDENT <replica-id> [listening-port] — names this
            # connection's replica so its ACKs land in the hub table.
            if len(args) < 2:
                raise RespError(
                    "REPLCONF IDENT <replica-id> [listening-port]"
                )
            ctx.repl_ident = self._s(args[1])
            if len(args) > 2:
                ctx.repl_listening_port = int(args[2])
            return _encode_simple("OK")
        if sub == "LISTENING-PORT":
            ctx.repl_listening_port = int(args[1])
            return _encode_simple("OK")
        if sub == "ACK":
            offset = int(args[1])
            if chaos.ENABLED:
                try:
                    chaos.fire("repl.ack", {"offset": offset})
                except (chaos.FaultInjected, chaos.CorruptionDetected):
                    # A dropped/garbled ack is LOST, not an error — the
                    # replica's next ack supersedes it (acks are
                    # max-merged).  WAIT fences simply see it later.
                    return _encode_simple("OK")
            hub = self._repl_hub()
            if hub is not None and ctx.repl_ident:
                addr = ctx.addr
                if ctx.repl_listening_port and ":" in addr:
                    addr = "%s:%d" % (
                        addr.rsplit(":", 1)[0], ctx.repl_listening_port
                    )
                hub.ack(ctx.repl_ident, offset, addr=addr)
            return _encode_simple("OK")
        if sub == "GETACK":
            return _encode_simple("OK")
        raise RespError(f"Unknown REPLCONF subcommand {sub}")

    def _snapshot_tar(self) -> tuple:
        """FULLRESYNC payload: take a REAL durable snapshot into the
        configured snapshot_dir (engine.snapshot retires journal
        segments, so shipping a temp-dir snapshot would break THIS
        node's crash recovery), then tar the directory.  Returns
        (snapshot's journal cut, tar bytes)."""
        import io
        import json
        import os
        import tarfile

        eng, sdir = self._persist_engine()
        self._client.snapshot(sdir)
        # Exclude concurrent snapshots (BGSAVE / the periodic
        # snapshotter) while reading meta + taring, so the cut seq and
        # the files describe the SAME capture.
        with eng._snapshot_lock:
            snap_seq = 0
            meta_path = os.path.join(sdir, "sketch_meta.json")
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    snap_seq = int(json.load(f).get("journal_seq") or 0)
            buf = io.BytesIO()
            with tarfile.open(fileobj=buf, mode="w") as tf:
                for fn in sorted(os.listdir(sdir)):
                    if fn.endswith(".tmp"):
                        continue  # a concurrent write's scratch files
                    tf.add(os.path.join(sdir, fn), arcname=fn)
        return snap_seq, buf.getvalue()

    def _require_hub(self):
        hub = self._repl_hub()
        if hub is None:
            raise RespError(
                "NOJOURNAL replication requires the op journal "
                "(set Config.journal_dir / appendonly yes)"
            )
        return hub

    def _cmd_RTPU_PSYNC(self, args):
        """RTPU.PSYNC <replid|?> <offset> → [CONTINUE, replid] when the
        (lineage, offset) can partial-resync, else [FULLRESYNC, replid,
        snap_seq, snapshot-tar]."""
        if len(args) < 2:
            raise RespError("RTPU.PSYNC <replid|?> <offset>")
        hub = self._require_hub()
        replid = self._s(args[0])
        offset = int(args[1])
        if replid != "?" and hub.can_continue(replid, offset):
            hub.note_partial_resync()
            return b"".join([
                b"*2\r\n", _encode_bulk(b"CONTINUE"),
                _encode_bulk(hub.repl_id.encode()),
            ])
        hub.note_full_resync()
        snap_seq, tar_bytes = self._snapshot_tar()
        return b"".join([
            b"*4\r\n", _encode_bulk(b"FULLRESYNC"),
            _encode_bulk(hub.repl_id.encode()),
            _encode_int(snap_seq), _encode_bulk(tar_bytes),
        ])

    def _cmd_RTPU_REPLFETCH(self, args):
        """RTPU.REPLFETCH <after> [maxn] [timeout-ms] → [replid,
        master_offset, [[seq, crc, payload], ...]] — the stream's pull
        verb.  Long-polls up to timeout-ms when the replica is caught up
        (the reactor detaches it like the other blocking commands)."""
        if not args:
            raise RespError("RTPU.REPLFETCH <after> [maxn] [timeout-ms]")
        hub = self._require_hub()
        after = int(args[0])
        maxn = int(args[1]) if len(args) > 1 else 512
        timeout_ms = int(args[2]) if len(args) > 2 else 0
        corrupt = False
        if chaos.ENABLED:
            try:
                chaos.fire("repl.stream", {"after": after})
            except chaos.FaultInjected:
                # Dropped batch: the replica sees an empty fetch and
                # re-polls — lost FRAMES are a latency event, never a
                # lost write (the journal retains them).
                return b"".join([
                    b"*3\r\n", _encode_bulk(hub.repl_id.encode()),
                    _encode_int(hub.journal.last_seq()), b"*0\r\n",
                ])
            except chaos.CorruptionDetected:
                corrupt = True  # flip a byte in one OUTGOING payload
        status, frames = hub.fetch(
            after, max_n=maxn, timeout_s=max(0, timeout_ms) / 1000.0
        )
        if status != "CONTINUE":
            raise RespError(
                "NOBACKLOG offset fell off the replication backlog; "
                "FULLRESYNC required"
            )
        if corrupt and frames:
            seq0, crc0, payload0 = frames[0]
            garbled = bytearray(payload0)
            garbled[len(garbled) // 2] ^= 0x40
            frames = [(seq0, crc0, bytes(garbled))] + list(frames[1:])
        out = [
            b"*3\r\n", _encode_bulk(hub.repl_id.encode()),
            _encode_int(hub.journal.last_seq()),
            b"*%d\r\n" % len(frames),
        ]
        for seq, crc, payload in frames:
            out.append(b"*3\r\n")
            out.append(_encode_int(seq))
            out.append(_encode_int(crc))
            out.append(_encode_bulk(payload))
        return b"".join(out)

    def _cmd_FAILOVER(self, args):
        """Manual FAILOVER (operator surface): on a replica, promote it
        to primary immediately (FAILOVER TAKEOVER semantics; epoch 0,
        there being no cluster failover agent)."""
        if self.replica_link is None:
            raise RespError("FAILOVER requires a replica role")
        self.promote_to_primary(epoch=0)
        return _encode_simple("OK")

    def _cmd_DEBUG(self, args):
        sub = args[0].decode().upper()
        if sub == "SLEEP":
            import time as _time

            _time.sleep(float(args[1]))
            return _encode_simple("OK")
        if sub == "RESIDENCY":
            # DEBUG RESIDENCY DEMOTE|PROMOTE|SPILL|LOAD <key> | TICK —
            # the residency ladder's forcing surface: soak
            # tests and operators drive exact transitions without
            # waiting out heat decay.  Admin-gated like DEBUG INJECT.
            if not self._inject_allowed:
                raise RespError(
                    "DEBUG RESIDENCY on a non-loopback bind requires "
                    "requirepass (tier forcing is an admin surface)"
                )
            rm = self._residency()
            if rm is None:
                raise RespError(
                    "this engine has no residency manager (host engine)"
                )
            if len(args) < 2:
                raise RespError(
                    "DEBUG RESIDENCY DEMOTE|PROMOTE|SPILL|LOAD <key> "
                    "| TICK"
                )
            verb = args[1].decode().upper()
            if verb == "TICK":
                out = rm.maintain()
                return _encode_array([
                    f"{k} {v}".encode() for k, v in sorted(out.items())
                ])
            if verb not in ("DEMOTE", "PROMOTE", "SPILL", "LOAD") or (
                len(args) < 3
            ):
                raise RespError(
                    "DEBUG RESIDENCY DEMOTE|PROMOTE|SPILL|LOAD <key> "
                    "| TICK"
                )
            fn = {
                "DEMOTE": rm.demote, "PROMOTE": rm.promote,
                "SPILL": rm.spill, "LOAD": rm.load,
            }[verb]
            try:
                ok = fn(self._s(args[2]))
            except (OSError, ValueError) as e:
                raise RespError(f"residency {verb.lower()}: {e}") from e
            return _encode_int(1 if ok else 0)
        if sub == "INJECT":
            # DEBUG INJECT <point> <kind> <rate> [seed] | DEBUG INJECT OFF
            # — the chaos engine's RESP admin surface (docs/robustness.md),
            # gated exactly like scripting (loopback-or-requirepass).
            if not self._inject_allowed:
                raise RespError(
                    "DEBUG INJECT on a non-loopback bind requires "
                    "requirepass (fault injection is an admin surface)"
                )
            if len(args) >= 2 and args[1].decode().upper() == "OFF":
                chaos.clear()
                return _encode_simple("OK")
            if len(args) == 2 and args[1].decode().upper() == "LIST":
                flat = []
                for point, (kind, rate, seed) in sorted(
                    chaos.active().items()
                ):
                    flat.append(
                        f"{point} {kind} {rate:g} seed={seed}".encode()
                    )
                return _encode_array(flat)
            if len(args) < 4:
                raise RespError(
                    "DEBUG INJECT <point> <kind> <rate> [seed] [seconds] "
                    "| OFF | LIST"
                )
            point = args[1].decode()
            kind = args[2].decode().lower()
            try:
                rate = float(args[3])
                seed = int(args[4]) if len(args) > 4 else 0
                # Optional magnitude: latency rules sleep this long,
                # pressure rules (overload.pressure) inflate
                # the admission wait estimate by it.
                latency_s = float(args[5]) if len(args) > 5 else 0.001
                chaos.inject(point, kind=kind, rate=rate, seed=seed,
                             latency_s=latency_s)
            except ValueError as e:
                raise RespError(str(e)) from e
            return _encode_simple("OK")
        raise RespError(f"unsupported DEBUG subcommand {sub}")

    def _cmd_OBJECT(self, args):
        """OBJECT introspection: for sketch
        objects the answers come from the residency ladder's live
        state — FREQ is the decayed access heat (the exact counter the
        demotion/promotion ranking uses), IDLETIME the seconds since
        the last engine-entry touch, and ENCODING reports the
        residency TIER (``device`` | ``host`` | ``disk``) so an
        operator can see where a key lives without DEBUG access.  Grid
        kinds keep the closest Redis encoding name.  Shed-exempt like
        the other introspection commands — it answers during the
        incident it helps debug."""
        sub = args[0].decode().upper()
        if sub == "HELP":
            return _encode_array([
                b"OBJECT ENCODING|REFCOUNT|IDLETIME|FREQ <key>",
            ])
        if sub not in ("ENCODING", "REFCOUNT", "IDLETIME", "FREQ"):
            raise RespError(f"Unknown OBJECT subcommand {sub}")
        if len(args) < 2:
            raise RespError(
                "wrong number of arguments for 'object' command"
            )
        name = self._s(args[1])
        kind = self._kind_of(name)
        if kind is None:
            raise RespError("no such key")
        rm = self._residency()
        sketch_entry = None
        if rm is not None:
            reg = getattr(self._client._engine, "registry", None)
            if reg is not None:
                sketch_entry = reg.lookup(name)
        if sub == "ENCODING":
            if sketch_entry is not None:
                return _encode_bulk(
                    getattr(sketch_entry, "residency", "device").encode()
                )
            enc = {
                "string": "embstr", "list": "quicklist",
                "hash": "hashtable", "set": "hashtable",
                "zset": "skiplist", "stream": "stream",
            }.get(self._TYPE_NAMES.get(kind, kind), "embstr")
            return _encode_bulk(enc.encode())
        if sub == "REFCOUNT":
            return _encode_int(1)
        if sub == "IDLETIME":
            if sketch_entry is not None:
                return _encode_int(int(rm.heat.idle_s(name)))
            return _encode_int(0)
        if sub == "FREQ":
            if sketch_entry is not None:
                import math

                # Redis parity: OBJECT FREQ is an
                # LFU counter on a 0-255 LOGARITHMIC scale, not a raw
                # count.  Map the unbounded decayed heat h through
                # min(255, round(32·log2(1+h))) — 32 points per heat
                # doubling, saturating at h ≈ 255 — so redis-cli
                # --hotkeys (which ranks by OBJECT FREQ) reads sane
                # values.  The raw decayed heat stays inspectable
                # through the residency surfaces (docs/observability.md
                # documents the mapping).
                h = max(0.0, rm.heat.heat(name))
                return _encode_int(
                    min(255, int(round(32.0 * math.log2(1.0 + h))))
                )
            return _encode_int(0)
        raise RespError(f"Unknown OBJECT subcommand {sub}")

    def _cmd_SCAN(self, args):
        """Cursor iteration with the Redis SCAN guarantee (keys present
        for the whole iteration are returned): the integer cursor maps to
        server-side resume state holding the LAST KEY returned, and each
        page lists live keys lexicographically after it — concurrent
        deletes can't shift the position.  State for abandoned cursors is
        evicted LRU (cap 1024)."""
        cursor = int(args[0])
        pattern, count = None, 10
        i = 1
        while i < len(args):
            opt = args[i].decode().upper()
            if opt == "MATCH":
                pattern = self._s(args[i + 1])
                i += 2
            elif opt == "COUNT":
                count = int(args[i + 1])
                if count < 1:
                    raise RespError("syntax error")
                i += 2
            else:
                raise RespError("syntax error")
        with self._scan_lock:
            after = None if cursor == 0 else self._scan_states.pop(cursor, None)
            if cursor != 0 and (after is None or not isinstance(after, str)):
                # Unknown/evicted cursor — or one minted by a COLLECTION
                # scan (HSCAN/SSCAN/ZSCAN states are tagged tuples):
                # Redis treats it as terminated.
                return b"*2\r\n" + _encode_bulk("0") + _encode_array([])
        keys = sorted(self._client.get_keys().get_keys(pattern))
        if after is not None:
            import bisect

            start = bisect.bisect_right(keys, after)
        else:
            start = 0
        page = keys[start : start + count]
        if start + count < len(keys):
            with self._scan_lock:
                self._scan_next += 1
                nxt = self._scan_next
                self._scan_states[nxt] = page[-1]
                while len(self._scan_states) > 1024:  # LRU cap
                    self._scan_states.pop(next(iter(self._scan_states)))
        else:
            nxt = 0
        return b"*2\r\n" + _encode_bulk(str(nxt)) + _encode_array(page)

    @staticmethod
    def _parse_scan_opts(args, i):
        pattern, count, novalues = None, 10, False
        while i < len(args):
            opt = args[i].decode().upper()
            if opt == "MATCH":
                pattern = args[i + 1].decode("latin-1")
                i += 2
            elif opt == "COUNT":
                count = int(args[i + 1])
                if count < 1:
                    raise RespError("syntax error")
                i += 2
            elif opt == "NOVALUES":
                novalues = True
                i += 1
            else:
                raise RespError("syntax error")
        return pattern, count, novalues

    def _collection_scan(self, tag: str, key: bytes, cursor: int,
                         items: list, pattern, count: int):
        """Shared HSCAN/SSCAN/ZSCAN cursor engine (SURVEY §2.1 iterators
        row): ``items`` is [(sort_bytes, reply_items_tuple)]; resume
        state holds the LAST sort key returned, so members present for
        the whole iteration are always returned even across concurrent
        deletes.  States live in the same LRU table as SCAN's, tagged
        with (command, key) so a cursor replayed against a different
        command or key terminates instead of desyncing."""
        import bisect
        import fnmatch

        with self._scan_lock:
            state = None if cursor == 0 else self._scan_states.pop(cursor, None)
            if cursor != 0 and (
                not isinstance(state, tuple)
                or state[:2] != (tag, key)
            ):
                return b"*2\r\n" + _encode_bulk("0") + _encode_array([])
            after = None if state is None else state[2]
        if pattern is not None:
            items = [
                it for it in items
                if fnmatch.fnmatch(it[0].decode("latin-1"), pattern)
            ]
        items.sort(key=lambda it: it[0])
        start = (
            0 if after is None
            else bisect.bisect_right([it[0] for it in items], after)
        )
        page = items[start : start + count]
        if start + count < len(items):
            with self._scan_lock:
                self._scan_next += 1
                nxt = self._scan_next
                self._scan_states[nxt] = (tag, key, page[-1][0])
                while len(self._scan_states) > 1024:  # LRU cap
                    self._scan_states.pop(next(iter(self._scan_states)))
        else:
            nxt = 0
        flat = [x for _, reply in page for x in reply]
        return b"*2\r\n" + _encode_bulk(str(nxt)) + _encode_array(flat)

    def _cmd_HSCAN(self, args):
        pattern, count, novalues = self._parse_scan_opts(args, 2)
        m = self._map(args[0])
        items = [
            (k, (k,) if novalues else (k, v))
            for k, v in m.entry_set()
        ]
        return self._collection_scan(
            "HSCAN", args[0], int(args[1]), items, pattern, count
        )

    def _cmd_SSCAN(self, args):
        pattern, count, _ = self._parse_scan_opts(args, 2)
        s = self._set(args[0])
        items = [(v, (v,)) for v in s.read_all()]
        return self._collection_scan(
            "SSCAN", args[0], int(args[1]), items, pattern, count
        )

    def _cmd_ZSCAN(self, args):
        pattern, count, _ = self._parse_scan_opts(args, 2)
        z = self._zset(args[0])
        items = [
            (m, (m, _fmt_score(sc).encode()))
            for m, sc in z.entry_range(0, -1)
        ]
        return self._collection_scan(
            "ZSCAN", args[0], int(args[1]), items, pattern, count
        )

    def _zstore(self, args, intersect: bool):
        """ZUNIONSTORE/ZINTERSTORE dest numkeys key... [WEIGHTS w...]
        [AGGREGATE SUM|MIN|MAX] — atomic replace of dest, returns the
        stored cardinality."""
        dest = args[0]
        numkeys = int(args[1])
        keys = args[2 : 2 + numkeys]
        weights = [1.0] * numkeys
        agg = "SUM"
        i = 2 + numkeys
        while i < len(args):
            opt = args[i].decode().upper()
            if opt == "WEIGHTS":
                ws = args[i + 1 : i + 1 + numkeys]
                if len(ws) != numkeys:
                    # zip() would silently drop the unweighted keys
                    raise RespError("syntax error")
                weights = [float(a) for a in ws]
                i += 1 + numkeys
            elif opt == "AGGREGATE":
                agg = args[i + 1].decode().upper()
                if agg not in ("SUM", "MIN", "MAX"):
                    raise RespError("syntax error")
                i += 2
            else:
                raise RespError("syntax error")
        with self._client._grid.lock:  # atomic multi-key read + replace
            maps = []
            for k, w in zip(keys, weights):
                entries = {
                    m: sc * w for m, sc in self._zset(k).entry_range(0, -1)
                }
                maps.append(entries)
            if intersect:
                members = set(maps[0]) if maps else set()
                for d in maps[1:]:
                    members &= set(d)
            else:
                members = set()
                for d in maps:
                    members |= set(d)
            out = {}
            for m in members:
                vals = [d[m] for d in maps if m in d]
                out[m] = (
                    sum(vals) if agg == "SUM"
                    else min(vals) if agg == "MIN" else max(vals)
                )
            dz = self._zset(dest)
            dz.delete()
            for m, sc in out.items():
                dz.add(sc, m)
            return _encode_int(len(out))

    def _cmd_ZUNIONSTORE(self, args):
        return self._zstore(args, intersect=False)

    def _cmd_ZINTERSTORE(self, args):
        return self._zstore(args, intersect=True)

    def _cmd_ZRANGEBYLEX(self, args):
        """Lexicographic range over same-score members: '[m' inclusive,
        '(m' exclusive, '-'/'+' unbounded; LIMIT offset count."""
        lo, hi = args[1], args[2]
        offset, count = 0, None
        if len(args) >= 6 and args[3].decode().upper() == "LIMIT":
            offset, count = int(args[4]), int(args[5])

        def bound(b):
            if b in (b"-", b"+"):
                return None, True
            if b[:1] == b"[":
                return b[1:], True
            if b[:1] == b"(":
                return b[1:], False
            raise RespError("min or max not valid string range item")

        lo_v, lo_inc = bound(lo)
        hi_v, hi_inc = bound(hi)

        def in_range(m):
            if lo == b"+" or hi == b"-":
                return False  # inverted/empty ranges match nothing
            if lo != b"-" and (m < lo_v or (m == lo_v and not lo_inc)):
                return False
            if hi != b"+" and (m > hi_v or (m == hi_v and not hi_inc)):
                return False
            return True

        members = sorted(
            m for m, _ in self._zset(args[0]).entry_range(0, -1)
        )
        out = [m for m in members if in_range(m)]
        if count is None or count < 0:
            out = out[offset:]  # Redis: negative count = all remaining
        else:
            out = out[offset : offset + count]
        return _encode_array(out)

    def _cmd_ECHO(self, args):
        return _encode_bulk(args[0])

    def _cmd_GETEX(self, args):
        """GET that also adjusts the key's TTL (exactly ONE of
        EX/PX/EXAT/PXAT/PERSIST; no option = plain GET without touching
        expiry).  TTL mutation rides the GridStore expire helpers — the
        same path EXPIRE/EXPIREAT/PERSIST use."""
        if len(args) > 3:
            raise RespError("syntax error")  # at most one expiry option
        opt = args[1].decode().upper() if len(args) > 1 else None
        operand = args[2] if len(args) > 2 else None
        if opt in ("EX", "PX", "EXAT", "PXAT"):
            if operand is None:
                raise RespError("syntax error")
        elif opt == "PERSIST":
            if operand is not None:
                raise RespError("syntax error")
        elif opt is not None:
            raise RespError("syntax error")
        import time as _time

        grid = self._client._grid
        name = self._s(args[0])
        with grid.lock:
            v = self._str_get(args[0])
            if v is None:
                return _encode_bulk(None)
            if opt == "EX":
                grid.expire(name, float(operand))
            elif opt == "PX":
                grid.expire(name, float(operand) / 1000.0)
            elif opt == "EXAT":
                grid.expire_at(name, float(operand))
            elif opt == "PXAT":
                grid.expire_at(name, float(operand) / 1000.0)
            elif opt == "PERSIST":
                grid.clear_expire(name)
        return _encode_bulk(v)

    def _cmd_COPY(self, args):
        """Grid-keyspace COPY (sketch-backend keys report 0 — their
        state lives in device pools, not copyable entries).  Deep-copies
        the value so the two keys never alias mutations."""
        import copy as _copy

        src, dst = self._s(args[0]), self._s(args[1])
        if src == dst:
            raise RespError(
                "source and destination objects are the same"
            )
        replace = any(a.decode().upper() == "REPLACE" for a in args[2:])
        grid = self._client._grid
        with grid.lock:
            e = grid.get_entry(src)
            if e is None:
                return _encode_int(0)
            if not replace and grid.get_entry(dst) is not None:
                return _encode_int(0)
            ne = grid.put_entry(dst, e.kind, _copy.deepcopy(e.value))
            ne.expire_at = e.expire_at
            return _encode_int(1)


    def _cmd_LMOVE(self, args):
        """LMOVE src dst LEFT|RIGHT LEFT|RIGHT — the RPOPLPUSH
        generalization, atomic under the grid lock."""
        wherefrom = args[2].decode().upper()
        whereto = args[3].decode().upper()
        if wherefrom not in ("LEFT", "RIGHT") or whereto not in ("LEFT", "RIGHT"):
            raise RespError("syntax error")
        src, dst = self._list(args[0]), self._list(args[1])
        grid = self._client._grid
        with grid.lock:
            # Destination kind check BEFORE popping (the pattern
            # poll_last_and_offer_first_to uses): a WRONGTYPE destination
            # discovered after the pop would lose the element.
            de = grid.get_entry(self._s(args[1]))
            if de is not None and de.kind not in ("list", "queue"):
                raise TypeError(
                    f"object {self._s(args[1])!r} holds a {de.kind}, "
                    f"not a list"
                )
            v = (
                src.poll_first() if wherefrom == "LEFT" else src.poll_last()
            )
            if v is None:
                return _encode_bulk(None)
            if whereto == "LEFT":
                dst.add_first(v)
            else:
                dst.add_last(v)
        return _encode_bulk(v)

    def _cmd_SINTERCARD(self, args):
        numkeys = int(args[0])
        keys = args[1 : 1 + numkeys]
        limit = None
        if len(args) > 1 + numkeys:
            if args[1 + numkeys].decode().upper() != "LIMIT":
                raise RespError("syntax error")
            limit = int(args[2 + numkeys])
            if limit < 0:
                raise RespError("LIMIT can't be negative")
        with self._client._grid.lock:
            acc = None
            for k in keys:
                members = set(self._set(k).read_all())
                acc = members if acc is None else (acc & members)
                if not acc:
                    break
        n = 0 if acc is None else len(acc)
        if limit:  # LIMIT 0 = unlimited, like Redis
            n = min(n, limit)
        return _encode_int(n)

    def _cmd_LPOS(self, args):
        """LPOS key element [RANK r] [COUNT c]."""
        rank, count = 1, None
        i = 2
        while i < len(args):
            opt = args[i].decode().upper()
            if opt == "RANK":
                rank = int(args[i + 1])
                if rank == 0:
                    raise RespError("RANK can't be zero")
                i += 2
            elif opt == "COUNT":
                count = int(args[i + 1])
                if count < 0:
                    raise RespError("COUNT can't be negative")
                i += 2
            else:
                raise RespError("syntax error")
        items = self._listidx(args[0]).read_all()
        target = args[1]
        matches = [ix for ix, v in enumerate(items) if v == target]
        if rank < 0:
            matches = list(reversed(matches))[(-rank - 1):]
        else:
            matches = matches[(rank - 1):]
        if count is None:
            return (
                _encode_int(matches[0]) if matches else _encode_bulk(None)
            )
        if count == 0:
            return _encode_array(matches)
        return _encode_array(matches[:count])

    def _cmd_HRANDFIELD(self, args):
        import random

        entries = self._map(args[0]).entry_set()
        if len(args) == 1:
            if not entries:
                return _encode_bulk(None)
            return _encode_bulk(random.choice(entries)[0])
        count = int(args[1])
        withvalues = (
            len(args) > 2 and args[2].decode().upper() == "WITHVALUES"
        )
        if count >= 0:  # distinct fields, up to the hash size
            picked = random.sample(entries, min(count, len(entries)))
        else:  # negative: repeats allowed, exactly |count| results
            picked = (
                [random.choice(entries) for _ in range(-count)]
                if entries else []
            )
        flat = []
        for f, v in picked:
            flat.append(f)
            if withvalues:
                flat.append(v)
        return _encode_array(flat)

    def _cmd_ZRANDMEMBER(self, args):
        import random

        entries = self._zset(args[0]).entry_range(0, -1)
        if len(args) == 1:
            if not entries:
                return _encode_bulk(None)
            return _encode_bulk(random.choice(entries)[0])
        count = int(args[1])
        withscores = (
            len(args) > 2 and args[2].decode().upper() == "WITHSCORES"
        )
        if count >= 0:
            picked = random.sample(entries, min(count, len(entries)))
        else:
            picked = (
                [random.choice(entries) for _ in range(-count)]
                if entries else []
            )
        flat = []
        for m, sc in picked:
            flat.append(m)
            if withscores:
                flat.append(_fmt_score(sc).encode())
        return _encode_array(flat)

    def _cmd_KEYS(self, args):
        pattern = self._s(args[0]) if args else "*"
        return _encode_array(self._client.get_keys().get_keys(pattern))

    def _cmd_DBSIZE(self, args):
        return _encode_int(self._client.get_keys().count())

    def _cmd_FLUSHALL(self, args):
        self._client.get_keys().flushall()
        return _encode_simple("OK")

    # strings (raw-bytes bucket)

    def _bucket(self, key: bytes):
        from redisson_tpu_torch.grid.buckets import Bucket

        return self._raw(Bucket(self._s(key), self._client))

    def _str_get(self, key: bytes) -> Optional[bytes]:
        """String-view read: Redis counters ARE string keys, so the
        string read commands must serve atomiclong/atomicdouble entries
        (created via the Python counter API) in their string form
        rather than raising WRONGTYPE — TYPE already reports them as
        "string" (see _cmd_TYPE)."""
        grid = self._client._grid
        with grid.lock:
            e = grid.get_entry(self._s(key))
            if e is not None and e.kind in ("atomiclong", "atomicdouble"):
                v = e.value
                return (
                    _fmt_score(v) if isinstance(v, float) else str(int(v))
                ).encode()
        return self._bucket(key).get()

    def _cmd_SET(self, args):
        key, value = args[0], args[1]
        ttl = None
        i = 2
        while i < len(args):
            opt = args[i].decode().upper()
            if opt == "EX":
                ttl = float(args[i + 1])
                i += 2
            elif opt == "PX":
                ttl = float(args[i + 1]) / 1000.0
                i += 2
            else:
                raise RespError(f"unsupported SET option {opt}")
        self._bucket(key).set(value, ttl_seconds=ttl)
        return _encode_simple("OK")

    def _cmd_GET(self, args):
        return _encode_bulk(self._str_get(args[0]))

    def _cmd_MGET(self, args):
        out = []
        for k in args:
            try:
                out.append(self._str_get(k))
            except TypeError:  # WRONGTYPE slot: nil, Redis-style
                out.append(None)
        return _encode_array(out)

    def _cmd_MSET(self, args):
        for i in range(0, len(args), 2):
            self._bucket(args[i]).set(args[i + 1])
        return _encode_simple("OK")

    def _cmd_SETNX(self, args):
        return _encode_int(int(self._bucket(args[0]).set_if_absent(args[1])))

    def _cmd_SETEX(self, args):
        self._bucket(args[0]).set(args[2], ttl_seconds=float(args[1]))
        return _encode_simple("OK")

    def _cmd_PSETEX(self, args):
        self._bucket(args[0]).set(args[2], ttl_seconds=float(args[1]) / 1000)
        return _encode_simple("OK")

    def _cmd_GETSET(self, args):
        with self._client._grid.lock:  # atomic RMW (RLock)
            v = self._str_get(args[0])
            self._bucket(args[0]).set(args[1])
        return _encode_bulk(v)

    def _cmd_GETDEL(self, args):
        with self._client._grid.lock:  # atomic read+delete (RLock)
            v = self._str_get(args[0])
            if v is not None:
                self._client._grid.delete(self._s(args[0]))
        return _encode_bulk(v)

    def _cmd_APPEND(self, args):
        b = self._bucket(args[0])
        with self._client._grid.lock:  # atomic RMW, Redis APPEND contract
            v = (self._str_get(args[0]) or b"") + args[1]
            b.set(v)  # no longer numeric: the bucket kind is honest now
        return _encode_int(len(v))

    def _cmd_STRLEN(self, args):
        v = self._str_get(args[0])
        return _encode_int(0 if v is None else len(v))

    def _cmd_GETRANGE(self, args):
        v = self._str_get(args[0]) or b""
        start, end = int(args[1]), int(args[2])
        if start < 0:
            start = max(0, len(v) + start)
        if end < 0:
            end = max(0, len(v) + end)  # Redis clamps BOTH offsets to 0
        return _encode_bulk(v[start : end + 1])

    def _cmd_SETRANGE(self, args):
        b = self._bucket(args[0])
        off = int(args[1])
        if off < 0:
            raise RespError("offset is out of range")
        with self._client._grid.lock:  # atomic RMW
            v = bytearray(self._str_get(args[0]) or b"")
            if len(v) < off + len(args[2]):
                v.extend(b"\x00" * (off + len(args[2]) - len(v)))
            v[off : off + len(args[2])] = args[2]
            b.set(bytes(v))
        return _encode_int(len(v))

    def _cmd_DEL(self, args):
        return _encode_int(
            self._client.get_keys().delete(*[self._s(a) for a in args])
        )

    def _cmd_EXISTS(self, args):
        return _encode_int(
            self._client.get_keys().count_exists(*[self._s(a) for a in args])
        )

    def _cmd_EXPIRE(self, args):
        ok = self._client.get_keys().expire(self._s(args[0]), float(args[1]))
        return _encode_int(int(ok))

    def _cmd_PEXPIRE(self, args):
        ok = self._client.get_keys().expire(
            self._s(args[0]), float(args[1]) / 1000.0
        )
        return _encode_int(int(ok))

    def _cmd_TTL(self, args):
        ms = self._client.get_keys().remain_time_to_live(self._s(args[0]))
        return _encode_int(ms if ms < 0 else ms // 1000)

    def _cmd_PTTL(self, args):
        return _encode_int(
            self._client.get_keys().remain_time_to_live(self._s(args[0]))
        )

    def _cmd_PERSIST(self, args):
        name = self._s(args[0])
        grid_ok = self._client._grid.clear_expire(name)
        eng = getattr(self._client._engine, "clear_expire", None)
        return _encode_int(int(grid_ok or (eng is not None and eng(name))))

    def _cmd_RENAME(self, args):
        try:
            self._client.get_keys().rename(self._s(args[0]), self._s(args[1]))
        except RuntimeError as e:
            raise RespError(str(e))
        return _encode_simple("OK")

    def _cmd_RENAMENX(self, args):
        if self._exists_any(self._s(args[1])):
            return _encode_int(0)
        self._client.get_keys().rename(self._s(args[0]), self._s(args[1]))
        return _encode_int(1)

    def _cmd_EXPIREAT(self, args):
        import time as _time

        ttl = float(args[1]) - _time.time()
        ok = self._client.get_keys().expire(self._s(args[0]), max(ttl, 0.001))
        return _encode_int(int(ok))

    def _cmd_PEXPIREAT(self, args):
        import time as _time

        ttl = float(args[1]) / 1000.0 - _time.time()
        ok = self._client.get_keys().expire(self._s(args[0]), max(ttl, 0.001))
        return _encode_int(int(ok))

    def _cmd_RANDOMKEY(self, args):
        return _encode_bulk(self._client.get_keys().random_key())

    # server / connection admin

    # Default INFO excludes commandstats/latencystats, like redis-server
    # (they can be wide); 'INFO all'/'everything' or the explicit section
    # name includes them.  The JAX package's replication, cluster,
    # rebalance, telemetry, events, doctor and loadstats sections wait
    # with their modules.
    _INFO_DEFAULT = (
        "server", "clients", "memory", "stats", "persistence",
        "replication", "nearcache", "frontdoor", "overload", "keyspace",
    )

    def _device_lines(self) -> list:
        """The card (or CPU) the fronted engine's pools live on."""
        import torch

        dev = self._client._engine.executor.device
        lines = [f"rtpu_device:{dev.type}"]
        if dev.type == "cuda":
            idx = dev.index if dev.index is not None else 0
            lines.append(
                f"rtpu_device_name:{torch.cuda.get_device_name(idx)}"
            )
        return lines

    def _pool_bytes(self) -> int:
        """Device-resident sketch pool bytes (every size-class pool)."""
        return sum(
            int(p.state.numel()) * p.state.element_size()
            for p in self._client._engine.registry.pools()
        )

    def _cmd_INFO(self, args):
        section = args[0].decode().lower() if args else "default"
        if section == "default":
            sections = self._INFO_DEFAULT
        elif section in ("all", "everything"):
            sections = self._INFO_DEFAULT + ("commandstats", "latencystats")
        else:
            sections = (section,)
        obs = self.obs
        lines: list[str] = []
        for s in sections:
            if s == "server":
                lines += [
                    "# Server", "redis_version:7.9.9",
                    "redis_mode:standalone",
                    "run_id:redisson-tpu",
                    f"uptime_in_seconds:{int(time.monotonic() - self._started)}",
                ] + self._device_lines()
            elif s == "clients":
                lines += [
                    "# Clients",
                    f"connected_clients:{self._nconn}",
                    f"maxclients:{self.max_connections}",
                    # Conn-limit refusals: the
                    # accept-loop shed reactor-mode capacity tuning
                    # watches (also rtpu_resp_ingress_shed{conn_limit}).
                    f"rejected_connections:{self._conns_refused}",
                ]
            elif s == "memory":
                total = self._pool_bytes()
                lines += [
                    "# Memory",
                    f"used_memory:{total}",  # device-resident pool bytes
                    "maxmemory:0",
                    "maxmemory_policy:noeviction",
                ]
                # Tiered residency: where the keyspace
                # actually lives — fast-tier occupancy vs budget, the
                # host-mirror and disk-blob footprints, and lifetime
                # transition counts (the SWAPIN/SWAPOUT view).
                rm = self._residency()
                if rm is not None:
                    st = rm.stats()
                    lines += [
                        f"residency_device_rows:{st['device_rows_used']}",
                        f"residency_device_rows_budget:"
                        f"{st['device_rows_budget']}",
                        f"residency_host_objects:{st['host_objects']}",
                        f"residency_host_bytes:{st['host_bytes']}",
                        f"residency_max_host_bytes:{rm.max_host_bytes}",
                        f"residency_disk_objects:{st['disk_objects']}",
                        f"residency_disk_bytes:{st['disk_bytes']}",
                        f"residency_max_disk_bytes:{rm.max_disk_bytes}",
                        f"residency_promote_heat:{rm.promote_heat:g}",
                        f"residency_promotions:{st['promotions']}",
                        f"residency_demotions:{st['demotions']}",
                        f"residency_spills:{st['spills']}",
                        f"residency_loads:{st['loads']}",
                        f"residency_host_serves:{st['host_serves']}",
                    ]
            elif s == "stats":
                total_cmds = (
                    sum(int(c.value) for _, c in obs.resp_commands.items())
                    if obs is not None else 0
                )
                lines += [
                    "# Stats",
                    f"total_connections_received:{self._conns_accepted}",
                    f"total_commands_processed:{total_cmds}",
                ]
                # Self-healing dispatch: the degraded flag —
                # sketches serving from the host golden mirror while a
                # circuit breaker is open.
                health = getattr(
                    getattr(self._client, "_engine", None), "health", None
                )
                if health is not None:
                    mirrors = getattr(self._client._engine, "_mirrors", {})
                    lines += [
                        f"degraded:{1 if health.any_degraded else 0}",
                        f"degraded_objects:{len(mirrors)}",
                        f"breakers_open:{health.board.open_count()}",
                        f"executor_health:{health.state()}",
                    ]
            elif s == "commandstats" and obs is not None:
                lines.append("# Commandstats")
                for cmd, st in sorted(obs.command_stats().items()):
                    lines.append(
                        f"cmdstat_{cmd.lower()}:calls={st['calls']},"
                        f"usec={st['usec']},"
                        f"usec_per_call={st['usec_per_call']},"
                        f"rejected_calls=0,failed_calls={st['errors']}"
                    )
            elif s == "latencystats" and obs is not None:
                lines.append("# Latencystats")
                for cmd, st in sorted(obs.latency_stats().items()):
                    lines.append(
                        f"latency_percentiles_usec_{cmd.lower()}:"
                        f"p50={st['p50_us']:g},p99={st['p99_us']:g},"
                        f"p99.9={st['p999_us']:g}"
                    )
            elif s == "persistence":
                # Snapshot + journal state: the aof_*/rdb_* vocabulary
                # stock tooling expects, plus the journal's seq, lag and
                # segment lines.
                eng = getattr(self._client, "_engine", None)
                j = eng.journal
                lines += [
                    "# Persistence",
                    "loading:0",
                    f"rdb_last_save_time:"
                    f"{int(getattr(eng, '_last_save_ts', 0.0) or 0)}",
                    f"aof_enabled:{0 if j is None else 1}",
                ]
                if j is not None:
                    st = j.stats()
                    replayed = sum(c.value for _, c in obs.journal_replayed.items())
                    lines += [
                        f"appendfsync:{st['policy']}",
                        f"aof_last_seq:{st['last_seq']}",
                        f"aof_durable_seq:{st['durable_seq']}",
                        f"aof_pending_records:{st['lag_ops']}",
                        f"aof_segments:{st['segments']}",
                        f"aof_bytes_written:{st['bytes_written']}",
                        f"aof_records_written:{st['records_written']}",
                        f"aof_fsyncs:{st['fsyncs']}",
                        f"aof_fsync_ewma_us:{st['fsync_ewma_us']:g}",
                        f"aof_broken:{1 if st['broken'] else 0}",
                        f"aof_replayed_records:{int(replayed)}",
                    ]
            elif s == "replication":
                # Role + offsets on both ends: a primary lists its
                # replicas' acked offsets (the WAIT fence's inputs), a
                # replica its applied offset, link state and lag (the
                # staleness bound's input).  Redis vocabulary where one
                # exists.
                link = self.replica_link
                lines += [
                    "# Replication",
                    "role:%s" % ("slave" if link is not None else "master"),
                ]
                if link is not None:
                    lines += [
                        f"master_host:{link.master_host}",
                        f"master_port:{link.master_port}",
                        "master_link_status:%s" % (
                            "up" if link.link_up else "down"
                        ),
                        f"master_replid:{link.replid or '-'}",
                        f"slave_repl_offset:{link.applied}",
                        f"master_repl_offset:{link.master_offset}",
                        f"slave_lag_ops:{link.lag_ops()}",
                        "slave_read_only:1",
                        f"slave_full_resyncs:{link.full_resyncs}",
                        f"slave_partial_resyncs:{link.partial_resyncs}",
                        "connected_slaves:0",
                    ]
                else:
                    hub = self._repl_hub()
                    rows = hub.replica_rows() if hub is not None else []
                    lines.append(f"connected_slaves:{len(rows)}")
                    head = self._repl_offset()
                    for i, (rid, addr, offset, age_s) in enumerate(rows):
                        ip, _, rport = (addr or ":0").rpartition(":")
                        lines.append(
                            f"slave{i}:ip={ip},port={rport},"
                            f"state=online,offset={offset},"
                            f"lag={age_s:.3f},id={rid}"
                        )
                    lines += [
                        "master_replid:%s" % (
                            hub.repl_id if hub is not None else "-"
                        ),
                        f"master_repl_offset:{head}",
                        "repl_backlog_active:%d" % (
                            0 if hub is None else 1
                        ),
                        "repl_full_resyncs:%d" % (
                            0 if hub is None else hub.fullresyncs
                        ),
                        "repl_partial_resyncs:%d" % (
                            0 if hub is None else hub.partial_resyncs
                        ),
                    ]
            elif s == "nearcache":
                # Sketch near cache: the epoch-guarded host
                # read tier.  Section absent on the host engine (no tier
                # to report — honesty over empty zeros).
                nc = self._nearcache()
                if nc is not None:
                    st = nc.stats()
                    lines += [
                        "# Nearcache",
                        f"nearcache_enabled:{1 if st['enabled'] else 0}",
                        f"nearcache_hits:{st['hits']}",
                        f"nearcache_misses:{st['misses']}",
                        f"nearcache_hit_rate:{st['hit_rate']}",
                        f"nearcache_bytes:{st['bytes']}",
                        f"nearcache_max_bytes:{st['max_bytes']}",
                        f"nearcache_entries:{st['entries']}",
                        f"nearcache_evictions:{st['evictions']}",
                        f"nearcache_tenants:{st['tenants']}",
                        f"nearcache_tenant_quota_bytes:"
                        f"{st['tenant_quota_bytes']}",
                        f"nearcache_max_batch:{st['max_batch']}",
                    ]
            elif s == "frontdoor" and obs is not None:
                # Front-door vectorization: fusion + response-
                # cache effectiveness of the pipelined command stream.
                def _tot(fam):
                    return sum(int(c.value) for _, c in fam.items())

                fused = _tot(obs.resp_fused_cmds)
                total = sum(
                    int(c.value) for _, c in obs.resp_commands.items()
                )
                rch = _tot(obs.resp_cache_hits)
                rcm = _tot(obs.resp_cache_misses)
                lines += [
                    "# Frontdoor",
                    f"frontdoor_vectorize:{1 if self.vectorize else 0}",
                    f"frontdoor_fused_cmds:{fused}",
                    f"frontdoor_fused_ops:{_tot(obs.resp_fused_ops)}",
                    f"frontdoor_fused_runs:{_tot(obs.resp_fused_runs)}",
                    f"frontdoor_fusion_ratio:"
                    f"{round(fused / total, 4) if total else 0.0}",
                    f"frontdoor_response_cache_hits:{rch}",
                    f"frontdoor_response_cache_misses:{rcm}",
                    f"frontdoor_response_cache_hit_rate:"
                    f"{round(rch / (rch + rcm), 4) if rch + rcm else 0.0}",
                ]
                # Reactor front door: tick cadence + the
                # cross-connection fusion the merged pass achieved.
                rx = self.reactor
                ticks = _tot(obs.reactor_ticks)
                ready = _tot(obs.reactor_ready_conns)
                lines += [
                    f"frontdoor_reactor:{1 if rx is not None else 0}",
                    f"frontdoor_reactor_threads:"
                    f"{0 if rx is None else rx.nthreads}",
                    f"frontdoor_reactor_ticks:{ticks}",
                    f"frontdoor_reactor_ready_conns_per_tick:"
                    f"{round(ready / ticks, 2) if ticks else 0.0}",
                    f"frontdoor_cross_conn_fused_ops:"
                    f"{_tot(obs.cross_conn_fused_ops)}",
                ]
                lines += [
                    "frontdoor_native_tick:"
                    f"{1 if rx is not None and rx.native_tick else 0}",
                ]
            elif s == "overload" and obs is not None:
                # Overload control plane: deadlines, admission
                # control, tenant quotas, slow-client limits — the
                # operator's one-stop view of what is being shed and why
                # (docs/robustness.md explains each line).
                def _fam_tot(fam):
                    return sum(int(c.value) for _, c in fam.items())

                eng = getattr(self._client, "_engine", None)
                c = getattr(eng, "coalescer", None)
                gov = getattr(eng, "governor", None)
                shed_by = {
                    lv[0]: int(cv.value)
                    for lv, cv in obs.shed_ops.items()
                }
                shed_detail = ",".join(
                    f"{k}={v}" for k, v in sorted(shed_by.items())
                )
                lines += [
                    "# Overload",
                    f"overload_op_deadline_ms:{self.op_deadline_ms}",
                    f"overload_admission_watermark:"
                    f"{self.admission_watermark:g}",
                    f"overload_pressure:{round(self._pressure(), 4)}",
                    f"overload_est_wait_us:"
                    f"{0 if c is None else round(c.last_est_wait_s * 1e6)}",
                    f"overload_fetch_timeout_ms:"
                    f"{0 if c is None else int(c.fetch_timeout_s * 1000)}",
                    f"overload_shed_ops:{sum(shed_by.values())}",
                    f"overload_shed_by_reason:{shed_detail}",
                    f"overload_deadline_exceeded:"
                    f"{_fam_tot(obs.deadline_exceeded)}",
                    f"overload_ingress_shed_commands:{self._ingress_shed}",
                    f"overload_tenant_throttled:"
                    f"{_fam_tot(obs.tenant_throttled)}",
                    f"overload_tenant_rate_limit:"
                    f"{0 if gov is None else gov.rate_limit:g}",
                    f"overload_tenant_burst_ops:"
                    f"{0 if gov is None else gov._burst_cfg:g}",
                    f"overload_tenant_max_inflight:"
                    f"{0 if gov is None else gov.max_inflight}",
                    f"overload_fetch_timeouts:"
                    f"{_fam_tot(obs.fetch_timeouts)}",
                    f"overload_slow_client_disconnects:"
                    f"{self._slow_client_kills}",
                    f"overload_output_buffer_limit:"
                    f"{self.output_buffer_limit}",
                    f"overload_output_buffer_soft_seconds:"
                    f"{self.output_buffer_soft_seconds:g}",
                ]
            elif s == "keyspace":
                n = self._client.get_keys().count()
                lines += ["# Keyspace", f"db0:keys={n},expires=0,avg_ttl=0"]
        return _encode_bulk("\r\n".join(lines) + "\r\n")

    def _cmdctx_CLIENT(self, args, ctx: _ConnCtx):
        sub = args[0].decode().upper() if args else ""
        if sub == "SETNAME":
            ctx.client_name = self._s(args[1])
            return _encode_simple("OK")
        if sub == "GETNAME":
            return _encode_bulk(ctx.client_name)
        if sub == "ID":
            return _encode_int(id(ctx) & 0x7FFFFFFF)
        if sub == "SETINFO":
            # redis-py 5.x sends CLIENT SETINFO lib-name/lib-ver on every
            # connect; acknowledge (the metadata has no server-side use).
            return _encode_simple("OK")
        if sub == "INFO":
            name = ctx.client_name or ""
            return _encode_bulk(
                f"id={id(ctx) & 0x7FFFFFFF} name={name} "
                f"resp={ctx.proto}".encode()
            )
        if sub == "NO-EVICT" or sub == "NO-TOUCH":
            return _encode_simple("OK")
        if sub == "DEADLINE":
            # Overload control plane: per-connection override
            # of the server's op_deadline_ms.  CLIENT DEADLINE <ms> sets
            # it, 0 disables deadlines for this connection, a negative
            # value reverts to the server default; with no argument the
            # current setting is returned.
            if len(args) == 1:
                cur = ctx.op_deadline_ms
                return _encode_bulk(
                    b"default" if cur is None else str(cur).encode()
                )
            try:
                v = int(args[1])
            except ValueError:
                raise RespError("value is not an integer or out of range")
            ctx.op_deadline_ms = None if v < 0 else v
            return _encode_simple("OK")
        raise RespError(f"unsupported CLIENT subcommand {sub}")

    def _cmd_COMMAND(self, args):
        return _encode_array([])  # stock-client handshake stub


    # TOPK.* (RedisBloom Top-K shape) over the CMS heavy-hitter engine:
    # the candidate-table + device re-estimation design stands in for
    # RedisBloom's HeavyKeeper — same API, same role (BASELINE config 5).

    def _cms(self, key: bytes):
        return self._client.get_count_min_sketch(self._s(key))

    def _cmd_TOPK_RESERVE(self, args):
        k = int(args[1])
        width = int(args[2]) if len(args) > 2 else max(1 << 10, 8 * k)
        depth = int(args[3]) if len(args) > 3 else 4
        # args[4] (decay) accepted, meaningless for exact re-estimation.
        c = self._cms(args[0])
        if not c.try_init(depth, width, track_top_k=k):
            raise RespError("TopK: key already exists")
        return _encode_simple("OK")

    def _cmd_TOPK_ADD(self, args):
        c = self._cms(args[0])
        for item in args[1:]:
            c.add(item)
        # RedisBloom returns the dropped item per slot; exact re-
        # estimation never drops — nil per added item.
        return _encode_array([None] * (len(args) - 1))

    def _cmd_TOPK_INCRBY(self, args):
        c = self._cms(args[0])
        for i in range(1, len(args), 2):
            c.add(args[i], int(args[i + 1]))
        return _encode_array([None] * ((len(args) - 1) // 2))

    def _cmd_TOPK_QUERY(self, args):
        c = self._cms(args[0])
        top = {m for m, _ in c.top_k()}
        return _encode_array([int(item in top) for item in args[1:]])

    def _cmd_TOPK_COUNT(self, args):
        c = self._cms(args[0])
        return _encode_array([int(c.estimate(item)) for item in args[1:]])

    def _cmd_TOPK_LIST(self, args):
        c = self._cms(args[0])
        withcount = any(a.upper() == b"WITHCOUNT" for a in args[1:])
        out = []
        for member, count in c.top_k():
            out.append(member)
            if withcount:
                out.append(int(count))
        return _encode_array(out)

    def _cmd_TOPK_INFO(self, args):
        c = self._cms(args[0])
        k = self._client._engine.topk.track(self._s(args[0]))
        return _encode_array(
            [b"k", int(k), b"width", int(c.get_width()), b"depth",
             int(c.get_depth()), b"decay", b"1"]
        )

    # keyspace type / dump / restore (→ RKeys#getType + RObject#dump/
    # restore riding Redis TYPE / DUMP / RESTORE)

    # Grid KIND -> the type name Redis reports.  Lock/semaphore/counter
    # objects live in plain string keys upstream; geo is a zset.
    _TYPE_NAMES = {
        "bucket": "string", "binarystream": "string",
        "atomiclong": "string", "atomicdouble": "string",
        "longadder": "string", "doubleadder": "string",
        "idgenerator": "string", "lock": "string", "spinlock": "string",
        "fencedlock": "string", "fairlock": "string", "rwlock": "string",
        "semaphore": "string", "xsemaphore": "string",
        "countdownlatch": "string",
        "list": "list", "queue": "list", "delayedqueue": "list",
        "priorityqueue": "list", "ringbuffer": "list",
        "map": "hash", "mapcache": "hash",
        "listmultimap": "hash", "setmultimap": "hash",
        "listmultimapcache": "hash", "setmultimapcache": "hash",
        "set": "set", "setcache": "set",
        "zset": "zset", "sortedset": "zset", "lexset": "zset",
        "geo": "zset", "timeseries": "zset",
        "stream": "stream",
        # sketch kinds (RedisBloom reports module types; HLL/bitmaps are
        # strings in Redis)
        "bloom": "MBbloom--", "cms": "CMSk-TYPE",
        "hll": "string", "bitset": "string",
    }

    def _kind_of(self, name: str) -> Optional[str]:
        eng = self._client._engine
        if eng.exists(name):
            e = eng.registry.lookup(name)
            if e is not None:
                return e.kind
        e = self._client._grid.get_entry(name)
        return None if e is None else e.kind

    def _cmd_TYPE(self, args):
        kind = self._kind_of(self._s(args[0]))
        if kind is None:
            return _encode_simple("none")
        return _encode_simple(self._TYPE_NAMES.get(kind, kind))

    def _cmd_DUMP(self, args):
        """Sketch objects dump their data-only wire blobs (durability
        format); string keys a tagged raw-bytes payload.  Container grid
        kinds are NOT dumpable over RESP: their Python dump() is
        pickle-based, which must never meet an untrusted socket."""
        return _encode_bulk(self._dump_payload(self._s(args[0])))

    def _dump_payload(self, name: str) -> Optional[bytes]:
        """The DUMP blob for one key, or None when absent — shared by
        _cmd_DUMP and the cluster migration pump (cluster/door.py ships
        exactly what DUMP would)."""
        blob = self._client._engine.dump(name)
        if blob is not None:
            return blob
        e = self._client._grid.get_entry(name)
        if e is None:
            return None
        if e.kind == "bucket":
            v = e.value
            if isinstance(v, str):
                v = v.encode()
            return b"RTPS\x00" + v
        raise RespError(f"DUMP unsupported for type {e.kind} over RESP")

    def _cmd_RESTORE(self, args):
        name, ttl_ms, payload = self._s(args[0]), int(args[1]), args[2]
        replace = any(a.upper() == b"REPLACE" for a in args[3:])
        # BUSYKEY/REPLACE semantics span BOTH stores (one logical
        # keyspace): Redis's RESTORE REPLACE deletes the old key whatever
        # its type, so a sketch blob may replace a grid string and vice
        # versa — the per-store foreign-key guards must see a free name.
        if self._exists_any(name):
            if not replace:
                raise RespError("BUSYKEY Target key name already exists.")
            self._client.get_keys().delete(name)
        if payload.startswith(b"RTPS\x00"):
            from redisson_tpu_torch.grid.buckets import Bucket

            self._raw(Bucket(name, self._client)).set(payload[5:])
        else:
            try:
                self._client._engine.restore(name, payload)
            except ValueError as e:
                if "BUSYKEY" in str(e):  # raced with a concurrent creator
                    raise RespError("BUSYKEY Target key name already exists.")
                raise
        if ttl_ms > 0:
            self._client.get_keys().expire(name, ttl_ms / 1000.0)
        return _encode_simple("OK")

    def _exists_any(self, name: str) -> bool:
        return self._client._grid.exists(name) or self._client._engine.exists(
            name
        )

    # bitmaps -> BitSet

    def _cmd_SETBIT(self, args):
        bs = self._client.get_bit_set(self._s(args[0]))
        prev = bs.set(int(args[1]), bool(int(args[2])))
        return _encode_int(int(prev))

    def _cmd_GETBIT(self, args):
        bs = self._client.get_bit_set(self._s(args[0]))
        return _encode_int(int(bs.get(int(args[1]))))

    def _cmd_BITCOUNT(self, args):
        if len(args) > 1:
            # Range form unsupported — error, never silently-wrong data.
            raise RespError("BITCOUNT with ranges is not supported")
        return _encode_int(self._client.get_bit_set(self._s(args[0])).cardinality())

    def _cmd_BITPOS(self, args):
        if len(args) > 2:
            raise RespError("BITPOS with ranges is not supported")
        bs = self._client.get_bit_set(self._s(args[0]))
        target = int(args[1])
        return _encode_int(
            bs.first_set_bit() if target else bs.first_clear_bit()
        )

    # HLL

    def _cmd_PFADD(self, args):
        h = self._client.get_hyper_log_log(self._s(args[0]))
        return _encode_int(int(h.add_all([a for a in args[1:]])))

    def _cmd_PFCOUNT(self, args):
        h = self._client.get_hyper_log_log(self._s(args[0]))
        if len(args) > 1:
            return _encode_int(h.count_with(*[self._s(a) for a in args[1:]]))
        return _encode_int(h.count())

    def _cmd_PFMERGE(self, args):
        h = self._client.get_hyper_log_log(self._s(args[0]))
        h.merge_with(*[self._s(a) for a in args[1:]])
        return _encode_simple("OK")

    # Bloom (RedisBloom command shape)

    def _cmd_BF_RESERVE(self, args):
        bf = self._client.get_bloom_filter(self._s(args[0]))
        created = bf.try_init(int(args[2]), float(args[1]))
        if not created:
            raise RespError("item exists")
        return _encode_simple("OK")

    def _cmd_BF_ADD(self, args):
        bf = self._client.get_bloom_filter(self._s(args[0]))
        return _encode_int(int(bf.add(args[1])))

    def _cmd_BF_MADD(self, args):
        bf = self._client.get_bloom_filter(self._s(args[0]))
        newly = bf.add_all_async([a for a in args[1:]]).result()
        return _encode_array([int(v) for v in newly])

    def _cmd_BF_EXISTS(self, args):
        bf = self._client.get_bloom_filter(self._s(args[0]))
        return _encode_int(int(bf.contains(args[1])))

    def _cmd_BF_MEXISTS(self, args):
        bf = self._client.get_bloom_filter(self._s(args[0]))
        hits = bf.contains_each([a for a in args[1:]])
        return _encode_array([int(v) for v in hits])

    # CMS (RedisBloom command shape)

    def _cmd_CMS_INITBYDIM(self, args):
        cms = self._client.get_count_min_sketch(self._s(args[0]))
        cms.try_init(int(args[2]), int(args[1]))
        return _encode_simple("OK")

    def _cmd_CMS_INCRBY(self, args):
        cms = self._client.get_count_min_sketch(self._s(args[0]))
        out = []
        for i in range(1, len(args), 2):
            out.append(cms.add(args[i], int(args[i + 1])))
        return _encode_array(out)

    def _cmd_CMS_QUERY(self, args):
        cms = self._client.get_count_min_sketch(self._s(args[0]))
        return _encode_array(
            [int(v) for v in cms.estimate_all([a for a in args[1:]])]
        )

    def _cmd_CMS_MERGE(self, args):
        """CMS.MERGE dest numKeys src [src ...] — RedisBloom OVERWRITE
        semantics: dest becomes the sum of the sources (dest's prior
        counts survive only if dest is itself listed as a source).
        Weights unsupported — error, never silently-wrong data."""
        n = int(args[1])
        dest = self._s(args[0])
        srcs = [self._s(a) for a in args[2 : 2 + n]]
        if len(args) > 2 + n:
            raise RespError("CMS.MERGE WEIGHTS is not supported")
        cms = self._client.get_count_min_sketch(dest)
        if dest not in srcs:
            # Overwrite: zero the counters in place (registry entry and
            # top-K config survive; no delete→reinit window where
            # concurrent CMS.QUERY would see 'not initialized').
            self._client._engine.cms_reset(dest)
        others = [s for s in srcs if s != dest]
        if others:
            cms.merge(*others)
        return _encode_simple("OK")

    def _cmd_CMS_INFO(self, args):
        cms = self._client.get_count_min_sketch(self._s(args[0]))
        return _encode_array(
            [
                "width", cms.get_width(),
                "depth", cms.get_depth(),
                "count", cms.total_count(),
            ]
        )

    def _cmd_BF_INFO(self, args):
        bf = self._client.get_bloom_filter(self._s(args[0]))
        return _encode_array(
            [
                "Capacity", bf.get_expected_insertions(),
                "Size", (bf.get_size() + 7) // 8,  # bits → bytes
                "Number of filters", 1,
                "Number of items inserted", bf.count(),
                "Expansion rate", None,  # non-scaling filter
            ]
        )

    # lists

    def _list(self, key: bytes):
        # Redis lists ARE deques (LPUSH/RPOP both ends).
        from redisson_tpu_torch.grid.queues import Deque

        return self._raw(Deque(self._s(key), self._client))

    def _cmd_RPUSH(self, args):
        lst = self._list(args[0])
        for v in args[1:]:
            lst.offer(v)
        return _encode_int(lst.size())

    def _cmd_LPUSH(self, args):
        lst = self._list(args[0])
        for v in args[1:]:
            lst.add_first(v)
        return _encode_int(lst.size())

    def _cmd_LPUSHX(self, args):
        with self._client._grid.lock:
            if not self._client._grid.exists(self._s(args[0])):
                return _encode_int(0)
            return self._cmd_LPUSH(args)

    def _cmd_RPUSHX(self, args):
        with self._client._grid.lock:
            if not self._client._grid.exists(self._s(args[0])):
                return _encode_int(0)
            return self._cmd_RPUSH(args)

    def _cmd_LPOP(self, args):
        return _encode_bulk(self._list(args[0]).poll_first())

    def _cmd_RPOP(self, args):
        return _encode_bulk(self._list(args[0]).poll_last())

    def _bpop(self, args, first: bool, nonblocking: bool = False) -> bytes:
        """BLPOP/BRPOP: condvar-parked on the grid store (no poll pump) —
        the store's offer() notifies the same condition BlockingQueue
        uses.  Multi-key form checks keys in argument order each wakeup,
        Redis-style.  ``nonblocking``: inside MULTI/EXEC a blocking
        command returns nil immediately (Redis transaction semantics)."""
        import time as _time

        if len(args) < 2:
            raise RespError("wrong number of arguments for 'blpop'")
        *keys, timeout = args
        t = float(timeout)
        qs = [(self._s(k), self._list(k)) for k in keys]
        store = qs[0][1]._store
        deadline = None if t == 0 else _time.monotonic() + t
        with store.cond:
            while True:
                for name, q in qs:
                    v = q.poll_first() if first else q.poll_last()
                    if v is not None:
                        return b"*2\r\n" + _encode_bulk(name) + _encode_bulk(v)
                if nonblocking:
                    return b"*-1\r\n"  # in EXEC: never block
                if deadline is None:
                    store.cond.wait(timeout=1.0)
                else:
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        return b"*-1\r\n"  # null array: timed out
                    store.cond.wait(timeout=remaining)

    def _cmdctx_BLPOP(self, args, ctx: _ConnCtx):
        return self._bpop(args, first=True, nonblocking=ctx.in_exec)

    def _cmdctx_BRPOP(self, args, ctx: _ConnCtx):
        return self._bpop(args, first=False, nonblocking=ctx.in_exec)

    def _cmd_LLEN(self, args):
        return _encode_int(self._list(args[0]).size())

    def _listidx(self, key: bytes):
        # Index-addressed view of the same "list" store entry (List and
        # Deque share KIND, → RList over one Redis list key).
        from redisson_tpu_torch.grid.collections import List_

        return self._raw(List_(self._s(key), self._client))

    def _cmd_LRANGE(self, args):
        lst = self._listidx(args[0])
        start, end = int(args[1]), int(args[2])
        n = lst.size()
        if start < 0:
            start = max(0, n + start)
        end = n + end if end < 0 else end
        if start > end or start >= n:
            return _encode_array([])
        return _encode_array(lst.sub_list(start, min(end, n - 1) + 1))

    def _cmd_LINDEX(self, args):
        lst = self._listidx(args[0])
        i = int(args[1])
        n = lst.size()
        if i < 0:
            i += n
        if not 0 <= i < n:
            return _encode_bulk(None)
        return _encode_bulk(lst.get(i))

    def _cmd_LSET(self, args):
        lst = self._listidx(args[0])
        i = int(args[1])
        n = lst.size()
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise RespError("index out of range")
        lst.set(i, args[2])
        return _encode_simple("OK")

    def _cmd_LREM(self, args):
        lst = self._listidx(args[0])
        count = int(args[1])
        with self._client._grid.lock:  # atomic scan+remove
            vals = lst.sub_list(0, lst.size())
            idxs = [i for i, v in enumerate(vals) if v == args[2]]
            if count > 0:
                idxs = idxs[:count]  # head-first
            elif count < 0:
                idxs = idxs[count:]  # tail-first, Redis count<0
            for i in reversed(idxs):
                lst.remove_at(i)
        return _encode_int(len(idxs))

    def _cmd_LTRIM(self, args):
        lst = self._listidx(args[0])
        start, end = int(args[1]), int(args[2])
        n = lst.size()
        if start < 0:
            start = max(0, n + start)
        end = n + end if end < 0 else min(end, n - 1)
        if start > end:
            lst.trim(1, 0)  # keep-nothing: Redis empties the list
        else:
            lst.trim(start, end)  # grid trim is [from, to] INCLUSIVE
        return _encode_simple("OK")

    def _cmd_RPOPLPUSH(self, args):
        v = self._list(args[0]).poll_last_and_offer_first_to(
            self._s(args[1])
        )
        return _encode_bulk(v)

    # hashes

    def _map(self, key: bytes):
        from redisson_tpu_torch.grid.maps import Map

        m = self._raw(Map(self._s(key), self._client))
        m._enc_key = m._enc
        m._dec_key = m._dec
        return m

    def _cmd_HSET(self, args):
        m = self._map(args[0])
        n = 0
        for i in range(1, len(args), 2):
            if m.fast_put(args[i], args[i + 1]):
                n += 1
        return _encode_int(n)

    def _cmd_HGET(self, args):
        return _encode_bulk(self._map(args[0]).get(args[1]))

    def _cmd_HDEL(self, args):
        return _encode_int(self._map(args[0]).fast_remove(*args[1:]))

    def _cmd_HLEN(self, args):
        return _encode_int(self._map(args[0]).size())

    def _cmd_HGETALL(self, args):
        flat = []
        for k, v in self._map(args[0]).read_all_map().items():
            flat.extend([k, v])
        return _encode_array(flat)

    def _cmd_HMGET(self, args):
        m = self._map(args[0])
        return _encode_array([m.get(f) for f in args[1:]])

    def _cmd_HKEYS(self, args):
        return _encode_array(self._map(args[0]).key_set())

    def _cmd_HVALS(self, args):
        return _encode_array(self._map(args[0]).values())

    def _cmd_HEXISTS(self, args):
        return _encode_int(int(self._map(args[0]).contains_key(args[1])))

    def _cmd_HSETNX(self, args):
        m = self._map(args[0])
        prev = m.put_if_absent(args[1], args[2])
        return _encode_int(int(prev is None))

    def _cmd_HINCRBY(self, args):
        m = self._map(args[0])
        # Stored values are raw bytes over RESP: interpret as integer.
        with self._client._grid.lock:
            cur = m.get(args[1])
            new = (int(cur) if cur is not None else 0) + int(args[2])
            m.fast_put(args[1], str(new).encode())
        return _encode_int(new)

    # sets

    def _set(self, key: bytes):
        from redisson_tpu_torch.grid.collections import Set_

        return self._raw(Set_(self._s(key), self._client))

    def _cmd_SADD(self, args):
        s = self._set(args[0])
        return _encode_int(sum(int(s.add(v)) for v in args[1:]))

    def _cmd_SREM(self, args):
        s = self._set(args[0])
        return _encode_int(sum(int(s.remove(v)) for v in args[1:]))

    def _cmd_SISMEMBER(self, args):
        return _encode_int(int(self._set(args[0]).contains(args[1])))

    def _cmd_SCARD(self, args):
        return _encode_int(self._set(args[0]).size())

    def _cmd_SMEMBERS(self, args):
        return _encode_array(self._set(args[0]).read_all())

    def _cmd_SMISMEMBER(self, args):
        s = self._set(args[0])
        return _encode_array([int(s.contains(v)) for v in args[1:]])

    def _cmd_SPOP(self, args):
        s = self._set(args[0])
        if len(args) > 1:
            count = int(args[1])
            if count < 0:
                raise RespError("value is out of range, must be positive")
            return _encode_array(s.remove_random(min(count, s.size())))
        out = s.remove_random(1)
        return _encode_bulk(out[0] if out else None)

    def _cmd_SRANDMEMBER(self, args):
        s = self._set(args[0])
        if len(args) > 1:
            count = int(args[1])
            if count < 0:
                # Redis: |count| members, duplicates allowed.
                import random as _random

                vals = s.read_all()
                if not vals:
                    return _encode_array([])
                return _encode_array(_random.choices(vals, k=-count))
            return _encode_array(s.random(min(count, s.size())))
        out = s.random(1)
        return _encode_bulk(out[0] if out else None)

    def _cmd_SMOVE(self, args):
        # Raw-bytes SMOVE: the grid's move() resolves the destination
        # through the client codec; RESP values are raw, so move by hand
        # under the store lock.
        src, dst = self._set(args[0]), self._set(args[1])
        with self._client._grid.lock:
            self._client._grid.get_entry(self._s(args[1]), "set")
            if not src.remove(args[2]):
                return _encode_int(0)
            dst.add(args[2])
        return _encode_int(1)

    # SINTER/SUNION/SDIFF combine via raw per-set reads: the grid's
    # read_intersection/read_union resolve other sets through the
    # CLIENT's codec, but every RESP-stored value is raw bytes.

    def _cmd_SINTER(self, args):
        sets = [set(self._set(a).read_all()) for a in args]
        return _encode_array(sorted(set.intersection(*sets)))

    def _cmd_SUNION(self, args):
        out: set = set()
        for a in args:
            out.update(self._set(a).read_all())
        return _encode_array(sorted(out))

    def _cmd_SDIFF(self, args):
        first = self._set(args[0])
        out = first.read_all()
        others = set()
        for a in args[1:]:
            others.update(self._set(a).read_all())
        return _encode_array([v for v in out if v not in others])

    def _store_set(self, dest: bytes, members) -> bytes:
        with self._client._grid.lock:
            if not members:
                # Redis deletes the destination on an empty result.
                self._client._grid.delete(self._s(dest))
            else:
                self._client._grid.put_entry(
                    self._s(dest), "set", {vb: None for vb in members}
                )
        return _encode_int(len(members))

    def _cmd_SINTERSTORE(self, args):
        sets = [set(self._set(a).read_all()) for a in args[1:]]
        return self._store_set(args[0], sorted(set.intersection(*sets)))

    def _cmd_SUNIONSTORE(self, args):
        out: set = set()
        for a in args[1:]:
            out.update(self._set(a).read_all())
        return self._store_set(args[0], sorted(out))

    def _cmd_SDIFFSTORE(self, args):
        first = self._set(args[1]).read_all()
        others: set = set()
        for a in args[2:]:
            others.update(self._set(a).read_all())
        return self._store_set(args[0], [v for v in first if v not in others])

    # sorted sets

    def _zset(self, key: bytes):
        from redisson_tpu_torch.grid.collections import ScoredSortedSet

        return self._raw(ScoredSortedSet(self._s(key), self._client))

    def _cmd_ZADD(self, args):
        z = self._zset(args[0])
        n = 0
        for i in range(1, len(args), 2):
            n += int(z.add(float(args[i]), args[i + 1]))
        return _encode_int(n)

    def _cmd_ZSCORE(self, args):
        score = self._zset(args[0]).get_score(args[1])
        return _encode_bulk(None if score is None else _fmt_score(score))

    def _cmd_ZRANGE(self, args):
        z = self._zset(args[0])
        withscores = len(args) > 3 and args[3].decode().upper() == "WITHSCORES"
        if not withscores:
            return _encode_array(z.value_range(int(args[1]), int(args[2])))
        flat = []
        for member, score in z.entry_range(int(args[1]), int(args[2])):
            flat.extend([member, _fmt_score(score)])
        return _encode_array(flat)

    def _cmd_ZCARD(self, args):
        return _encode_int(self._zset(args[0]).size())

    def _cmd_ZREM(self, args):
        z = self._zset(args[0])
        return _encode_int(sum(int(z.remove(m)) for m in args[1:]))

    def _cmd_ZINCRBY(self, args):
        new = self._zset(args[0]).add_score(args[2], float(args[1]))
        return _encode_bulk(_fmt_score(new))

    def _cmd_ZRANK(self, args):
        r = self._zset(args[0]).rank(args[1])
        return b"$-1\r\n" if r is None else _encode_int(r)

    @staticmethod
    def _score_bound(raw: bytes):
        """Redis score-bound syntax: '(x' exclusive, -inf/+inf."""
        if raw.startswith(b"("):
            return float(raw[1:]), False
        return float(raw), True

    def _score_filtered(self, z, lo_raw: bytes, hi_raw: bytes):
        lo, lo_inc = self._score_bound(lo_raw)
        hi, hi_inc = self._score_bound(hi_raw)
        out = []
        for m in z.value_range_by_score(lo, hi):
            s = z.get_score(m)
            if (s > lo or (lo_inc and s == lo)) and (
                s < hi or (hi_inc and s == hi)
            ):
                out.append((m, s))
        return out

    def _cmd_ZCOUNT(self, args):
        return _encode_int(
            len(self._score_filtered(self._zset(args[0]), args[1], args[2]))
        )

    def _cmd_ZRANGEBYSCORE(self, args):
        z = self._zset(args[0])
        withscores = False
        offset, count = 0, None
        i = 3
        while i < len(args):
            opt = args[i].upper()
            if opt == b"WITHSCORES":
                withscores = True
                i += 1
            elif opt == b"LIMIT":
                offset, count = int(args[i + 1]), int(args[i + 2])
                i += 3
            else:
                raise RespError(f"syntax error near {args[i].decode()!r}")
        entries = self._score_filtered(z, args[1], args[2])
        if count is not None:
            entries = entries[offset : offset + count if count >= 0 else None]
        elif offset:
            entries = entries[offset:]
        if not withscores:
            return _encode_array([m for m, _ in entries])
        flat = []
        for m, s in entries:
            flat.extend([m, _fmt_score(s)])
        return _encode_array(flat)

    def _zpop(self, args, first: bool):
        z = self._zset(args[0])
        count = int(args[1]) if len(args) > 1 else 1
        flat = []
        with self._client._grid.lock:  # atomic peek+remove per entry
            for _ in range(count):
                entries = (
                    z.entry_range(0, 0) if first else z.entry_range(-1, -1)
                )
                if not entries:
                    break
                member, score = entries[0]
                z.remove(member)
                flat.extend([member, _fmt_score(score)])
        return _encode_array(flat)

    def _cmd_ZPOPMIN(self, args):
        return self._zpop(args, True)

    def _cmd_ZPOPMAX(self, args):
        return self._zpop(args, False)

    def _cmd_ZREVRANGE(self, args):
        z = self._zset(args[0])
        withscores = any(a.upper() == b"WITHSCORES" for a in args[3:])
        start, end = int(args[1]), int(args[2])
        # rev-range indexes count from the HIGHEST score; n derives from
        # the ONE snapshot (a second size() call could race a mutation).
        entries = list(reversed(z.entry_range(0, -1)))
        n = len(entries)
        if start < 0:
            start = max(0, n + start)
        if end < 0:
            end = n + end
            if end < 0:
                return _encode_array([])  # beyond-left end: empty, Redis
        entries = entries[start : end + 1]
        if not withscores:
            return _encode_array([m for m, _ in entries])
        flat = []
        for m, sc in entries:
            flat.extend([m, _fmt_score(sc)])
        return _encode_array(flat)

    def _cmd_ZREVRANK(self, args):
        z = self._zset(args[0])
        r = z.rank(args[1])
        if r is None:
            return b"$-1\r\n"
        return _encode_int(z.size() - 1 - r)

    def _cmd_ZREMRANGEBYSCORE(self, args):
        z = self._zset(args[0])
        with self._client._grid.lock:  # atomic filter+remove (RLock)
            members = [
                m for m, _ in self._score_filtered(z, args[1], args[2])
            ]
            for m in members:
                z.remove(m)
        return _encode_int(len(members))

    # protocol negotiation (→ RESP3's HELLO; the reference speaks
    # RESP2/RESP3 through Netty — SURVEY.md §2.4 comm row)

    def _check_password(self, username: Optional[bytes], password: bytes) -> None:
        """Constant-time password check; only the 'default' user exists
        (the single-password requirepass model, like redis-server
        without ACLs)."""
        import hmac

        if self._requirepass is None:
            raise RespError(
                "Client sent AUTH, but no password is set. Did you mean "
                "AUTH <username> <password>?"
            )
        if username is not None and username != b"default":
            raise RespError(
                "WRONGPASS invalid username-password pair or user is "
                "disabled."
            )
        if not hmac.compare_digest(password, self._requirepass.encode()):
            raise RespError(
                "WRONGPASS invalid username-password pair or user is "
                "disabled."
            )

    def _cmdctx_AUTH(self, args, ctx: _ConnCtx):
        if len(args) == 1:
            self._check_password(None, args[0])
        elif len(args) == 2:
            self._check_password(args[0], args[1])
        else:
            raise RespError("wrong number of arguments for 'auth' command")
        ctx.authed = True
        return _encode_simple("OK")

    def _cmdctx_HELLO(self, args, ctx: _ConnCtx):
        # Validate EVERYTHING before mutating ctx: a failed HELLO must
        # leave the connection on its current protocol (a half-applied
        # upgrade would desync the client — real Redis switches only on
        # success).
        ver = ctx.proto
        name = ctx.client_name
        i = 0
        if args and args[0].isdigit():
            ver = int(args[0])
            if ver not in (2, 3):
                raise RespError(
                    "NOPROTO unsupported protocol version"
                )
            i = 1
        authed = ctx.authed
        while i < len(args):
            opt = args[i].decode().upper()
            if opt == "AUTH":
                # HELLO ... AUTH <username> <password>: raises on a bad
                # pair BEFORE any ctx mutation (validate-then-commit).
                self._check_password(args[i + 1], args[i + 2])
                authed = True
                i += 3
                continue
            if opt == "SETNAME":
                name = self._s(args[i + 1])
                i += 2
                continue
            raise RespError(f"unsupported HELLO option {opt}")
        if not authed:
            # HELLO without credentials on a locked server: refused like
            # every other pre-auth command (Redis behavior for HELLO is
            # to answer, but answering leaks server metadata; AUTH-first
            # is the safe strictening and stock clients send AUTH here).
            raise RespError("NOAUTH HELLO must include AUTH when "
                            "requirepass is set.")
        ctx.proto = ver
        ctx.client_name = name
        ctx.authed = authed
        pairs = [
            (b"server", b"redisson-tpu"),
            (b"version", b"4.0.0"),
            (b"proto", ctx.proto),
            (b"id", 1),
            (b"mode", b"standalone"),
            (b"role",
             b"slave" if self.replica_link is not None else b"master"),
            (b"modules", []),
        ]
        if ctx.proto == 3:
            out = b"%" + str(len(pairs)).encode() + b"\r\n"
        else:
            out = b"*" + str(len(pairs) * 2).encode() + b"\r\n"
        for k, v in pairs:
            out += _encode_bulk(k)
            if isinstance(v, int):
                out += _encode_int(v)
            elif isinstance(v, list):
                out += _encode_array(v)
            else:
                out += _encode_bulk(v)
        return out

    # pub/sub (push replies — the SUBSCRIBE protocol shape; RESP3
    # connections get true push frames '>')

    @staticmethod
    def _push_hdr(ctx: _ConnCtx) -> bytes:
        return b">3\r\n" if ctx.proto == 3 else b"*3\r\n"

    def _cmd_PUBLISH(self, args):
        n = self._client._topic_bus.publish(self._s(args[0]), args[1])
        return _encode_int(n)

    def _cmdctx_SUBSCRIBE(self, args, ctx: _ConnCtx):
        if not args:
            raise RespError("wrong number of arguments for 'subscribe'")
        for raw in args:
            channel = self._s(raw)
            already = channel in ctx.subs
            # Ack FIRST, then register: a concurrent PUBLISH must not push
            # its 'message' frame ahead of this channel's 'subscribe' ack.
            ctx.send(
                self._push_hdr(ctx)
                + _encode_bulk(b"subscribe")
                + _encode_bulk(raw)
                + _encode_int(len(ctx.subs) + (0 if already else 1))
            )
            if already:
                continue

            def on_msg(ch, message, _name=raw):
                payload = (
                    message
                    if isinstance(message, bytes)
                    else str(message).encode()
                )
                ctx.send(
                    self._push_hdr(ctx)
                    + _encode_bulk(b"message")
                    + _encode_bulk(_name)
                    + _encode_bulk(payload)
                )

            ctx.subs[channel] = self._client._topic_bus.subscribe(
                channel, on_msg
            )
        return b""  # acks already pushed in order

    def _cmdctx_UNSUBSCRIBE(self, args, ctx: _ConnCtx):
        channels = [self._s(a) for a in args] or list(ctx.subs)
        if not channels:
            # Redis replies even when nothing was subscribed — an empty
            # reply would wedge the client waiting forever.
            return (
                self._push_hdr(ctx)
                + _encode_bulk(b"unsubscribe")
                + _encode_bulk(None)
                + _encode_int(0)
            )
        out = b""
        for channel in channels:
            lid = ctx.subs.pop(channel, None)
            if lid is not None:
                self._client._topic_bus.unsubscribe(channel, lid)
            out += (
                self._push_hdr(ctx)
                + _encode_bulk(b"unsubscribe")
                + _encode_bulk(channel.encode())
                + _encode_int(len(ctx.subs))
            )
        return out

    # counters — one NUMERIC key per name: Redis INCR/INCRBYFLOAT share a
    # string key, so the int and float forms here must interoperate (the
    # entry's kind converts with the operation; INCR on a non-integral
    # value errors like Redis's "not an integer").

    def _numeric_incr(self, key: bytes, delta, is_float: bool):
        grid = self._client._grid
        name = self._s(key)
        with grid.lock:
            e = grid.get_entry(name)
            if e is None:
                cur = 0
            elif e.kind == "bucket":  # Redis counters ARE string keys
                raw = e.value
                if isinstance(raw, str):
                    raw = raw.encode()
                try:
                    cur = int(raw)
                except (TypeError, ValueError):
                    try:
                        cur = float(raw)
                    except (TypeError, ValueError):
                        raise RespError(
                            "value is not a valid float"
                            if is_float
                            else "value is not an integer or out of range"
                        )
            elif e.kind in ("atomiclong", "atomicdouble"):
                cur = e.value  # pre-existing counter kinds stay readable
            else:
                raise TypeError(
                    f"object {name!r} holds a {e.kind}, not a string"
                )
            if is_float:
                new = float(cur) + float(delta)
            else:
                # Exact-int check (float(cur)==int(cur) loses precision
                # past 2**53; Redis counters span full signed 64-bit).
                if isinstance(cur, float) and not cur.is_integer():
                    raise RespError("value is not an integer or out of range")
                new = int(cur) + int(delta)
            # Stored as a plain string key: SET/GET/INCR/INCRBYFLOAT all
            # interoperate on one key, and TYPE reports "string" — EXCEPT
            # when the entry was created via the Python AtomicLong/Double
            # API: rewriting those as "bucket" would make every later
            # Python-API call on the live handle raise WRONGTYPE, so the
            # counter kind is preserved (value stays numeric, not bytes).
            ttl = e.expire_at if e is not None else None
            if e is not None and e.kind in ("atomiclong", "atomicdouble"):
                kind = e.kind
                if kind == "atomiclong" and is_float and not new.is_integer():
                    kind = "atomicdouble"  # int kind can't hold a fraction
                val = int(new) if kind == "atomiclong" else float(new)
                ne = grid.put_entry(name, kind, val)
            else:
                stored = (
                    _fmt_score(new) if is_float else str(new)
                ).encode()
                ne = grid.put_entry(name, "bucket", stored)
            ne.expire_at = ttl
            return new

    def _cmd_INCR(self, args):
        return _encode_int(self._numeric_incr(args[0], 1, False))

    def _cmd_INCRBYFLOAT(self, args):
        return _encode_bulk(
            _fmt_score(self._numeric_incr(args[0], float(args[1]), True))
        )

    def _cmd_INCRBY(self, args):
        return _encode_int(self._numeric_incr(args[0], int(args[1]), False))

    def _cmd_DECR(self, args):
        return _encode_int(self._numeric_incr(args[0], -1, False))

    # streams (→ the reference's RStream command surface over
    # grid/streams.py; reply shapes follow Redis XADD/XRANGE/XREAD/
    # XREADGROUP/XACK/XPENDING/XCLAIM/XAUTOCLAIM)

    def _stream(self, key: bytes):
        from redisson_tpu_torch.grid.streams import Stream

        s = self._raw(Stream(self._s(key), self._client))
        s._enc_key = s._enc
        s._dec_key = s._dec
        return s

    @staticmethod
    def _stream_entries_reply(entries) -> bytes:
        """[(id, {field: value})] → RESP [[id, [f1, v1, ...]], ...]."""
        out = b"*" + str(len(entries)).encode() + b"\r\n"
        for eid, fields in entries:
            flat = []
            for f, v in fields.items():
                flat.extend([f, v])
            out += b"*2\r\n" + _encode_bulk(eid) + _encode_array(flat)
        return out

    def _cmd_XADD(self, args):
        key = args[0]
        i = 1
        nomkstream = False
        maxlen = None
        while i < len(args):
            opt = args[i].decode().upper()
            if opt == "NOMKSTREAM":
                nomkstream = True
                i += 1
            elif opt == "MAXLEN":
                i += 1
                if args[i] in (b"~", b"="):  # approximate trim: exact here
                    i += 1
                maxlen = int(args[i])
                i += 1
            else:
                break
        entry_id = self._s(args[i])
        i += 1
        if (len(args) - i) % 2 != 0 or len(args) == i:
            raise RespError("wrong number of arguments for 'xadd' command")
        fields = {args[j]: args[j + 1] for j in range(i, len(args), 2)}
        try:
            new_id = self._stream(key).add(
                fields, entry_id, maxlen=maxlen, nomkstream=nomkstream
            )
        except ValueError as e:
            # Distinguish ordering violations from unparseable ids — a
            # client debugging 'notanid' must not be pointed at ordering.
            if "greater than" in str(e):
                raise RespError(
                    "The ID specified in XADD is equal or smaller than "
                    "the target stream top item"
                ) from e
            raise RespError(
                "Invalid stream ID specified as stream command argument"
            ) from e
        return _encode_bulk(None if new_id is None else new_id)

    def _cmd_XLEN(self, args):
        return _encode_int(self._stream(args[0]).size())

    def _cmd_XRANGE(self, args):
        count = None
        if len(args) >= 5 and args[3].decode().upper() == "COUNT":
            count = int(args[4])
        entries = self._stream(args[0]).range(
            self._s(args[1]), self._s(args[2]), count
        )
        return self._stream_entries_reply(entries)

    def _cmd_XREVRANGE(self, args):
        count = None
        if len(args) >= 5 and args[3].decode().upper() == "COUNT":
            count = int(args[4])
        entries = self._stream(args[0]).rev_range(
            self._s(args[1]), self._s(args[2]), count
        )
        return self._stream_entries_reply(entries)

    def _cmd_XDEL(self, args):
        return _encode_int(
            self._stream(args[0]).remove(*[self._s(a) for a in args[1:]])
        )

    def _cmd_XTRIM(self, args):
        i = 1
        if args[i].decode().upper() != "MAXLEN":
            raise RespError("syntax error")
        i += 1
        if args[i] in (b"~", b"="):
            i += 1
        return _encode_int(self._stream(args[0]).trim(int(args[i])))

    @staticmethod
    def _parse_xread_opts(args, want_group: bool):
        """Shared XREAD/XREADGROUP option walk → (group, consumer,
        count, block_s, keys, ids, noack)."""
        group = consumer = None
        count = block_s = None
        noack = False
        i = 0
        if want_group:
            if args[i].decode().upper() != "GROUP":
                raise RespError("syntax error")
            group, consumer = args[i + 1].decode(), args[i + 2].decode()
            i += 3
        while i < len(args):
            opt = args[i].decode().upper()
            if opt == "COUNT":
                count = int(args[i + 1])
                i += 2
            elif opt == "BLOCK":
                # BLOCK 0 = wait indefinitely (the Redis contract); the
                # wait loop still wakes each second, so a closed server
                # unsticks at shutdown.
                block_s = int(args[i + 1]) / 1000.0 or float("inf")
                i += 2
            elif opt == "NOACK":
                noack = True
                i += 1
            elif opt == "STREAMS":
                i += 1
                break
            else:
                raise RespError("syntax error")
        rest = args[i:]
        if not rest or len(rest) % 2 != 0:
            raise RespError(
                "Unbalanced XREAD list of streams: for each stream key "
                "an ID or '$' must be specified."
            )
        half = len(rest) // 2
        return group, consumer, count, block_s, rest[:half], rest[half:], noack

    @staticmethod
    def _xread_reply(out) -> bytes:
        if not out:
            return b"*-1\r\n"  # nil: nothing new
        reply = b"*" + str(len(out)).encode() + b"\r\n"
        for k, entries in out:
            reply += (
                b"*2\r\n" + _encode_bulk(k)
                + RespServer._stream_entries_reply(entries)
            )
        return reply

    def _cmdctx_XREAD(self, args, ctx: _ConnCtx):
        import time as _time

        _, _, count, block_s, keys, ids, _ = self._parse_xread_opts(
            args, False
        )
        if ctx.in_exec:
            block_s = None  # like Redis: no blocking inside MULTI/EXEC
        # Resolve '$' ONCE, before any waiting: a blocked read must see
        # entries added after THIS call, not chase the advancing tail.
        starts = []
        for k, sid in zip(keys, ids):
            s_ = self._s(sid)
            if s_ == "$":
                s_ = self._stream(k).last_id()
            starts.append(s_)
        deadline = (
            None if block_s is None else _time.monotonic() + block_s
        )
        grid = self._client._grid
        while True:
            out = []
            for k, start in zip(keys, starts):
                entries = self._stream(k).read(start, count)
                if entries:
                    out.append((k, entries))
            if out or deadline is None:
                return self._xread_reply(out)
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                return self._xread_reply([])
            with grid.cond:  # woken by any XADD (store-wide notify)
                grid.cond.wait(timeout=min(remaining, 1.0))

    def _cmdctx_XREADGROUP(self, args, ctx: _ConnCtx):
        import time as _time

        group, consumer, count, block_s, keys, ids, noack = (
            self._parse_xread_opts(args, True)
        )
        if ctx.in_exec:
            block_s = None
        starts = [self._s(sid) for sid in ids]
        # Redis shape rules: '>' streams with nothing new are OMITTED;
        # explicit-id streams always appear (possibly with an empty
        # array) and make the command non-blocking.
        any_explicit = any(s_ != ">" for s_ in starts)
        deadline = (
            None
            if block_s is None or any_explicit
            else _time.monotonic() + block_s
        )
        grid = self._client._grid
        while True:
            out = []
            got_new = False
            for k, start in zip(keys, starts):
                try:
                    entries = self._stream(k).read_group(
                        group, consumer, count, start, noack=noack
                    )
                except ValueError as e:
                    if "NOGROUP" not in str(e):
                        # e.g. an unparseable start id, not a missing group
                        raise RespError(
                            "Invalid stream ID specified as stream "
                            "command argument"
                        ) from e
                    raise RespError(
                        f"NOGROUP No such consumer group '{group}' for "
                        f"key name '{self._s(k)}'"
                    ) from e
                if start == ">":
                    if entries:
                        out.append((k, entries))
                        got_new = True
                else:
                    out.append((k, entries))
            if got_new or any_explicit or deadline is None:
                return self._xread_reply(out)
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                return self._xread_reply([])
            with grid.cond:
                grid.cond.wait(timeout=min(remaining, 1.0))

    def _cmd_XGROUP(self, args):
        sub = args[0].decode().upper()
        if sub == "CREATE":
            key, group, from_id = args[1], args[2].decode(), self._s(args[3])
            mkstream = any(
                a.decode().upper() == "MKSTREAM" for a in args[4:]
            )
            try:
                self._stream(key).create_group(
                    group, from_id, mkstream=mkstream
                )
            except ValueError as e:
                if "already exists" not in str(e):
                    # unparseable start id — NOT a duplicate group (a
                    # client treating BUSYGROUP as 'proceed' would then
                    # hit NOGROUP, a state impossible on real Redis)
                    raise RespError(
                        "Invalid stream ID specified as stream command "
                        "argument"
                    ) from e
                raise RespError(
                    "BUSYGROUP Consumer Group name already exists"
                ) from e
            except RuntimeError as e:
                raise RespError(
                    "The XGROUP subcommand requires the key to exist. Note "
                    "that for CREATE you may want to use the MKSTREAM "
                    "option to create an empty stream automatically."
                ) from e
            return _encode_simple("OK")
        if sub == "DESTROY":
            return _encode_int(
                int(self._stream(args[1]).remove_group(args[2].decode()))
            )
        raise RespError(f"Unknown XGROUP subcommand {sub}")

    def _cmd_XACK(self, args):
        try:
            return _encode_int(
                self._stream(args[0]).ack(
                    args[1].decode(), *[self._s(a) for a in args[2:]]
                )
            )
        except ValueError:
            return _encode_int(0)  # Redis: XACK on a missing group is 0

    def _cmd_XPENDING(self, args):
        s = self._stream(args[0])
        group = args[1].decode()
        if len(args) == 2:  # summary form
            try:
                p = s.pending(group)
            except ValueError as e:
                raise self._nogroup(args[0], group, e) from e
            consumers = [
                [c.encode(), str(n).encode()]
                for c, n in p["consumers"].items()
            ]
            out = (
                b"*4\r\n" + _encode_int(p["total"])
                + _encode_bulk(p["lowest_id"])
                + _encode_bulk(p["highest_id"])
            )
            if consumers:
                out += b"*" + str(len(consumers)).encode() + b"\r\n"
                for pair in consumers:
                    out += _encode_array(pair)
            else:
                out += b"*-1\r\n"
            return out
        # range form: [IDLE ms] start end count [consumer] — the int
        # parses stay OUTSIDE the NOGROUP mapping (a malformed count on
        # a live group is a value error, not a missing group).
        i = 2
        min_idle_ms = 0
        if args[i].decode().upper() == "IDLE":
            min_idle_ms = int(args[i + 1])
            i += 2
        start, end, count = (
            self._s(args[i]), self._s(args[i + 1]), int(args[i + 2])
        )
        consumer = args[i + 3].decode() if len(args) > i + 3 else None
        try:
            rows = s.pending_range(group, start, end, count, consumer)
        except ValueError as e:
            raise self._nogroup(args[0], group, e) from e
        if min_idle_ms:
            rows = [r for r in rows if r["idle_ms"] >= min_idle_ms]
        out = b"*" + str(len(rows)).encode() + b"\r\n"
        for r in rows:
            out += (
                b"*4\r\n" + _encode_bulk(r["id"])
                + _encode_bulk(r["consumer"].encode())
                + _encode_int(int(r["idle_ms"]))
                + _encode_int(r["delivered"])
            )
        return out

    def _nogroup(self, key: bytes, group: str, e: Exception) -> RespError:
        """Map the grid's NOGROUP ValueError to the -NOGROUP code every
        stock client keys on (the create-group-on-NOGROUP pattern)."""
        if "NOGROUP" not in str(e):
            raise e
        return RespError(
            f"NOGROUP No such consumer group '{group}' for key name "
            f"'{self._s(key)}'"
        )

    def _cmd_XCLAIM(self, args):
        s = self._stream(args[0])
        try:
            claimed = s.claim(
                args[1].decode(), args[2].decode(), int(args[3]),
                *[self._s(a) for a in args[4:]],
            )
        except ValueError as e:
            raise self._nogroup(args[0], args[1].decode(), e) from e
        return self._stream_entries_reply(claimed)

    def _cmd_XAUTOCLAIM(self, args):
        s = self._stream(args[0])
        count = 100
        justid = False
        i = 5
        while i < len(args):
            opt = args[i].decode().upper()
            if opt == "COUNT":
                count = int(args[i + 1])
                i += 2
            elif opt == "JUSTID":
                justid = True
                i += 1
            else:
                raise RespError("syntax error")
        try:
            cursor, claimed, deleted = s.auto_claim(
                args[1].decode(), args[2].decode(), int(args[3]),
                self._s(args[4]), count, with_cursor=True, justid=justid,
            )
        except ValueError as e:
            raise self._nogroup(args[0], args[1].decode(), e) from e
        # 7.0 reply: [next-cursor, entries, deleted-ids].  The cursor is
        # '0-0' only when the whole PEL was examined — a COUNT-truncated
        # sweep returns the id to continue from (clients loop until 0-0).
        # The third element names the ids the sweep dropped from the PEL
        # because their entries were deleted from the stream.
        body = (
            _encode_array([eid for eid, _ in claimed])
            if justid  # bare ids, per the JUSTID contract
            else self._stream_entries_reply(claimed)
        )
        return (
            b"*3\r\n" + _encode_bulk(cursor.encode()) + body
            + _encode_array([d.encode() for d in deleted])
        )

    def _cmd_XINFO(self, args):
        sub = args[0].decode().upper()
        s = self._stream(args[1])
        if sub == "STREAM":
            flat = [
                b"length", s.size(),
                b"last-generated-id", s.last_id().encode(),
                b"groups", len(s.list_groups()),
            ]
            return _encode_array(flat)
        if sub == "GROUPS":
            groups = s.list_groups()
            out = b"*" + str(len(groups)).encode() + b"\r\n"
            for g in groups:
                out += _encode_array([
                    b"name", g["name"].encode(),
                    b"consumers", g["consumers"],
                    b"pending", g["pending"],
                    b"last-delivered-id", g["last_delivered_id"].encode(),
                ])
            return out
        if sub == "CONSUMERS":
            try:
                rows = s.list_consumers(args[2].decode())
            except ValueError as e:
                raise self._nogroup(args[1], args[2].decode(), e) from e
            out = b"*" + str(len(rows)).encode() + b"\r\n"
            for r in rows:
                out += _encode_array([
                    b"name", r["name"].encode(), b"pending", r["pending"],
                ])
            return out
        raise RespError(f"Unknown XINFO subcommand {sub}")

    # geo (→ RGeo over grid/geo.py; GEOSEARCH option grammar follows
    # Redis 6.2)

    def _geo(self, key: bytes):
        from redisson_tpu_torch.grid.geo import Geo

        return self._raw(Geo(self._s(key), self._client))

    def _cmd_GEOADD(self, args):
        # [NX|XX] [CH] flags precede the lon/lat/member triples — a
        # coordinate position can never BE a flag, so this walk is safe.
        i = 1
        nx = xx = ch = False
        while i < len(args):
            opt = args[i].decode("latin-1").upper()
            if opt == "NX":
                nx = True
            elif opt == "XX":
                xx = True
            elif opt == "CH":
                ch = True
            else:
                break
            i += 1
        if nx and xx:
            raise RespError(
                "XX and NX options at the same time are not compatible"
            )
        if (len(args) - i) % 3 != 0 or len(args) == i:
            raise RespError("syntax error")
        entries = [
            (float(args[j]), float(args[j + 1]), args[j + 2])
            for j in range(i, len(args), 3)
        ]
        geo = self._geo(args[0])
        try:
            if not (nx or xx or ch):
                return _encode_int(geo.add_entries(*entries))
            added = changed = 0
            with self._client._grid.lock:
                for lon, lat, m in entries:
                    existed = geo.pos(m) != {}
                    if (nx and existed) or (xx and not existed):
                        continue
                    before = geo.pos(m).get(m)
                    added += geo.add(lon, lat, m)
                    if before != geo.pos(m).get(m):
                        changed += 1
            return _encode_int(changed if ch else added)
        except ValueError as e:
            raise RespError(f"invalid longitude,latitude pair ({e})") from e

    def _cmd_GEOPOS(self, args):
        pos = self._geo(args[0]).pos(*args[1:])
        out = b"*" + str(len(args) - 1).encode() + b"\r\n"
        for m in args[1:]:
            p = pos.get(m)
            if p is None:
                out += b"*-1\r\n"
            else:
                out += _encode_array([
                    f"{p[0]:.17g}".encode(), f"{p[1]:.17g}".encode(),
                ])
        return out

    def _cmd_GEODIST(self, args):
        unit = args[3].decode().lower() if len(args) > 3 else "m"
        d = self._geo(args[0]).dist(args[1], args[2], unit)
        return _encode_bulk(None if d is None else f"{d:.4f}".encode())

    def _cmd_GEOHASH(self, args):
        hashes = self._geo(args[0]).hash(*args[1:])
        return _encode_array([
            hashes.get(m, "").encode() or None for m in args[1:]
        ])

    @staticmethod
    def _parse_geosearch(args, i, allow_storedist: bool = False):
        """GEOSEARCH option walk from index ``i`` → (search kwargs,
        with-flags).  Option words are only recognized at option
        POSITIONS — operand slots (the FROMMEMBER member) are consumed
        raw, so a member whose bytes spell an option name stays a
        member."""
        kw = {}
        with_coord = with_dist = with_hash = False
        n = len(args)
        while i < n:
            try:
                opt = args[i].decode().upper()
            except UnicodeDecodeError:
                raise RespError("syntax error")  # binary junk in options
            if opt == "FROMMEMBER":
                kw["member"] = args[i + 1]
                i += 2
            elif opt == "FROMLONLAT":
                kw["longitude"] = float(args[i + 1])
                kw["latitude"] = float(args[i + 2])
                i += 3
            elif opt == "BYRADIUS":
                kw["radius"] = float(args[i + 1])
                kw["unit"] = args[i + 2].decode().lower()
                i += 3
            elif opt == "BYBOX":
                kw["width"] = float(args[i + 1])
                kw["height"] = float(args[i + 2])
                kw["unit"] = args[i + 3].decode().lower()
                i += 4
            elif opt in ("ASC", "DESC"):
                kw["order"] = opt.lower()
                i += 1
            elif opt == "COUNT":
                kw["count"] = int(args[i + 1])
                if kw["count"] <= 0:
                    # hits[:0] / hits[:-n] would silently drop members
                    raise RespError("COUNT must be > 0")
                i += 2
                if i < n and args[i].decode().upper() == "ANY":
                    kw["count_any"] = True
                    i += 1
            elif opt == "WITHCOORD":
                with_coord = True
                i += 1
            elif opt == "WITHDIST":
                with_dist = True
                i += 1
            elif opt == "WITHHASH":
                with_hash = True
                i += 1
            elif allow_storedist and opt == "STOREDIST":
                kw["storedist"] = True
                i += 1
            else:
                raise RespError("syntax error")
        return kw, with_coord, with_dist, with_hash

    def _cmd_GEOSEARCH(self, args):
        kw, wc, wd, wh = self._parse_geosearch(args, 1)
        try:
            rows = self._geo(args[0]).search(
                with_coord=wc, with_dist=wd, with_hash=wh, **kw
            )
        except ValueError as e:
            raise RespError(str(e)) from e
        if not (wc or wd or wh):
            return _encode_array(rows)
        out = b"*" + str(len(rows)).encode() + b"\r\n"
        for r in rows:
            parts = [_encode_bulk(r["member"])]
            if wd:
                parts.append(_encode_bulk(f"{r['dist']:.4f}".encode()))
            if wh:
                parts.append(_encode_int(r["hash"]))
            if wc:
                parts.append(_encode_array([
                    f"{r['coord'][0]:.17g}".encode(),
                    f"{r['coord'][1]:.17g}".encode(),
                ]))
            out += b"*" + str(len(parts)).encode() + b"\r\n" + b"".join(parts)
        return out

    def _cmd_GEOSEARCHSTORE(self, args):
        dest, src = self._s(args[0]), args[1]
        # STOREDIST parses POSITIONALLY inside the option walk (a member
        # named 'storedist' must stay a member, not become the flag).
        kw, _, _, _ = self._parse_geosearch(args, 2, allow_storedist=True)
        store_dist = kw.pop("storedist", False)
        unit = kw.pop("unit", "m")
        try:
            n = self._geo(src).search_and_store(
                dest, store_dist=store_dist, unit=unit, **kw
            )
        except ValueError as e:
            raise RespError(str(e)) from e
        return _encode_int(n)
