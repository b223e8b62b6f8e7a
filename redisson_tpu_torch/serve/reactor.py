"""Reactor front door — the Netty-analog event loop of the RESP serving
layer; the port's copy of ``redisson_tpu/serve/reactor.py``.

Thread-per-connection serving (serve/resp.py:_serve_conn) costs one
thread per client and gives an unpipelined client a private
wakeup→parse→dispatch round trip per command.  This module replaces it
with a small FIXED pool of reactor threads built on ``selectors``
(epoll on Linux):

* each reactor tick drains recv buffers across ALL ready connections,
  frames commands incrementally (``_StreamFramer``: the non-blocking
  analog of resp._Reader, native C parser first, pure-Python fallback),
  and feeds ONE merged parse→vectorize→dispatch pass
  (``RespServer._dispatch_merged``) — adjacent same-(object, family)
  ops from DIFFERENT connections fuse into single engine launches, so
  single-command clients get batch economics because the aggregate
  front door is always pipelined;
* per-connection ordering is preserved exactly: a connection's commands
  enter the merged window in arrival order, replies are demuxed back to
  their connection in that order, and a connection whose head command
  was handed off to a worker is frozen until the worker completes;
* writes go through per-connection non-blocking send buffers flushed on
  EPOLLOUT, with the slow-client output limits enforced against
  the buffered backlog (hard byte bound after its grace, no-progress
  stall bound, idle-timeout fallback — the same policy
  _ConnCtx._send_bounded applies on the thread path);
* commands that may legitimately block (BLPOP, blocking XREAD, pub/sub
  registration, SAVE's snapshot, DEBUG, EXEC's replay) are handed off to
  a dedicated worker thread so one parked client can never stall the
  event loop — the worker-thread population tracks the number of
  BLOCKED clients, not the number of connected ones.

10k mostly-idle connections therefore cost file descriptors instead of
threads, and the thread count is fixed at ``resp_reactor_threads`` (+
one worker per currently-blocked client).  ``resp_reactor=False``
restores the legacy accept loop for differential testing; per-connection
reply streams are byte-identical either way (tests/test_torch_reactor.py).
"""

from __future__ import annotations

import selectors
import socket
import threading
import time
import traceback
from collections import deque

from redisson_tpu_torch.analysis import witness as _witness
from redisson_tpu_torch.serve.resp import (
    ProtocolError,
    _ConnCtx,
    _PIPELINE_STOP,
    _encode_error,
)

# Commands the reactor hands off to a dedicated worker thread instead of
# dispatching inline on the event loop: anything that may park (blocking
# pops/reads), writes push frames itself (pub/sub registration), runs
# arbitrary code (scripts — SCRIPT also rides a worker so SCRIPT KILL
# stays dispatchable while a runaway script owns another worker), or
# performs heavy I/O (WAIT's fsync fence, SAVE's snapshot, DEBUG SLEEP).
# The connection is frozen while its worker runs, so per-connection
# ordering is untouched.
_DETACH = frozenset(_PIPELINE_STOP) | frozenset((
    b"EVAL", b"EVALSHA", b"SCRIPT", b"FCALL", b"FCALL_RO", b"FUNCTION",
    b"WAIT", b"SAVE", b"BGREWRITEAOF", b"DEBUG", b"EXEC",
    # Cluster control plane: MIGRATE blocks on a cross-node
    # RESTORE round trip under the move guard — inline it would freeze
    # the whole front door per migrated key (and two nodes migrating
    # toward each other would stall each other's loops); CLUSTER's
    # GETKEYSINSLOT/COUNTKEYSINSLOT scan the full keyspace.
    b"MIGRATE", b"CLUSTER",
    # Replication stream: REPLFETCH long-polls (parks up to
    # its timeout-ms when the replica is caught up) and PSYNC's
    # FULLRESYNC branch takes a whole snapshot — both would freeze the
    # event loop inline.
    b"RTPU.PSYNC", b"RTPU.REPLFETCH",
))

# Per-tick bounds: commands taken from one connection, commands in one
# merged window, and the per-connection reply backlog above which the
# reactor stops consuming that connection's commands (TCP backpressure —
# the analog of the thread path's blocking sendall).
_MAX_PER_CONN = 1024
_MAX_PER_TICK = 4096
_OUTBUF_HWM = 4 << 20
_PENDING_HWM = 4096
_TICK_S = 0.1
_SWEEP_S = 1.0
# Gather window: when several connections are attached, a tick that saw
# new events keeps collecting stragglers in short extra selects before
# dispatching — the front-door analog of the coalescer's flush window
# (closed-loop unpipelined clients answer a reply wave within ~an RTT,
# so a sub-ms wait turns N tiny merged passes into one wide one).
# Gathering stops the moment a gather select comes back empty, so the
# total wait tracks the actual straggler stream instead of a fixed
# penalty.  Skipped when the reactor serves ≤2 connections: a lone
# pipelined client should not pay the window on every batch.
_GATHER_S = 0.0003
_GATHER_MAX = 1

# Fusable-family classification (pure-Python mirror of the native
# classifier in resp_codec.c:rtpu_classify — the two MUST agree, or a
# connection's chunking would depend on which parser framed it).
_FAM_BF = frozenset((b"BF.ADD", b"BF.MADD", b"BF.EXISTS", b"BF.MEXISTS"))


def _family_code(cmd) -> int:
    """Family class of one command (0 = non-fusable)."""
    if not cmd:
        return 0
    name = cmd[0].upper()
    if name in _FAM_BF:
        return 1
    if name in (b"SETBIT", b"GETBIT"):
        return 2
    if name in (b"GET", b"MGET"):
        return 3
    if name == b"CMS.QUERY":
        return 4
    return 0


class _StreamFramer:
    """Incremental RESP request framer over a growing byte buffer — the
    non-blocking analog of ``resp._Reader`` (which recv()s inline).
    ``feed()`` bytes as they arrive, ``pop_into()`` every complete
    command; raises ProtocolError on malformed frames (the caller
    replies once and closes, Redis-style)."""

    def __init__(self):
        from redisson_tpu_torch.serve import native_codec

        self._native = native_codec.get_parser()
        self._parse_ok = native_codec.PARSE_OK
        self._buf = b""
        # Chunks accumulate per recv and join ONCE per parse attempt:
        # `bytes +=` per 64 KB recv would copy the whole accumulated
        # buffer every time — quadratic for a multi-MB frame growing
        # across ticks.
        self._chunks: list = []

    @property
    def buffered(self) -> int:
        return len(self._buf) + sum(len(c) for c in self._chunks)

    def at_frame_boundary(self) -> bool:
        return not self._buf and not self._chunks

    def feed(self, data: bytes) -> None:
        self._chunks.append(data)

    def pop_into(self, out: deque) -> None:
        if self._chunks:
            self._buf += b"".join(self._chunks)
            self._chunks.clear()
        while self._buf:
            if self._native is not None:
                frames, consumed, err = self._native.parse(self._buf)
                if frames:
                    self._buf = self._buf[consumed:]
                    out.extend(frames)
                    continue
                if err == self._parse_ok:
                    return  # incomplete frame: wait for more bytes
                # Inline command or malformed frame: the pure-Python
                # path below reproduces the blocking reader's behavior.
            cmd = self._parse_py_one()
            if cmd is None:
                return
            out.append(cmd)

    def _parse_py_one(self):
        """Parse ONE command from the front of the buffer; None when the
        bytes there are still incomplete."""
        buf = self._buf
        nl = buf.find(b"\r\n")
        if nl < 0:
            return None
        line = buf[:nl]
        if not line.startswith(b"*"):
            # Inline command (redis-cli fallback); a blank line parses
            # to [] which the dispatch loop skips with no reply.
            self._buf = buf[nl + 2:]
            return line.split()
        try:
            n = int(line[1:])
        except ValueError:
            raise ProtocolError("invalid multibulk length")
        if n < 0:
            raise ProtocolError("invalid multibulk length")
        pos = nl + 2
        args = []
        for _ in range(n):
            nl2 = buf.find(b"\r\n", pos)
            if nl2 < 0:
                return None
            hdr = buf[pos:nl2]
            if not hdr.startswith(b"$"):
                raise ProtocolError("invalid bulk length")
            try:
                size = int(hdr[1:])
            except ValueError:
                raise ProtocolError("invalid bulk length")
            if size < 0:
                raise ProtocolError("invalid bulk length")
            pos = nl2 + 2
            if len(buf) < pos + size + 2:
                return None
            args.append(buf[pos:pos + size])
            pos += size + 2
        self._buf = buf[pos:]
        return args


class _ReactorCtx(_ConnCtx):
    """Loop-drivable connection ctx: ``send`` enqueues into the
    reactor-managed output buffer instead of blocking on the socket, so
    pub/sub pushes and detached-worker replies from ANY thread land in
    the connection's ordered backlog and the event loop flushes them."""

    def __init__(self, sock, server, rconn):
        super().__init__(sock, server=server)
        self._rconn = rconn

    def send(self, frame: bytes) -> None:
        self._rconn.enqueue(frame)


class _RConn:
    """Per-connection reactor state."""

    def __init__(
        self,
        sock: socket.socket,
        server,
        reactor: "_Reactor",
        peer: bool = False,
    ):
        self.sock = sock
        self.fd = sock.fileno()
        self.reactor = reactor
        self.peer = peer  # in-node handoff leg from a sibling worker
        # Native tick path: the per-connection leftover buffer for
        # rtpu_resp_tick (drain+frame+classify in one native call).  The
        # slow-path framer is built lazily, only when this connection
        # falls off the native path (inline commands, proto errors) or
        # the ticker is unavailable.
        ticker = getattr(reactor, "ticker", None)
        self.tickbuf = ticker.new_buf() if ticker is not None else None
        self.framer = None if self.tickbuf is not None else _StreamFramer()
        self.pending: deque = deque()  # (family, argv) not-yet-dispatched
        # Guards outbuf + progress stamps: enqueue() runs cross-thread
        # (pub/sub pushes, detached workers), flush on the reactor.
        self.wlock = _witness.named(threading.Lock(), "resp.reactor.outbuf")
        self.outbuf = bytearray()
        self.backlog_t0 = 0.0  # when outbuf last went empty -> non-empty
        self.last_progress = 0.0
        self.last_activity = time.monotonic()
        self.busy = False  # a detached worker owns the head command
        self.closing = False
        self.closed = False  # teardown completed (idempotence guard)
        self.eof = False  # peer closed its write side
        self.read_paused = False
        self.want_write = False
        self.registered = False
        self.cur_mask = 0  # interest set currently in the selector
        self.ctx = _ReactorCtx(sock, server, self)
        if peer:
            # Sibling-worker legs are pre-trusted (same process tree,
            # unix socket under the node's private rundir) and carry
            # already-authed client traffic.
            self.ctx.is_peer = True

    def at_frame_boundary(self) -> bool:
        if self.tickbuf is not None and self.tickbuf.have:
            return False
        return self.framer is None or self.framer.at_frame_boundary()

    def enqueue(self, frame: bytes) -> None:
        """Append a reply/push frame to the ordered output backlog
        (thread-safe) and wake the event loop to flush it."""
        if not frame:
            return
        with self.wlock:
            if self.closing:
                return
            if not self.outbuf:
                now = time.monotonic()
                self.backlog_t0 = now
                self.last_progress = now
            self.outbuf += frame
            self.want_write = True
        # Flag for the loop's flush sweep (a SET, not an every-conn
        # scan — 5k idle connections must not be walked per tick), then
        # wake it — unless we ARE the loop, which flushes its own
        # enqueues at the end of the pass (a self-directed wakeup would
        # just burn a pipe syscall per frame).
        r = self.reactor
        r.want_flush.add(self)
        if threading.get_ident() != r.tid:
            r.wake()


class _Reactor(threading.Thread):
    """One event-loop thread: a selector over its share of the
    connections, a self-pipe for cross-thread wakeups, and the merged
    dispatch pass."""

    # Dispatch-pass sequence number: traced commands annotate which tick
    # carried them, correlating a trace with the cross-connection fusion
    # window it rode.  A class attribute, so a harness that drives
    # _run_pass without __init__ still reads 0.
    tick_seq = 0

    def __init__(self, server, idx: int):
        super().__init__(name=f"rtpu-resp-reactor-{idx}", daemon=True)
        self.server = server
        from redisson_tpu_torch.serve import native_codec

        # One native ticker per reactor thread (its descriptor arrays
        # are single-threaded scratch); None degrades every connection
        # to the Python framer path.
        self.ticker = native_codec.get_ticker()
        self.sel = selectors.DefaultSelector()
        self.conns: dict = {}  # fd -> _RConn
        self._new: deque = deque()  # sockets awaiting registration
        self._stopping = False
        self.tid: int = 0  # run()'s thread id (self-wake elision)
        # Connections that may have dispatchable work (framed commands
        # pending, or a worker just un-froze them): the pass iterates
        # THIS set, not every connection — 5k idle connections must not
        # cost 5k eligibility checks per tick.  GIL-atomic set ops;
        # workers add cross-thread.
        self._attention: set = set()
        # Connections with unflushed enqueues (same discipline: a set
        # fed by enqueue(), drained by the loop — never a full scan).
        self.want_flush: set = set()
        self._last_sweep = time.monotonic()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self.sel.register(self._wake_r, selectors.EVENT_READ, None)

    # -- cross-thread surface ------------------------------------------------

    def add_conn(self, sock: socket.socket, peer: bool = False) -> None:
        self._new.append((sock, peer))
        self.wake()

    def wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        # rtpulint: disable=RT013 self-pipe wake channel: no replies ever ride it, and a full pipe already guarantees a pending wakeup — there is nothing to desync or drop
        except (BlockingIOError, OSError):
            pass  # pipe already full: a wakeup is pending anyway

    def stop(self) -> None:
        self._stopping = True
        self.wake()

    # -- event loop ----------------------------------------------------------

    def run(self) -> None:
        self.tid = threading.get_ident()
        while not self._stopping:
            try:
                self._tick()
            except Exception:  # pragma: no cover - defensive
                # A bug in the loop must not silently kill every
                # connection on this reactor; report and keep serving.
                traceback.print_exc()
                time.sleep(0.01)
        # Reactor retired: release selector resources.  Connections are
        # closed by the server's drain (close()) before stop() runs.
        try:
            self.sel.close()
        except OSError:
            pass
        self._wake_r.close()
        self._wake_w.close()

    def _tick(self) -> None:
        timeout = 0.0 if self._work_ready() else _TICK_S
        events = self.sel.select(timeout)
        gathers = _GATHER_MAX if events and len(self.conns) > 2 else 0
        while True:
            now = time.monotonic()
            for key, mask in events:
                rconn = key.data
                if rconn is None:
                    self._drain_wake()
                    continue
                if rconn.closing:
                    self._close_conn(rconn)  # async close: finish it
                    continue
                if mask & selectors.EVENT_WRITE:
                    self._flush(rconn)
                if mask & selectors.EVENT_READ:
                    self._read_ready(rconn, now)
            if gathers <= 0:
                break
            gathers -= 1
            events = self.sel.select(_GATHER_S)
            if not events:
                break
        self._admit_new()
        self._apply_write_interest()
        self._run_pass(now)
        if now - self._last_sweep >= self._sweep_interval():
            self._last_sweep = now
            self._sweep(now)

    def _sweep_interval(self) -> float:
        """Sweep cadence tracks the tightest armed gate (a 0.3 s idle
        timeout must not wait for a 1 s sweep); defaults coarse so 5k
        idle connections aren't rescanned every tick."""
        srv = self.server
        interval = _SWEEP_S
        idle_s = srv.idle_timeout_s or 0.0
        if idle_s:
            interval = min(interval, idle_s / 4.0)
        soft_s = getattr(srv, "output_buffer_soft_seconds", 0.0) or 0.0
        if soft_s:
            interval = min(interval, soft_s / 4.0)
        if getattr(srv, "output_buffer_limit", 0):
            interval = min(interval, 0.25)  # hard-grace is ~1 s
        return max(0.05, interval)

    def _work_ready(self) -> bool:
        """Leftover dispatchable work (requeued tails, worker-released
        queues): the next tick must not sleep on select."""
        # tuple() snapshots the set in one C call (GIL-atomic): workers
        # add() concurrently, and a Python-level iteration racing that
        # add would raise "set changed size during iteration".
        for c in tuple(self._attention):
            if (
                c.pending and not c.busy and not c.closing
                and len(c.outbuf) < _OUTBUF_HWM
            ):
                return True
        return False

    def _drain_wake(self) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        # rtpulint: disable=RT013 self-pipe wake channel: drained opportunistically, carries no reply stream — a failed drain cannot desync anything
        except (BlockingIOError, OSError):
            pass

    def _admit_new(self) -> None:
        while self._new:
            sock, peer = self._new.popleft()
            try:
                sock.setblocking(False)
                rconn = _RConn(sock, self.server, self, peer=peer)
            except OSError:
                self._teardown_slot(sock)
                continue
            if self.server._requirepass and not peer:
                rconn.ctx.authed = False
            try:
                self.sel.register(sock, selectors.EVENT_READ, rconn)
            except (OSError, ValueError):
                self._teardown_slot(sock)
                continue
            rconn.registered = True
            rconn.cur_mask = selectors.EVENT_READ
            self.conns[rconn.fd] = rconn

    def _read_ready(self, rconn: _RConn, now: float) -> None:
        if rconn.tickbuf is not None:
            self._read_ready_native(rconn, now)
            return
        got = False
        eof = False
        budget = 1 << 20
        try:
            # Drain the socket, bounded PER TICK so one firehose client
            # cannot starve the pass — the framer buffer itself may
            # grow past the budget across ticks (a single 4 MB SET's
            # frame must be able to accumulate; level-triggered select
            # re-fires until the socket is dry).
            while budget > 0:
                data = rconn.sock.recv(1 << 16)
                if not data:
                    eof = True
                    break
                got = True
                budget -= len(data)
                rconn.framer.feed(data)
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            eof = True
        if got:
            rconn.last_activity = now
            if not self._pop_framed(rconn):
                return
            if rconn.pending:
                self._attention.add(rconn)
            if len(rconn.pending) > _PENDING_HWM and not rconn.read_paused:
                rconn.read_paused = True
                self._update_mask(rconn)
        if eof:
            # Peer closed its write side.  Parity with the thread path:
            # commands ALREADY framed still execute and their replies
            # flush (a pipelining client may legitimately half-close
            # after its last request); the connection closes once its
            # queue and backlog drain (_maybe_close_eof).
            rconn.eof = True
            rconn.read_paused = True
            self._update_mask(rconn)
            self._maybe_close_eof(rconn)

    def _pop_framed(self, rconn: _RConn) -> bool:
        """Pop slow-path framer output into pending as (family, argv)
        tuples.  False when the stream desynced and the conn closed."""
        tmp: deque = deque()
        try:
            rconn.framer.pop_into(tmp)
        except ProtocolError as e:
            # Desynced stream: reply once, then close (Redis-style;
            # mirrors _serve_conn's ProtocolError arm).
            rconn.enqueue(_encode_error(f"Protocol error: {e}"))
            self._flush(rconn)
            self._close_conn(rconn)
            return False
        for cmd in tmp:
            rconn.pending.append((_family_code(cmd), cmd))
        return True

    def _read_ready_native(self, rconn: _RConn, now: float) -> None:
        """Native per-tick hot loop: one rtpu_resp_tick call drains the
        fd, frames every complete command, and classifies its family —
        Python sees only the parsed (family, argv) stream."""
        from redisson_tpu_torch.serve import native_codec

        got, eof, err = self.ticker.tick(
            rconn.fd, rconn.tickbuf, rconn.pending
        )
        if got:
            rconn.last_activity = now
        if err != native_codec.PARSE_OK:
            # Inline command, oversized frame, or malformed bytes:
            # retire the native path for this connection and let the
            # slow-path framer reproduce the blocking reader's behavior
            # (including the precise protocol-error message).
            rconn.framer = _StreamFramer()
            rconn.framer.feed(rconn.tickbuf.take())
            rconn.tickbuf = None
            if not self._pop_framed(rconn):
                return
        if rconn.pending:
            self._attention.add(rconn)
            if len(rconn.pending) > _PENDING_HWM and not rconn.read_paused:
                rconn.read_paused = True
                self._update_mask(rconn)
        if eof:
            rconn.eof = True
            rconn.read_paused = True
            self._update_mask(rconn)
            self._maybe_close_eof(rconn)

    def _maybe_close_eof(self, rconn: _RConn) -> None:
        if (
            rconn.eof and not rconn.closing and not rconn.busy
            and not rconn.pending and not rconn.outbuf
        ):
            self._close_conn(rconn)

    # -- merged dispatch pass ------------------------------------------------

    def _needs_detach(self, rconn: _RConn, fam: int, cmd) -> bool:
        ctx = rconn.ctx
        if fam == 0:
            name = cmd[0].upper()
            if ctx.in_multi:
                # Queued-under-MULTI commands just queue (fast, inline);
                # only EXEC executes — and may replay scripts — so it
                # rides a worker.  EXEC's replay re-enters _dispatch per
                # member, so the multicore hook still applies to each.
                return name == b"EXEC"
            if name in _DETACH:
                return True
        elif ctx.in_multi:
            return False  # fusable-family member queueing under MULTI
        # Per-core front door: a keyed command owned by a sibling worker
        # rides a worker thread too — its in-node handoff leg blocks on
        # the peer's reply, which must never park the event loop.  Peer
        # legs themselves always execute locally.
        mc = getattr(self.server, "multicore", None)
        return (
            mc is not None
            and not ctx.is_peer
            and mc.needs_handoff(cmd)
        )

    @staticmethod
    def _family_key(fam: int, cmd):
        """Grouping key for cross-connection adjacency: commands of one
        fusable family (and target object) sort together inside a
        round, so the vectorizer's adjacency scan sees them as one run.
        Non-fusable commands share a bucket that preserves arrival
        order (the sort is stable)."""
        if fam in (1, 2, 4):
            return (fam, cmd[1] if len(cmd) > 1 else b"")
        return (fam, b"")

    def _run_pass(self, now: float) -> None:
        server = self.server
        per_conn: list = []  # (rconn, [cmds...]) snapshots, conn order
        handoffs: list = []
        total = 0
        for rconn in sorted(tuple(self._attention), key=lambda c: c.fd):
            if rconn.closing or not rconn.pending:
                self._attention.discard(rconn)
                continue
            if rconn.busy:
                continue  # worker re-adds on completion
            if len(rconn.outbuf) >= _OUTBUF_HWM:
                continue  # backpressure: let the peer read first
            taken: list = []
            while (
                rconn.pending and len(taken) < _MAX_PER_CONN
                and total < _MAX_PER_TICK
            ):
                fam, cmd = rconn.pending[0]
                if not cmd:
                    rconn.pending.popleft()  # empty frame: no reply
                    continue
                if self._needs_detach(rconn, fam, cmd):
                    if not taken:
                        handoffs.append(rconn)
                    break
                taken.append(rconn.pending.popleft())
                total += 1
            if taken:
                per_conn.append((rconn, taken))
            if (
                rconn.read_paused
                and len(rconn.pending) < _PENDING_HWM // 2
            ):
                rconn.read_paused = False
                self._update_mask(rconn)
        # Merged-window layout: each connection's snapshot splits into
        # CHUNKS of consecutive same-(family, object) commands (exactly
        # the spans the vectorizer fuses), then rounds of one chunk per
        # connection are stably grouped by family — commands from
        # different connections carry no mutual ordering contract, so
        # grouping their chunks is free, and it is what turns N
        # single-command clients into one fused engine launch (the
        # batch economics).  A connection's own commands
        # stay in arrival order: chunks concatenate in order, and a
        # chunk is an order-preserving slice.
        cmds: list = []
        fams: list = []
        ctxs: list = []
        owners: list = []
        chunked: list = []  # (rconn, [[cmds of chunk 0], [chunk 1], ...])
        for rconn, taken in per_conn:
            chunks: list = []
            key = None
            for fam, cmd in taken:
                k = self._family_key(fam, cmd)
                if key is not None and k == key and fam != 0:
                    chunks[-1][1].append((fam, cmd))
                else:
                    chunks.append((k, [(fam, cmd)]))
                    key = k
            chunked.append((rconn, chunks))
        depth = max((len(ch) for _, ch in chunked), default=0)
        for r in range(depth):
            round_items = [
                (rconn, chunks[r])
                for rconn, chunks in chunked
                if r < len(chunks)
            ]
            if len(round_items) > 1:
                round_items.sort(key=lambda it: it[1][0])
            for rconn, (_k, chunk) in round_items:
                for fam, cmd in chunk:
                    cmds.append(cmd)
                    fams.append(fam)
                    ctxs.append(rconn.ctx)
                    owners.append(rconn)
        if cmds:
            self.tick_seq += 1
            obs = server.obs
            if obs is not None:
                obs.reactor_ticks.inc()
                obs.reactor_ready_conns.inc(
                    (), len({id(o) for o in owners})
                )
            try:
                frames, consumed = server._dispatch_merged(cmds, ctxs)
            except Exception:
                # The dispatch pass died outside any per-command guard:
                # protocol position of every involved connection is
                # unknowable — close them (never desync a stream).
                traceback.print_exc()
                for rconn in set(owners):
                    self._close_conn(rconn)
                return
            # Unconsumed tail (reply-buffer bound) back to the FRONT of
            # each owner's queue, in order.
            for k in range(len(cmds) - 1, consumed - 1, -1):
                owners[k].pending.appendleft((fams[k], cmds[k]))
            for k in range(consumed):
                frame = frames[k]
                if frame:
                    owners[k].enqueue(frame)
                owners[k].last_activity = now
            for rconn in {id(o): o for o in owners}.values():
                if not rconn.closing:
                    self._flush(rconn)
        for rconn in handoffs:
            if rconn.busy or rconn.closing or not rconn.pending:
                continue
            _fam, cmd = rconn.pending.popleft()
            rconn.busy = True
            # One thread PER DETACHED COMMAND (not a pool): a pool
            # bounds concurrency, and blocking pops parked in every
            # slot would deadlock against the LPUSH-ing connections
            # waiting behind them.  The spawn (~100 µs) is paid only by
            # the blocking/script/admin command class — a detach-heavy
            # stream is the one shape the thread-per-connection path
            # served better, and it still works here, just not faster.
            threading.Thread(
                target=self._detached, args=(rconn, cmd),
                name="rtpu-resp-detach", daemon=True,
            ).start()
        # Drained connections leave the attention set (it must track
        # ACTIVE conns only — its size is the per-tick cost).
        for rconn, _taken in per_conn:
            if not rconn.pending:
                self._attention.discard(rconn)
        for rconn in handoffs:
            if not rconn.pending:
                self._attention.discard(rconn)

    def _detached(self, rconn: _RConn, cmd) -> None:
        """Worker-thread dispatch of one potentially-blocking command.
        The connection is frozen (busy) until this completes, so its
        ordering is exactly the thread path's."""
        try:
            frame = self.server._safe_dispatch(cmd, rconn.ctx)
            if frame:
                rconn.ctx.send(frame)
        except BaseException:  # _safe_dispatch already maps everything
            traceback.print_exc()
            self._close_conn_async(rconn)
        finally:
            rconn.last_activity = time.monotonic()
            rconn.busy = False
            self._attention.add(rconn)  # GIL-atomic; loop re-examines
            if rconn.closing and rconn.ctx.subs:
                # The connection died while this worker ran (e.g. a
                # SUBSCRIBE racing a peer reset): drop any listener the
                # close sweep could not see yet.
                self._unsubscribe_all(rconn)
            self.wake()

    # -- writes / slow-client protection ------------------------------------

    def _flush(self, rconn: _RConn) -> None:
        """Send as much of the backlog as the socket accepts (reactor
        thread only)."""
        dead = False
        with rconn.wlock:
            buf = rconn.outbuf
            while buf:
                try:
                    n = rconn.sock.send(memoryview(buf)[: 1 << 18])
                except (BlockingIOError, InterruptedError):
                    break
                except OSError:
                    dead = True
                    break
                if n <= 0:
                    break
                del buf[:n]
                rconn.last_progress = time.monotonic()
            rconn.want_write = bool(buf) and not dead
        if dead:
            self._close_conn(rconn)
            return
        self._update_mask(rconn)
        self._maybe_close_eof(rconn)

    def _apply_write_interest(self) -> None:
        """Flush connections flagged by enqueue() — drains the
        want_flush set (set.pop is GIL-atomic against concurrent
        adds), never a scan over every connection."""
        while self.want_flush:
            try:
                rconn = self.want_flush.pop()
            except KeyError:
                break
            if not rconn.closing:
                self._flush(rconn)

    def _update_mask(self, rconn: _RConn) -> None:
        if rconn.closing or not rconn.registered:
            return
        mask = 0
        if not rconn.read_paused:
            mask |= selectors.EVENT_READ
        if rconn.want_write:
            mask |= selectors.EVENT_WRITE
        if mask == rconn.cur_mask:
            return  # epoll_ctl is a syscall: skip no-op modifies
        try:
            if mask:
                self.sel.modify(rconn.sock, mask, rconn)
                rconn.cur_mask = mask
            else:
                # selectors reject an empty interest set: park the fd
                # out of the selector until interest returns.
                self.sel.unregister(rconn.sock)
                rconn.registered = False
                rconn.cur_mask = 0
        except (KeyError, OSError, ValueError):
            pass

    def _sweep(self, now: float) -> None:
        """Periodic gates: slow-client output limits over the buffered
        backlog (the policy _send_bounded enforces inline on
        the thread path) and the idle timeout."""
        server = self.server
        hard = getattr(server, "output_buffer_limit", 0) or 0
        soft_s = getattr(server, "output_buffer_soft_seconds", 0.0) or 0.0
        idle_s = server.idle_timeout_s or 0.0
        stall_s = soft_s or idle_s
        hard_grace = soft_s or 1.0
        for rconn in list(self.conns.values()):
            if rconn.closing:
                continue
            self._maybe_close_eof(rconn)
            if rconn.closing:
                continue
            with rconn.wlock:
                backlog = len(rconn.outbuf)
                t0 = rconn.backlog_t0
                prog = rconn.last_progress
            if backlog:
                if hard and backlog > hard and now - t0 > hard_grace:
                    server._note_slow_client("hard-bytes", backlog)
                    self._close_conn(rconn)
                    continue
                if stall_s and now - prog > stall_s:
                    server._note_slow_client(
                        "soft-seconds" if soft_s else "idle-timeout",
                        backlog,
                    )
                    self._close_conn(rconn)
                    continue
            elif (
                idle_s and not rconn.busy
                and now - rconn.last_activity > idle_s
            ):
                if (
                    (rconn.ctx.subs or rconn.ctx.monitor or rconn.peer)
                    and rconn.at_frame_boundary()
                    and not rconn.pending
                ):
                    # Subscribers and monitors may idle legitimately — but
                    # only at a frame boundary (same exemption as
                    # _serve_conn).  Sibling-worker handoff legs are
                    # pooled and long-lived by design.
                    rconn.last_activity = now
                else:
                    self._close_conn(rconn)
            # Re-park the fd if a paused/unregistered conn regained
            # interest outside the normal paths.
            if (
                not rconn.closing and not rconn.registered
                and (not rconn.read_paused or rconn.want_write)
            ):
                try:
                    mask = 0
                    if not rconn.read_paused:
                        mask |= selectors.EVENT_READ
                    if rconn.want_write:
                        mask |= selectors.EVENT_WRITE
                    self.sel.register(rconn.sock, mask, rconn)
                    rconn.registered = True
                    rconn.cur_mask = mask
                except (OSError, ValueError, KeyError):
                    pass

    # -- teardown ------------------------------------------------------------

    def _close_conn_async(self, rconn: _RConn) -> None:
        """Request a close from a non-reactor thread: shut the socket
        down so the event loop observes it and tears down properly."""
        rconn.closing = True
        try:
            rconn.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.wake()

    def _teardown_slot(self, sock: socket.socket) -> None:
        """A connection died before registration: release its slot."""
        try:
            sock.close()
        except OSError:
            pass
        server = self.server
        with server._conn_lock:
            server._nconn -= 1
            server._conns.discard(sock)
            server._conn_idle.notify_all()

    def _unsubscribe_all(self, rconn: _RConn) -> None:
        bus = self.server._client._topic_bus
        for channel, lid in list(rconn.ctx.subs.items()):
            rconn.ctx.subs.pop(channel, None)
            try:
                bus.unsubscribe(channel, lid)
            except Exception:
                pass

    def _close_conn(self, rconn: _RConn) -> None:
        if rconn.closed:
            return
        rconn.closed = True
        rconn.closing = True
        self._attention.discard(rconn)
        self.want_flush.discard(rconn)
        # fd-reuse guard: only drop the table entry if it is still OURS
        # (the fd may already back a newer connection).
        if self.conns.get(rconn.fd) is rconn:
            del self.conns[rconn.fd]
        if rconn.registered:
            try:
                self.sel.unregister(rconn.sock)
            except (KeyError, OSError, ValueError):
                pass
            rconn.registered = False
        self._unsubscribe_all(rconn)
        self.server._monitors.discard(rconn.ctx)
        try:
            rconn.sock.close()
        except OSError:
            pass
        server = self.server
        with server._conn_lock:
            server._nconn -= 1
            server._conns.discard(rconn.sock)
            server._conn_idle.notify_all()


class ReactorPool:
    """The fixed reactor-thread pool fronting one RespServer.  The
    accept loop assigns connections round-robin; each reactor owns its
    share for life (no cross-reactor migration — per-connection state
    stays single-threaded)."""

    def __init__(self, server, nthreads: int = 1):
        self.nthreads = max(1, int(nthreads))
        self._reactors = [
            _Reactor(server, i) for i in range(self.nthreads)
        ]
        self._rr = 0
        for r in self._reactors:
            r.start()

    def assign(self, sock: socket.socket, peer: bool = False) -> None:
        r = self._reactors[self._rr % self.nthreads]
        self._rr += 1
        r.add_conn(sock, peer=peer)

    @property
    def native_tick(self) -> bool:
        """True when the reactors run the fused native drain+frame loop
        (rtpu_resp_tick) — INFO frontdoor surfaces this so an A/B run
        can verify which arm it measured."""
        return any(r.ticker is not None for r in self._reactors)

    def connection_count(self) -> int:
        return sum(len(r.conns) for r in self._reactors)

    def close(self, timeout_s: float = 5.0) -> None:
        for r in self._reactors:
            r.stop()
        deadline = time.monotonic() + timeout_s
        for r in self._reactors:
            r.join(timeout=max(0.1, deadline - time.monotonic()))
