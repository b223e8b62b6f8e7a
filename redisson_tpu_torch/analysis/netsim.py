"""netsim — deterministic multi-node protocol checker, the explorer's
lineage extended across the process boundary.

The cluster plane is genuinely distributed — slot migration under
the ``cluster.move`` guard, MOVED/ASK redirect chasing, group-commit
journaling with kill -9 recovery — but the correctness tooling stopped
at one process: the explorer model-checks THREAD interleavings, and the
cross-node invariants were proven only by live-subprocess tests that
see one lucky interleaving per run.  This module makes the MESSAGE
interleavings enumerable too:

- Nodes run as in-process actors: each connection handler is a
  simulated thread under the explorer's cooperative scheduler (exactly
  one runs at a time, every sync point is a scheduling decision), so a
  whole N-node protocol executes inside one ``explore()`` body.
- The network is simulated: :class:`Net` patches
  ``socket.create_connection`` for the duration of the run, so the
  REAL shipped wire code — ``cluster/client.py``'s pooled connections
  and redirect chase, ``cluster/door.py``'s migration sockets,
  ``cluster/supervisor.py``'s ``migrate_slot`` pump,
  ``serve/wireutil.exchange`` — dials simulated sockets without a
  single line changed.  Each connection is a pair of per-direction
  FIFO pipes (per-link FIFO, like TCP); delivery ORDER ACROSS links is
  a scheduler choice, so bounded reordering between nodes is explored,
  not sampled.
- Faults are schedule decisions (:func:`explorer.decide`), so the DFS
  explores delivery×fault×crash interleavings and ONE
  ``RTPU_SCHEDULE_REPLAY`` token replays the exact failing schedule:

  * **drop** — a send may abort the connection (RST to both ends),
    bounded by ``drop_budget``;
  * **defer** — a send may gate its LINK for ``defer_s`` virtual
    seconds (later sends on the same link queue behind it — FIFO is
    preserved, cross-link order shifts), bounded by ``defer_budget``;
  * **timeout** — sockets honor ``settimeout`` against the virtual
    clock, so the shipped timeout paths run deterministically;
  * **crash/restart** — :meth:`Net.crash` kills every actor of a node
    (``explorer.kill``: they die at their next sync point, unwinding
    ``with`` blocks) and RSTs every connection touching it;
    :meth:`Net.restart` brings the listener back.

Transport-seam contract (what a model may stub, and nothing else):
the seam is ``socket.create_connection`` + the socket surface below
(``sendall``/``recv``/``close``/``settimeout``/``setsockopt``) and,
for clients that fan work out on a thread pool, the executor seam
(:class:`SimThreadExecutor` — the pool must not be a real
``ThreadPoolExecutor``, whose C-level queue the scheduler cannot see).
Everything protocol-bearing — routing, redirect chasing, the move
guard, license consumption, journal commit — must be the shipped code.

Host-crash fidelity: :class:`HostCrashDisk` wraps ``os.fsync`` to
record each file's last durable size, so a model can crash a node at a
schedule-chosen point and reopen its directory AS A HOST CRASH WOULD
LEAVE IT — flushed-but-unfsynced bytes gone (or kept, for the kill -9
severity where the OS survives), which is exactly the distinction the
group-commit ack barrier exists for.

Models live in tests/test_torch_netsim*.py (the ``netsim`` pytest
marker); this module is stdlib-only.
"""

from __future__ import annotations

import os
import socket as _socket_module
import stat as _stat
import threading
import time
from typing import Callable, Dict, Optional

from redisson_tpu_torch.analysis import explorer

# ---------------------------------------------------------------------------
# simulated sockets
# ---------------------------------------------------------------------------


class _Pipe:
    """One direction of a connection: a FIFO of sendall chunks.

    ``ready_at`` gates the WHOLE pipe (a deferred delivery holds every
    later chunk behind it — per-link FIFO survives fault injection);
    ``eof`` models a clean FIN, ``reset`` an abortive RST."""

    __slots__ = ("chunks", "eof", "reset", "ready_at", "cv")

    def __init__(self):
        self.chunks: list = []
        self.eof = False
        self.reset = False
        self.ready_at = 0.0
        # Created inside the explored body: under explore() this is the
        # cooperative Condition, so recv blocks schedulably.
        self.cv = threading.Condition()


class SimSocket:
    """The socket surface the shipped wire code actually uses.

    ``sendall`` appends to the peer's inbound pipe (with fault
    decisions), ``recv`` blocks cooperatively until bytes/EOF/RST/
    timeout.  Everything else is the minimal no-op surface
    (``setsockopt``, ``fileno``, addresses)."""

    _fileno_seq = 1000

    def __init__(self, net: "Net", laddr, raddr, inbound: _Pipe,
                 outbound: _Pipe, droppable: bool = True):
        self._net = net
        self._laddr = laddr
        self._raddr = raddr
        self._in = inbound
        self._out = outbound
        self._timeout: Optional[float] = None
        self._closed = False
        self._droppable = droppable
        SimSocket._fileno_seq += 1
        self._fileno = SimSocket._fileno_seq
        self.peer: Optional["SimSocket"] = None  # set by _make_pair

    # -- the data path ------------------------------------------------------

    def sendall(self, data) -> None:
        if self._closed:
            raise OSError("netsim: send on closed socket")
        out = self._out
        if out.reset or out.eof:
            raise BrokenPipeError("netsim: peer gone")
        if self._droppable and self._net.drop_budget > 0:
            if explorer.decide(2, "netsim.drop") == 1:
                self._net.drop_budget -= 1
                self.abort()
                raise ConnectionResetError(
                    "netsim: injected connection drop"
                )
        with out.cv:
            if self._droppable and self._net.defer_budget > 0:
                if explorer.decide(2, "netsim.defer") == 1:
                    self._net.defer_budget -= 1
                    out.ready_at = max(
                        out.ready_at,
                        time.monotonic() + self._net.defer_s,
                    )
            out.chunks.append(bytes(data))
            out.cv.notify_all()

    def recv(self, n: int) -> bytes:
        if self._closed:
            raise OSError("netsim: recv on closed socket")
        pipe = self._in
        deadline = (
            time.monotonic() + self._timeout
            if self._timeout is not None else None
        )
        with pipe.cv:
            while True:
                if pipe.reset:
                    raise ConnectionResetError("netsim: connection reset")
                now = time.monotonic()
                if pipe.chunks and now >= pipe.ready_at:
                    chunk = pipe.chunks[0]
                    if len(chunk) <= n:
                        pipe.chunks.pop(0)
                        return chunk
                    pipe.chunks[0] = chunk[n:]
                    return chunk[:n]
                if pipe.eof and not pipe.chunks:
                    return b""
                wait = None
                if pipe.chunks:  # gated by a deferred delivery
                    wait = pipe.ready_at - now
                if deadline is not None:
                    remain = deadline - now
                    if remain <= 0:
                        raise _socket_module.timeout("netsim: timed out")
                    wait = remain if wait is None else min(wait, remain)
                pipe.cv.wait(wait)

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with self._out.cv:
            self._out.eof = True
            self._out.cv.notify_all()

    def abort(self) -> None:
        """RST both directions (drop/crash injection): pending data is
        discarded, both ends' blocked recv/send fail with OSError."""
        for pipe in (self._in, self._out):
            with pipe.cv:
                pipe.reset = True
                pipe.chunks.clear()
                pipe.cv.notify_all()
        self._closed = True
        if self.peer is not None:
            self.peer._closed = True

    # -- misc socket protocol ----------------------------------------------

    def settimeout(self, t) -> None:
        self._timeout = None if t is None else float(t)

    def gettimeout(self):
        return self._timeout

    def setsockopt(self, *a) -> None:
        pass

    def fileno(self) -> int:
        return self._fileno

    def getsockname(self):
        return self._laddr

    def getpeername(self):
        return self._raddr

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<SimSocket {self._laddr}->{self._raddr}>"


# The import-time reals, for restore_patches(): a failing schedule
# (ScheduleFailure/ScheduleOverrun) abandons the explored body WITHOUT
# unwinding its `with Net()`/`with HostCrashDisk()`, so the patches can
# outlive the run and must be droppable from outside the body.
_REAL_CREATE_CONNECTION = _socket_module.create_connection
_REAL_FSYNC = os.fsync


def restore_patches() -> None:
    """Drop any live netsim patch (``socket.create_connection``,
    ``os.fsync``).

    Model-check harness teardown (an autouse fixture in the netsim test
    modules): the context managers' ``__exit__`` cannot run when a
    schedule failure kills the body's actors mid-``with``, and a leaked
    sim patch makes every later REAL dial in this process raise
    ConnectionRefusedError."""
    _socket_module.create_connection = _REAL_CREATE_CONNECTION
    os.fsync = _REAL_FSYNC


class _Node:
    __slots__ = ("addr", "handler", "alive", "threads", "socks", "name")

    def __init__(self, addr, handler, name):
        self.addr = addr
        self.handler = handler
        self.name = name
        self.alive = True
        self.threads: list = []  # handler ExpThreads (crash kill targets)
        self.socks: list = []    # server-side SimSockets


class Net:
    """The simulated network: a registry of listening nodes plus the
    ``socket.create_connection`` patch.  Use as a context manager
    INSIDE the explored body::

        def model():
            with Net() as net:
                net.listen(("a", 1), handler_a)
                ...real client code dials ("a", 1)...
        explore(model)
    """

    def __init__(self, *, drop_budget: int = 0, defer_budget: int = 0,
                 defer_s: float = 0.05):
        self._nodes: Dict[tuple, _Node] = {}
        self.drop_budget = int(drop_budget)
        self.defer_budget = int(defer_budget)
        self.defer_s = float(defer_s)
        self._saved_cc = None
        # actor -> owning node, so an outbound dial made FROM a
        # node's handler (the door's migration sockets, the pump's
        # control conn) is attributed to that node and crash() RSTs
        # it like every other connection touching the node.
        self._actor_node: Dict[object, _Node] = {}

    # -- patch management ---------------------------------------------------

    def __enter__(self) -> "Net":
        cur = _socket_module.create_connection
        if getattr(cur, "__func__", None) is Net._create_connection:
            # A previous schedule was abandoned mid-body (its __exit__
            # never ran): never chain the leaked patch as "the
            # original", or it survives every later restore.
            cur = _REAL_CREATE_CONNECTION
        self._saved_cc = cur
        _socket_module.create_connection = self._create_connection
        return self

    def __exit__(self, *exc) -> bool:
        cur = _socket_module.create_connection
        # Compare via __func__: `cur is self._create_connection` is
        # always False (attribute access mints a fresh bound method).
        if getattr(cur, "__func__", None) is Net._create_connection:
            _socket_module.create_connection = self._saved_cc
        return False

    # -- topology -----------------------------------------------------------

    def listen(self, addr, handler: Callable, name: Optional[str] = None
               ) -> None:
        """Register a node: ``handler(sock, peer_addr)`` runs as a new
        simulated thread per inbound connection."""
        addr = tuple(addr)
        self._nodes[addr] = _Node(addr, handler, name or "%s:%s" % addr)

    def crash(self, addr) -> None:
        """Kill the node at ``addr`` mid-protocol: every connection
        touching it resets (peers see ECONNRESET / EOF-less failure,
        exactly what a died process looks like on the wire) and every
        handler actor dies at its next sync point.  The node refuses
        new connections until :meth:`restart`."""
        node = self._nodes[tuple(addr)]
        node.alive = False
        for sock in node.socks:
            sock.abort()
        node.socks = []
        for t in node.threads:
            explorer.kill(t)
        node.threads = []

    def restart(self, addr, handler: Optional[Callable] = None) -> None:
        """Bring a crashed node's listener back (a fresh process: the
        model decides what state survived — typically whatever its
        on-disk tier recovered)."""
        node = self._nodes[tuple(addr)]
        if handler is not None:
            node.handler = handler
        node.alive = True

    def alive(self, addr) -> bool:
        node = self._nodes.get(tuple(addr))
        return node is not None and node.alive

    # -- the seam -----------------------------------------------------------

    def _create_connection(self, address, timeout=None,
                           source_address=None, **kw) -> SimSocket:
        addr = (address[0], int(address[1]))
        node = self._nodes.get(addr)
        if node is None or not node.alive:
            raise ConnectionRefusedError(
                f"netsim: no listener at {addr} "
                f"({'crashed' if node is not None else 'unknown'})"
            )
        a2b, b2a = _Pipe(), _Pipe()
        laddr = ("sim-client", SimSocket._fileno_seq + 1)
        client = SimSocket(self, laddr, addr, inbound=b2a, outbound=a2b)
        server = SimSocket(self, addr, laddr, inbound=a2b, outbound=b2a,
                           droppable=False)
        client.peer, server.peer = server, client
        if timeout is not None and \
                timeout is not _socket_module._GLOBAL_DEFAULT_TIMEOUT:
            client.settimeout(timeout)
        node.socks.append(server)
        dialer = self._actor_node.get(self._actor_key())
        if dialer is not None:
            # Dialed from another node's handler actor: crashing THAT
            # node must reset this outbound connection too.
            dialer.socks.append(client)
        t = threading.Thread(
            target=self._serve, args=(node, server),
            name=f"netsim-{node.name}", daemon=True,
        )
        node.threads.append(t)
        t.start()
        return client

    @staticmethod
    def _actor_key():
        """Identity of the CURRENT actor — the explorer's sim thread
        under explore(), the real thread outside it."""
        st = explorer._cur_sim()
        return st if st is not None else threading.current_thread()

    def _serve(self, node: _Node, sock: SimSocket) -> None:
        key = self._actor_key()
        self._actor_node[key] = node
        try:
            node.handler(sock, sock.getpeername())
        except OSError:
            pass  # peer went away: a server tolerates its clients dying
        finally:
            self._actor_node.pop(key, None)
            try:
                sock.close()
            except OSError:  # pragma: no cover - defensive
                pass


# ---------------------------------------------------------------------------
# executor seam
# ---------------------------------------------------------------------------


class _SimFuture:
    __slots__ = ("_done", "_value", "_exc")

    def __init__(self):
        self._done = threading.Event()
        self._value = None
        self._exc: Optional[BaseException] = None

    def _finish(self, value=None, exc=None) -> None:
        self._value, self._exc = value, exc
        self._done.set()

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError("netsim: future not done")
        if self._exc is not None:
            raise self._exc
        return self._value


class SimThreadExecutor:
    """Drop-in for the scatter-leg ``ThreadPoolExecutor``: each submit
    runs on a fresh SIMULATED thread (the real pool's C-level queue
    would block the scheduler invisibly).  Install with
    ``client._pool = SimThreadExecutor()`` — part of the documented
    transport seam, so leg concurrency stays explorable."""

    def submit(self, fn, *args, **kwargs) -> _SimFuture:
        fut = _SimFuture()

        def run():
            try:
                fut._finish(fn(*args, **kwargs))
            except BaseException as e:  # noqa: BLE001 - future contract
                fut._finish(exc=e)

        threading.Thread(target=run, daemon=True).start()
        return fut

    def shutdown(self, wait: bool = True) -> None:
        pass


class InlineExecutor:
    """Sequential executor seam (no leg concurrency — for models where
    the interleaving under test lives elsewhere)."""

    def submit(self, fn, *args, **kwargs) -> _SimFuture:
        fut = _SimFuture()
        try:
            fut._finish(fn(*args, **kwargs))
        except BaseException as e:  # noqa: BLE001 - future contract
            fut._finish(exc=e)
        return fut

    def shutdown(self, wait: bool = True) -> None:
        pass


# ---------------------------------------------------------------------------
# host-crash disk model
# ---------------------------------------------------------------------------


class HostCrashDisk:
    """Record what ``os.fsync`` made durable, so a model can crash a
    node and reopen its files as a crash would leave them.

    Two severities (a schedule decision in the models):

    - ``crash(dir, keep_written=True)`` — process kill -9: the OS
      survives, so every flushed byte is still there (including a torn
      half-frame); only unflushed userspace buffers are lost (they
      were never in the file).
    - ``crash(dir, keep_written=False)`` — host power loss: each file
      truncates back to its last fsynced size, files never fsynced
      vanish.  This is the severity the group-commit ack barrier is
      FOR: an ack that raced ahead of its fsync loses its record here.
    """

    def __init__(self):
        self._sizes: Dict[int, int] = {}  # inode -> last fsynced size
        self._saved = None

    def __enter__(self) -> "HostCrashDisk":
        cur = os.fsync
        if getattr(cur, "_netsim_recording", False):
            # A previous schedule was abandoned mid-body: never chain
            # the leaked wrapper as "the original".
            cur = _REAL_FSYNC
        self._saved = cur
        real = self._saved
        sizes = self._sizes

        def recording_fsync(fd):
            real(fd)
            st = os.fstat(fd)
            if _stat.S_ISREG(st.st_mode):
                sizes[st.st_ino] = st.st_size

        recording_fsync._netsim_recording = True
        os.fsync = recording_fsync
        return self

    def __exit__(self, *exc) -> bool:
        if self._saved is not None:
            os.fsync = self._saved
        return False

    def crash(self, directory: str, keep_written: bool) -> None:
        for fn in sorted(os.listdir(directory)):
            path = os.path.join(directory, fn)
            st = os.stat(path)
            if not _stat.S_ISREG(st.st_mode):
                continue
            durable = self._sizes.get(st.st_ino)
            if keep_written:
                continue  # kill -9: the page cache survives
            if durable is None:
                os.unlink(path)  # never fsynced: gone with the host
            elif st.st_size > durable:
                with open(path, "r+b") as f:
                    f.truncate(durable)


__all__ = [
    "HostCrashDisk",
    "InlineExecutor",
    "Net",
    "SimSocket",
    "SimThreadExecutor",
    "restore_patches",
]
