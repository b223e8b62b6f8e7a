"""Per-core front door — SO_REUSEPORT server processes with an in-node
slot→process map; the port's copy of ``redisson_tpu/serve/multicore.py``.

One process's front door tops out at one GIL.  The fix is the cluster
trick applied recursively INSIDE one node: K cooperating server
**processes** share one listen port via ``SO_REUSEPORT`` (the kernel
load-balances accepts), and the node's slot range is partitioned
contiguously across them behind an in-node slot→process map.  On a CUDA
node each worker holds its own context over its contiguous 1/K of the
cards, given as its ``device_indices`` (``worker_device_indices``); with
fewer cards than workers they all share ``cuda:0``.

Routing rules:

* **keyless** commands (PING, INFO, CONFIG, SUBSCRIBE, ...) are served
  by whichever worker the connection landed on;
* **worker-local** keyed commands (every key's slot owned by this
  worker) dispatch inline, exactly as a single-process door would;
* a keyed command owned by a **sibling** worker takes a loopback
  in-node handoff: the command is proxied verbatim over a persistent
  unix-domain socket to the owning worker and the reply frame is
  relayed byte-for-byte — invisible to the client.  The in-node map
  itself NEVER emits -MOVED: only the owning worker's own cluster door
  (which sees the command after the handoff) can redirect, so redirects
  always describe the cluster topology, never node internals;
* **splittable** multi-key commands (MGET / MSET / DEL / EXISTS)
  spanning workers split per key, execute on each owner, and merge
  (array order / sums / OK) — byte-identical to the single-process
  reply;
* **fan-out** keyspace commands broadcast to every worker and merge:
  PUBLISH and DBSIZE sum integer replies, FLUSHALL acks once all
  workers acked, KEYS concatenates; SCRIPT LOAD|FLUSH and FUNCTION
  LOAD|DELETE|FLUSH ack once every worker's registry took them (a
  script handed to its keys' owner must find what the client loaded);
* any other multi-key command spanning workers gets -CROSSSLOT (the
  same key-discipline the cluster door enforces across nodes — use
  hash tags to co-locate);
* a script's ``redis.call`` runs under its worker's grid lock, so it is
  never handed off: one that needs a sibling gets -CROSSSLOT (a leg
  waiting on a sibling whose own script waits back would deadlock).

Known worker-local views (documented, not bugs): SCAN cursors and
RANDOMKEY enumerate the landing worker's slice, MONITOR streams the
landing worker's dispatches only, and SCRIPT KILL / SCRIPT EXISTS see
the landing worker's scripts.
"""

from __future__ import annotations

import logging
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

from redisson_tpu_torch.analysis import witness as _witness
from redisson_tpu_torch import chaos
from redisson_tpu_torch.cluster.slots import NSLOTS, command_keys, key_slot
from redisson_tpu_torch.config import device_slice
from redisson_tpu_torch.serve import wireutil

log = logging.getLogger("redisson_tpu_torch.frontdoor")

# Commands broadcast to every worker (merge rule in _fanout): integer
# replies sum, FLUSHALL acks, KEYS concatenates.
_FANOUT_SUM = frozenset(("PUBLISH", "DBSIZE"))
_FANOUT = _FANOUT_SUM | frozenset(("FLUSHALL", "KEYS"))
# Registry admin broadcast by subcommand: every worker acks, the landing
# worker's reply is relayed.
_FANOUT_SUB = {
    "SCRIPT": frozenset((b"LOAD", b"FLUSH")),
    "FUNCTION": frozenset((b"LOAD", b"DELETE", b"FLUSH")),
}
# Per-key splittable multi-key commands: a span across workers splits
# into per-worker legs and merges byte-identically.
_SPLIT = frozenset(("MGET", "MSET", "DEL", "EXISTS"))

# Keep peer sockets bounded: idle legs beyond this per target close
# instead of repooling (each pooled leg is one fd on BOTH workers).
_POOL_CAP = 16


def reuseport_available() -> bool:
    """Probe SO_REUSEPORT by actually setting it on a throwaway socket —
    the constant existing in the socket module does not mean the kernel
    accepts it (never a crash at bind time)."""
    if not hasattr(socket, "SO_REUSEPORT"):
        return False
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        finally:
            s.close()
        return True
    except OSError:
        return False


def effective_processes(requested) -> int:
    """The fallback contract: K > 1 on a platform without
    SO_REUSEPORT degrades to the single-process door with ONE logged
    INFO frontdoor line — never a crash at bind time.  (The caller's
    RespServer then publishes rtpu_frontdoor_processes = 1.)"""
    k = max(1, int(requested or 1))
    if k > 1 and not reuseport_available():
        log.info(
            "frontdoor: SO_REUSEPORT unavailable on this platform — "
            "serving with a single-process front door instead of the "
            "requested %d workers", k,
        )
        return 1
    return k


def device_slice_for_worker(index: int, nworkers: int,
                            ndevices: int) -> Optional[list]:
    """Contiguous per-worker device-index slice (the device analog of
    the slot partition).  None when the node has fewer devices than
    workers — then every worker shares the default enumeration (the
    CPU-backend test shape)."""
    return device_slice(index, nworkers, ndevices)


def worker_device_indices(device: str, index: int, nworkers: int,
                          ndevices: int) -> Optional[list]:
    """The ``device_indices`` worker ``index`` of ``nworkers`` serves
    from: its whole slice on a CUDA node with at least one card per
    worker (the sharded executor places its shards over all of it, the
    single-device one holds the first); None — the configured device,
    shared — on the CPU, for an explicit card or with fewer cards."""
    if not device.startswith("cuda") or ":" in device:
        return None
    return device_slice_for_worker(index, nworkers, ndevices)


def worker_device(device: str, index: int, nworkers: int,
                  ndevices: int) -> str:
    """The device worker ``index`` of ``nworkers`` serves from: on a
    CUDA node with at least one card per worker, ``cuda:<lo>`` of its
    slice (the executor holds one device, the first of the slice);
    otherwise ``device`` unchanged — every worker shares the default
    card (or the CPU)."""
    if not device.startswith("cuda") or ":" in device:
        return device
    sl = device_slice_for_worker(index, nworkers, ndevices)
    return device if sl is None else f"cuda:{sl[0]}"


def worker_of_slot(slot: int, nworkers: int) -> int:
    """Fixed contiguous slot partition: worker ``slot * K // NSLOTS``.
    Stable under cluster migration — the in-node map depends only on
    (slot, K), never on which slots the node currently owns."""
    return slot * nworkers // NSLOTS


def worker_slot_range(w: int, nworkers: int) -> tuple:
    """Inclusive (lo, hi) slot range owned by worker ``w``."""
    lo = (w * NSLOTS + nworkers - 1) // nworkers
    hi = ((w + 1) * NSLOTS + nworkers - 1) // nworkers - 1
    return lo, hi


def worker_tag(w: int, nworkers: int) -> str:
    """A short hash tag whose slot lands on worker ``w`` — bench/test
    clients use ``{tag}key`` keys to pin traffic to a known worker."""
    for i in range(100000):
        tag = "w%d" % i
        if worker_of_slot(key_slot(tag.encode()), nworkers) == w:
            return tag
    raise RuntimeError("no tag found (unreachable)")


def peer_sock_path(rundir: str, index: int) -> str:
    return os.path.join(rundir, f"worker-{index}.sock")


class _PeerPool:
    """Persistent unix-domain sockets to ONE sibling worker.  A leg that
    errors in any way is closed, never repooled (RT013: a desynced
    stream must not serve the next handoff)."""

    def __init__(self, path: str, connect_timeout_s: float = 15.0):
        self.path = path
        self.connect_timeout_s = connect_timeout_s
        self._free: list = []
        self._lock = _witness.named(threading.Lock(), "serve.multicore.pool")
        self.closed = False

    def get(self) -> socket.socket:
        with self._lock:
            if self._free:
                return self._free.pop()
        # Workers start concurrently: the sibling's listener may not be
        # bound yet on the first handoff — retry within the deadline.
        deadline = time.monotonic() + self.connect_timeout_s
        while True:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                s.connect(self.path)
                return s
            except OSError:
                s.close()
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)

    def put(self, s: socket.socket) -> None:
        with self._lock:
            if not self.closed and len(self._free) < _POOL_CAP:
                self._free.append(s)
                return
        try:
            s.close()
        except OSError:
            pass

    def close_all(self) -> None:
        with self._lock:
            self.closed = True
            socks, self._free = self._free, []
        for s in socks:
            try:
                s.close()
            except OSError:
                pass


class MulticoreRouter:
    """The in-node slot→process map of ONE front-door worker: decides
    local vs handoff vs split vs fan-out for every dispatched command,
    serves sibling handoff legs on a unix-domain listener, and owns the
    peer socket pools."""

    def __init__(self, server, nworkers: int, index: int, rundir: str,
                 obs=None):
        if not rundir:
            raise ValueError("multicore worker mode requires frontdoor_dir")
        self.server = server
        self.nworkers = int(nworkers)
        self.index = int(index)
        if not (0 <= self.index < self.nworkers):
            raise ValueError(
                f"frontdoor_index {index} out of range for "
                f"{nworkers} workers"
            )
        self.rundir = rundir
        self.obs = obs
        self._closed = False
        self._pools = {
            w: _PeerPool(peer_sock_path(rundir, w))
            for w in range(self.nworkers)
            if w != self.index
        }
        # Lifetime counters (INFO frontdoor; obs mirrors them as the
        # rtpu_frontdoor_* families).  Ints bumped under the GIL.
        self.n_forward = 0
        self.n_split = 0
        self.n_fanout = 0
        self.n_errors = 0
        # Chaos injection at the handoff leg (the soak's error arm):
        # workers are subprocesses, so the rule arrives by env var and
        # feeds the standard deterministic chaos engine.
        rate = os.environ.get("RTPU_CHAOS_HANDOFF")
        if rate:
            chaos.inject(
                "handoff.leg", kind="error", rate=float(rate),
                seed=int(os.environ.get("RTPU_CHAOS_HANDOFF_SEED", "0") or 0),
            )
        # Serve sibling legs: a private unix listener per worker.  Peer
        # connections are admitted outside max_connections (refusing one
        # would wedge the sibling's forwarded client command).
        path = peer_sock_path(rundir, self.index)
        try:
            os.unlink(path)
        except OSError:
            pass
        self._lsock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._lsock.bind(path)
        self._lsock.listen(128)
        self._accept_thread = threading.Thread(
            target=self._peer_accept_loop,
            name="rtpu-frontdoor-peer-accept", daemon=True,
        )
        self._accept_thread.start()
        events = getattr(obs, "events", None)
        if events is not None:
            # Self-announce: the parent is a pure supervisor with no
            # obs ring, so each worker records its own spawn (and
            # siblings record deaths via dead peer listeners).
            events.emit("multicore.worker.spawn", index=self.index,
                        nworkers=self.nworkers, pid=os.getpid())

    # -- routing decisions ---------------------------------------------------

    def wrong_worker_keys(self, cmd) -> bool:
        keys = command_keys(cmd)
        if not keys:
            return False
        me = self.index
        n = self.nworkers
        for k in keys:
            if key_slot(k) * n // NSLOTS != me:
                return True
        return False

    @staticmethod
    def _is_fanout(name: str, cmd) -> bool:
        if name in _FANOUT:
            return True
        subs = _FANOUT_SUB.get(name)
        return subs is not None and len(cmd) > 1 and cmd[1].upper() in subs

    def needs_handoff(self, cmd) -> bool:
        """Reactor detach check: True when dispatching ``cmd`` may block
        on a sibling worker (handoff/split/fan-out legs) — it must ride
        a worker thread, never the event loop."""
        name = cmd[0].decode("latin-1", "replace").upper()
        if self._is_fanout(name, cmd):
            return True
        return self.wrong_worker_keys(cmd)

    def route(self, name: str, cmd, ctx) -> Optional[bytes]:
        """The _dispatch hook: a reply frame to relay to the client, or
        None to serve locally.  Runs BEFORE the cluster door, so a
        handed-off command is judged by the slot OWNER's door (the
        in-node map never emits -MOVED)."""
        if ctx.is_peer:
            # A sibling already routed this leg here: always local (the
            # no-proxy-loops invariant).
            return None
        if getattr(ctx, "in_script", False):
            # redis.call under this worker's grid lock: never a leg.
            if self.needs_handoff(cmd):
                raise self._crossslot()
            return None
        if self._is_fanout(name, cmd):
            return self._fanout(name, cmd, ctx)
        keys = command_keys(cmd)
        if not keys:
            return None
        me = self.index
        n = self.nworkers
        owners = {key_slot(k) * n // NSLOTS for k in keys}
        if owners == {me}:
            return None
        if len(owners) == 1:
            self.n_forward += 1
            self._count("forward")
            return self._forward(owners.pop(), cmd, ctx)
        if name in _SPLIT:
            self.n_split += 1
            self._count("split")
            return self._split(name, cmd, ctx)
        raise self._crossslot()

    @staticmethod
    def _crossslot():
        from redisson_tpu_torch.serve.resp import RespError

        return RespError(
            "CROSSSLOT Keys in request don't hash to the same "
            "front-door worker (use hash tags to co-locate them)"
        )

    # -- the handoff leg -----------------------------------------------------

    def _exchange_frames(self, w: int, cmds) -> list:
        """Ship ``cmds`` to sibling ``w`` over a pooled leg and return
        the raw reply frames VERBATIM (byte-identical relay is the
        differential soak's contract)."""
        payload = b"".join(wireutil.wire_command(c) for c in cmds)
        pool = self._pools[w]
        sock = pool.get()
        ok = False
        try:
            if chaos.ENABLED:
                chaos.fire("handoff.leg")
            sock.sendall(payload)
            frames: list = []
            buf = b""
            pos = 0
            while len(frames) < len(cmds):
                try:
                    end = wireutil.skip_reply_frame(buf, pos)
                except IndexError:
                    chunk = sock.recv(1 << 16)
                    if not chunk:
                        raise OSError("peer worker closed mid-reply")
                    buf += chunk
                    continue
                except ValueError as e:
                    raise OSError(f"corrupt handoff stream: {e}")
                frames.append(buf[pos:end])
                pos = end
            ok = True
            return frames
        finally:
            if ok:
                pool.put(sock)
            else:
                # RT013: the failed leg's socket may hold a half reply —
                # never repool it.
                try:
                    sock.close()
                except OSError:
                    pass

    def _broken(self, kind: str, w, exc) -> bytes:
        from redisson_tpu_torch.serve.resp import _encode_error

        self.n_errors += 1
        if self.obs is not None:
            self.obs.frontdoor_handoff_errors.inc((kind,))
            events = getattr(self.obs, "events", None)
            if events is not None:
                events.emit("multicore.handoff.broken", severity="warn",
                            kind=kind, worker=str(w), error=str(exc))
                if isinstance(exc, (ConnectionRefusedError,
                                    FileNotFoundError)):
                    # The sibling's unix listener is GONE (not merely a
                    # broken stream): the worker itself died.
                    events.emit("multicore.worker.death",
                                severity="error", worker=str(w))
        return _encode_error(
            f"HANDOFFBROKEN in-node {kind} leg to worker {w} failed "
            f"({exc}); retry"
        )

    def _forward(self, w: int, cmd, ctx) -> bytes:
        cmds = [cmd]
        if ctx.asking:
            # The one-shot ASKING grant must travel WITH the command to
            # the owning worker (its door is the one honoring it).
            ctx.asking = False
            cmds = [[b"ASKING"], cmd]
        try:
            return self._exchange_frames(w, cmds)[-1]
        except (OSError, chaos.FaultInjected) as e:
            return self._broken("forward", w, e)

    # -- split / fan-out merges ---------------------------------------------

    def _split(self, name: str, cmd, ctx) -> bytes:
        """Per-key split of MGET/MSET/DEL/EXISTS across workers, merged
        byte-identically to the single-process reply."""
        from redisson_tpu_torch.serve.resp import _encode_int, _encode_simple

        step = 2 if name == "MSET" else 1
        groups: dict = {}  # worker -> [(position, key-args slice)]
        args = cmd[1:]
        for pos in range(0, len(args), step):
            w = worker_of_slot(key_slot(args[pos]), self.nworkers)
            groups.setdefault(w, []).append((pos // step, args[pos:pos + step]))
        legs: dict = {}  # worker -> raw reply frame
        cname = cmd[0]
        for w, items in groups.items():
            sub = [cname] + [a for _, chunk in items for a in chunk]
            if w == self.index:
                # Local leg re-enters _dispatch (its keys are now all
                # local, so the hook passes it through).
                legs[w] = self.server._dispatch(sub, ctx, name=name)
            else:
                try:
                    legs[w] = self._exchange_frames(w, [sub])[0]
                except (OSError, chaos.FaultInjected) as e:
                    return self._broken("split", w, e)
        for f in legs.values():
            if f.startswith(b"-"):
                return f  # relay the first error leg verbatim
        if name == "MSET":
            return _encode_simple("OK")
        if name in ("DEL", "EXISTS"):
            return _encode_int(sum(int(f[1:-2]) for f in legs.values()))
        # MGET: scatter the per-leg array items back to request order.
        out: list = [None] * ((len(args) + step - 1) // step)
        for w, items in groups.items():
            vals, _ = wireutil.decode_reply(legs[w])
            for (pos, _chunk), v in zip(items, vals):
                out[pos] = v
        return wireutil.encode_reply(out)

    def _fanout(self, name: str, cmd, ctx) -> bytes:
        from redisson_tpu_torch.serve.resp import _encode_int

        self.n_fanout += 1
        self._count("fanout")
        local = self.server._invoke_handler(name, cmd, ctx)
        legs: list = []
        for w in range(self.nworkers):
            if w == self.index:
                continue
            try:
                legs.append(self._exchange_frames(w, [cmd])[0])
            except (OSError, chaos.FaultInjected) as e:
                return self._broken("fanout", w, e)
        for f in legs:
            if f.startswith(b"-"):
                return f
        if name in _FANOUT_SUM:
            total = int(local[1:-2])
            for f in legs:
                total += int(f[1:-2])
            return _encode_int(total)
        if name == "KEYS":
            merged, _ = wireutil.decode_reply(local)
            for f in legs:
                vals, _ = wireutil.decode_reply(f)
                merged.extend(vals)
            return wireutil.encode_reply(merged)
        return local  # FLUSHALL and registry admin: every worker acked

    # -- peer serving / lifecycle -------------------------------------------

    def _count(self, kind: str) -> None:
        if self.obs is not None:
            self.obs.frontdoor_handoffs.inc((kind,))

    def handoff_count(self) -> int:
        return self.n_forward + self.n_split + self.n_fanout

    def _peer_accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return
            self.server._admit_peer(conn)

    def info_lines(self) -> list:
        return [
            f"frontdoor_handoffs_forward:{self.n_forward}",
            f"frontdoor_handoffs_split:{self.n_split}",
            f"frontdoor_handoffs_fanout:{self.n_fanout}",
            f"frontdoor_handoff_errors:{self.n_errors}",
        ]

    def close(self) -> None:
        self._closed = True
        try:
            self._lsock.close()
        except OSError:
            pass
        try:
            os.unlink(peer_sock_path(self.rundir, self.index))
        except OSError:
            pass
        for pool in self._pools.values():
            pool.close_all()


# -- process topology (the node parent) --------------------------------------


def _free_port(host: str) -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, 0))
        return s.getsockname()[1]
    finally:
        s.close()


class MulticoreNode:
    """Spawn and own K front-door worker processes sharing ONE listen
    port via SO_REUSEPORT.  The parent is a pure supervisor: it owns no
    engine, forwards shutdown, and reaps the workers.  Each worker is
    ``python -m redisson_tpu_torch --device <device>``; a ``cuda`` worker
    that finds no card exits non-zero and startup reports its log."""

    def __init__(self, nworkers: int, host: str = "127.0.0.1",
                 port: int = 0, device: str = "cuda",
                 rundir: Optional[str] = None,
                 metrics_port: Optional[int] = None,
                 extra_args=(), env_extra=None,
                 startup_timeout_s: float = 120.0):
        if nworkers < 2:
            raise ValueError("MulticoreNode wants nworkers >= 2")
        if not reuseport_available():
            raise RuntimeError("SO_REUSEPORT unavailable on this platform")
        self.nworkers = int(nworkers)
        self.host = host
        self.port = int(port) or _free_port(host)
        self.rundir = rundir or tempfile.mkdtemp(prefix="rtpu-frontdoor-")
        self._own_rundir = rundir is None
        self.metrics_ports = (
            [metrics_port + 1 + i for i in range(self.nworkers)]
            if metrics_port else []
        )
        self.procs: list = []
        env = dict(os.environ)
        env.update(env_extra or {})
        try:
            for i in range(self.nworkers):
                logf = open(
                    os.path.join(self.rundir, f"worker{i}.log"), "wb"
                )
                argv = [
                    sys.executable, "-m", "redisson_tpu_torch",
                    "--host", host, "--port", str(self.port),
                    "--device", device,
                    "--frontdoor-workers", str(self.nworkers),
                    "--frontdoor-index", str(i),
                    "--frontdoor-dir", self.rundir,
                ]
                if self.metrics_ports:
                    argv += ["--metrics-port", str(self.metrics_ports[i])]
                self.procs.append(subprocess.Popen(
                    argv + list(extra_args),
                    stdout=logf, stderr=subprocess.STDOUT, env=env,
                ))
                logf.close()  # the child holds its own fd now
            self._await_ready(startup_timeout_s)
        except Exception:
            self.shutdown(timeout_s=2.0)
            raise

    def _await_ready(self, timeout_s: float) -> None:
        """PING every worker over ITS unix peer socket — the TCP port
        cannot address one worker (the kernel picks), the peer listener
        can."""
        deadline = time.monotonic() + timeout_s
        for i in range(self.nworkers):
            path = peer_sock_path(self.rundir, i)
            while True:
                if self.procs[i].poll() is not None:
                    raise RuntimeError(
                        f"front-door worker {i} exited rc="
                        f"{self.procs[i].returncode} during startup; see "
                        f"{self.rundir}/worker{i}.log"
                    )
                try:
                    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                    try:
                        s.settimeout(2.0)
                        s.connect(path)
                        if wireutil.exchange(s, [[b"PING"]])[0] == b"PONG":
                            break
                    finally:
                        s.close()
                # rtpulint: disable=RT013 per-attempt probe socket: created and closed inside this try (the finally above), never pooled or reused — no reply bytes can survive into a later exchange
                except (OSError, ValueError):
                    pass
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"front-door worker {i} not serving after "
                        f"{timeout_s:.0f}s; see {self.rundir}/worker{i}.log"
                    )
                time.sleep(0.1)

    def shutdown(self, timeout_s: float = 10.0) -> bool:
        """SIGTERM each worker, escalate to SIGKILL at the deadline.
        True when every worker exited on its own (the clean path)."""
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        clean = True
        deadline = time.monotonic() + timeout_s
        for p in self.procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                clean = False
                try:
                    p.kill()
                    p.wait(timeout=5.0)
                except (OSError, subprocess.TimeoutExpired):
                    pass
        if self._own_rundir:
            shutil.rmtree(self.rundir, ignore_errors=True)
        return clean
