"""Process supervisor — spawn, join, migrate across, and cleanly tear
down an N-node cluster.

Each node is a full ``python -m redisson_tpu_torch --device <device>``
server process (its own engine, reactor door, GIL and CUDA context —
N nodes on a one-card host all serve from ``cuda:0``), booted with a
shared topology file that partitions the 16384 slots contiguously.
Production deployments run the same CLI flags under their own process
manager.  ``device="cuda"`` is the default: a node that finds no card
exits 2 and ``start`` raises naming it — a fleet never falls back to
the CPU on its own (``device="cpu"`` asks for it).

``migrate_slot`` is the live-resharding coordinator (the redis-cli --cluster
reshard analog): IMPORTING on the target, MIGRATING on the source, a
``GETKEYSINSLOT``/``MIGRATE`` pump until the slot is empty, then
``SETSLOT NODE`` broadcast to every node.  Per-key atomicity lives in
the source's move guard (cluster/door.py) — the coordinator can die
at any step and the slot stays serveable (source keeps ownership until
the final SETSLOT NODE).

The port's copy of ``redisson_tpu/cluster/supervisor.py``, byte formats and
semantics unchanged; its locks are plain ``threading`` locks (the JAX
package wraps them in its lock-order witness).
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

from redisson_tpu_torch.analysis import witness as _witness
from redisson_tpu_torch.cluster.slots import NSLOTS
from redisson_tpu_torch.serve.wireutil import ReplyError, exchange


def _log_tail(path: str, nbytes: int = 2000) -> str:
    """The last ``nbytes`` of a child's log, for a startup error that
    names its own cause."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - nbytes))
            return f.read().decode("utf-8", "replace")
    except OSError as e:
        return f"(unreadable: {e})"


def _request(addr, cmds, timeout_s=10.0):
    """One short-lived control connection: send ``cmds`` pipelined,
    return decoded replies (control traffic — not the data path)."""
    sock = socket.create_connection(addr, timeout=timeout_s)
    try:
        return exchange(sock, cmds)
    finally:
        sock.close()


def _check(reply, what: str):
    if isinstance(reply, ReplyError):
        raise RuntimeError(f"{what} failed: {reply}")
    return reply


def migrate_slot(slot: int, src_addr, dst_addr, notify=(),
                 batch: int = 64, timeout_s: float = 10.0) -> int:
    """Live-migrate one slot from ``src_addr`` to ``dst_addr`` while
    both keep serving.  ``notify`` lists OTHER nodes' addresses to
    teach the final ownership (they would otherwise keep emitting stale
    MOVED until a client refresh bounced off the new owner).  Returns
    the number of keys moved."""
    src_id = _check(
        _request(src_addr, [[b"CLUSTER", b"MYID"]], timeout_s)[0],
        "CLUSTER MYID (source)",
    ).decode()
    dst_id = _check(
        _request(dst_addr, [[b"CLUSTER", b"MYID"]], timeout_s)[0],
        "CLUSTER MYID (target)",
    ).decode()
    sslot = b"%d" % slot
    # Pre-flight BEFORE any migration state exists: a slot holding an
    # unmigratable container kind refuses cleanly (docs/clustering.md)
    # instead of aborting half-pumped.  Should the coordinator die
    # mid-pump (crash, or a container created after this check), the
    # slot stays fully serveable — present keys serve on the source,
    # moved keys via -ASK to the target — and re-running migrate_slot
    # resumes the pump (every step is idempotent).
    bad = _check(_request(src_addr, [
        [b"CLUSTER", b"MIGRATABLE", sslot],
    ], timeout_s)[0], "CLUSTER MIGRATABLE")
    if bad:
        raise RuntimeError(
            f"slot {slot} refuses to migrate: {len(bad)} key(s) of "
            f"unmigratable kinds (container grid types are not "
            f"RESP-dumpable), e.g. {[k.decode() for k in bad[:3]]}"
        )
    _check(_request(dst_addr, [
        [b"CLUSTER", b"SETSLOT", sslot, b"IMPORTING", src_id.encode()],
    ], timeout_s)[0], "SETSLOT IMPORTING")
    _check(_request(src_addr, [
        [b"CLUSTER", b"SETSLOT", sslot, b"MIGRATING", dst_id.encode()],
    ], timeout_s)[0], "SETSLOT MIGRATING")
    moved = 0
    dst_host, dst_port = dst_addr
    # ONE control connection for the whole pump (a connect per key
    # would dominate the migration; the source additionally keeps its
    # own persistent socket to the target — see door._mig_exchange).
    pump = socket.create_connection(src_addr, timeout=timeout_s)
    try:
        while True:
            keys = _check(exchange(pump, [
                [b"CLUSTER", b"GETKEYSINSLOT", sslot, b"%d" % batch],
            ])[0], "GETKEYSINSLOT")
            if not keys:
                break
            for key in keys:
                r = _check(exchange(pump, [[
                    b"MIGRATE", dst_host.encode(), b"%d" % dst_port,
                    key, b"0", b"%d" % int(timeout_s * 1000),
                ]])[0], f"MIGRATE {key!r}")
                if r == b"OK":
                    moved += 1
                # NOKEY: a concurrent DEL/expiry beat the pump — fine.
    finally:
        pump.close()
    # Finalize everywhere: target first (so a MOVED emitted by a lagging
    # node points at a node that already owns the slot).
    finalize = [b"CLUSTER", b"SETSLOT", sslot, b"NODE", dst_id.encode()]
    _check(_request(dst_addr, [finalize], timeout_s)[0],
           "SETSLOT NODE (target)")
    _check(_request(src_addr, [finalize], timeout_s)[0],
           "SETSLOT NODE (source)")
    for addr in notify:
        if tuple(addr) in (tuple(src_addr), tuple(dst_addr)):
            continue
        _check(_request(tuple(addr), [finalize], timeout_s)[0],
               f"SETSLOT NODE ({addr})")
    return moved


def migrate_slots_bulk(slots, src_addr, dst_addr, notify=(),
                       batch: int = 64, chunk: int = 128,
                       timeout_s: float = 30.0) -> int:
    """Migrate MANY slots from one source to one destination — the
    join/drain workhorse.  Same five-step protocol and the
    same per-step idempotence as :func:`migrate_slot`, but amortized
    for the thousands-of-slots case: two persistent control
    connections, SETSLOT phases pipelined per ``chunk`` of slots, and
    one shared pump (which the write-time slot index makes O(keys in
    slot) per batch instead of O(total keys)).  Empty slots — the vast
    majority in a share shift — cost two pipelined SETSLOTs, one empty
    GETKEYSINSLOT, and their share of the finalize broadcast.

    Finalize order per chunk is preserved from the single-slot pump:
    target first, then source, then the notify list — a lagging node's
    MOVED always points at a node that already owns the slot.  Returns
    total keys moved."""
    slots = list(slots)
    if not slots:
        return 0
    src_id = _check(
        _request(src_addr, [[b"CLUSTER", b"MYID"]], timeout_s)[0],
        "CLUSTER MYID (source)",
    ).decode()
    dst_id = _check(
        _request(dst_addr, [[b"CLUSTER", b"MYID"]], timeout_s)[0],
        "CLUSTER MYID (target)",
    ).decode()
    dst_host, dst_port = dst_addr
    moved = 0
    src_sock = socket.create_connection(src_addr, timeout=timeout_s)
    dst_sock = socket.create_connection(dst_addr, timeout=timeout_s)
    try:
        for i in range(0, len(slots), chunk):
            group = slots[i:i + chunk]
            bslots = [b"%d" % s for s in group]
            # Pre-flight the whole chunk before ANY migration state.
            for s, bad in zip(group, _check_all(exchange(src_sock, [
                [b"CLUSTER", b"MIGRATABLE", bs] for bs in bslots
            ]), "CLUSTER MIGRATABLE")):
                if bad:
                    raise RuntimeError(
                        f"slot {s} refuses to migrate: {len(bad)} "
                        f"key(s) of unmigratable kinds"
                    )
            _check_all(exchange(dst_sock, [
                [b"CLUSTER", b"SETSLOT", bs, b"IMPORTING",
                 src_id.encode()] for bs in bslots
            ]), "SETSLOT IMPORTING")
            _check_all(exchange(src_sock, [
                [b"CLUSTER", b"SETSLOT", bs, b"MIGRATING",
                 dst_id.encode()] for bs in bslots
            ]), "SETSLOT MIGRATING")
            for s, bs in zip(group, bslots):
                while True:
                    keys = _check(exchange(src_sock, [
                        [b"CLUSTER", b"GETKEYSINSLOT", bs, b"%d" % batch],
                    ])[0], "GETKEYSINSLOT")
                    if not keys:
                        break
                    for key in keys:
                        r = _check(exchange(src_sock, [[
                            b"MIGRATE", dst_host.encode(),
                            b"%d" % dst_port, key, b"0",
                            b"%d" % int(timeout_s * 1000),
                        ]])[0], f"MIGRATE {key!r}")
                        if r == b"OK":
                            moved += 1
            fin = [
                [b"CLUSTER", b"SETSLOT", bs, b"NODE", dst_id.encode()]
                for bs in bslots
            ]
            _check_all(exchange(dst_sock, fin), "SETSLOT NODE (target)")
            _check_all(exchange(src_sock, fin), "SETSLOT NODE (source)")
            for addr in notify:
                if tuple(addr) in (tuple(src_addr), tuple(dst_addr)):
                    continue
                _check_all(
                    _request(tuple(addr), fin, timeout_s),
                    f"SETSLOT NODE ({addr})",
                )
    finally:
        src_sock.close()
        dst_sock.close()
    return moved


def _check_all(replies, what: str):
    for r in replies:
        _check(r, what)
    return replies


class ClusterSupervisor:
    """Spawn and own N cluster node processes on this host."""

    def __init__(self, n_nodes: int = 3, host: str = "127.0.0.1",
                 device: str = "cuda", node_args=(), env_extra=None,
                 startup_timeout_s: float = 120.0, metrics: bool = False,
                 frontdoor_processes: int = 1,
                 replicas_per_shard: int = 0,
                 node_timeout_ms: int = 1500):
        if n_nodes < 1:
            raise ValueError("n_nodes must be >= 1")
        self.n_nodes = n_nodes
        # Replication + failover: each primary additionally
        # gets this many --replica-of processes (own snapshot/journal
        # dirs under the supervisor tmpdir; primaries get durability
        # dirs too — the replication stream is journal-fed).  Replicas
        # spawn AFTER the primaries are serving (their boot runs a
        # FULLRESYNC bootstrap against a live primary).
        self.replicas_per_shard = max(0, int(replicas_per_shard))
        self.node_timeout_ms = int(node_timeout_ms)
        self.replica_addrs: list = []  # (host, port) per replica
        self.replica_ids: list = []
        self.host = host
        self.device = device
        # Per-core front door: each node serves its shard
        # with this many SO_REUSEPORT reactor processes — the spawned
        # node process becomes a worker supervisor itself (__main__
        # handles the fan-out; no-SO_REUSEPORT platforms degrade to 1
        # per node with a logged line, so this stays safe everywhere).
        self.frontdoor_processes = max(1, int(frontdoor_processes))
        self.node_args = list(node_args)
        self.env_extra = dict(env_extra or {})
        self.startup_timeout_s = startup_timeout_s
        self._lock = _witness.named(threading.Lock(), "cluster.supervisor")
        self._procs: list = []  # subprocess.Popen, index-aligned w/ addrs
        self.addrs: list = []  # (host, port) per node
        self.node_ids: list = []
        # Elastic membership: primaries added after start()
        # append to addrs/node_ids AND to _procs, so alive()/shutdown()
        # cover them (the CI no-orphans contract).  _primary_proc_idx
        # maps an addrs index to its _procs slot (added primaries land
        # AFTER the replicas in _procs); _drained marks primaries
        # retired by drain_node (roster keeps their slot — indices stay
        # stable, like kill_node).
        self._primary_proc_idx: list = []
        self._drained: set = set()
        self._tmpdir = None
        self._started = False
        # Metrics federation: with metrics=True each node
        # additionally serves /metrics on its own reserved port
        # (metrics_addrs), and start_federation() serves ONE merged
        # exposition with a node label per member.  The port's replicas
        # serve one too (replica_metrics_addrs): an election's counters
        # live on the replica that ran it.
        self.metrics = bool(metrics)
        self.metrics_addrs: list = []  # (host, port) per node
        self.replica_metrics_addrs: list = []  # (host, port) per replica
        self._federation = None

    # -- lifecycle ---------------------------------------------------------

    @staticmethod
    @contextlib.contextmanager
    def _held_ports(host: str, n: int):
        """Yield n ephemeral ports, each kept bound (SO_REUSEADDR, never
        listening) until the block ends.  A port bound this way is never
        taken as the source port of an outgoing connect(); a port that
        was bound and closed is.  Without the hold, the fleet's own
        traffic (bus pings to a replica that does not listen yet, the
        readiness polls) can land on a child's port, even as a TCP
        self-connect, and the child's bind fails with EADDRINUSE.  The
        children bind with SO_REUSEADDR, which a bound, non-listening
        holder admits."""
        socks = []
        try:
            for _ in range(n):
                s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                socks.append(s)
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                s.bind((host, 0))
            yield [s.getsockname()[1] for s in socks]
        finally:
            for s in socks:
                s.close()

    def topology(self) -> dict:
        """Even contiguous slot partition across the primaries, plus a
        slotless role=replica entry per replica process."""
        per = NSLOTS // self.n_nodes
        nodes = []
        for i, (h, p) in enumerate(self.addrs):
            start = i * per
            end = (start + per - 1) if i < self.n_nodes - 1 else NSLOTS - 1
            nodes.append({
                "id": self.node_ids[i], "host": h, "port": p,
                "slots": [[start, end]],
            })
        for j, (h, p) in enumerate(self.replica_addrs):
            pi = j // self.replicas_per_shard
            nodes.append({
                "id": self.replica_ids[j], "host": h, "port": p,
                "slots": [], "role": "replica",
                "replica_of": self.node_ids[pi],
            })
        return {"nodes": nodes}

    def start(self) -> "ClusterSupervisor":
        if self._started:
            return self
        nreplicas = self.n_nodes * self.replicas_per_shard
        nports = (self.n_nodes + nreplicas) * (2 if self.metrics else 1)
        with self._held_ports(self.host, nports) as ports:
            return self._start_on(ports)

    def _start_on(self, ports: list) -> "ClusterSupervisor":
        nreplicas = self.n_nodes * self.replicas_per_shard
        self.addrs = [(self.host, p) for p in ports[: self.n_nodes]]
        base = self.n_nodes
        if self.metrics:
            self.metrics_addrs = [
                (self.host, p) for p in ports[base:base + self.n_nodes]
            ]
            base += self.n_nodes
        self.replica_addrs = [
            (self.host, p) for p in ports[base:base + nreplicas]
        ]
        if self.metrics:
            self.replica_metrics_addrs = [
                (self.host, p) for p in ports[base + nreplicas:]
            ]
        self.node_ids = ["node-%d-%d" % (i, p)
                         for i, p in enumerate(ports[: self.n_nodes])]
        self.replica_ids = [
            "node-%d-replica-%d-%d" % (
                j // self.replicas_per_shard,
                j % self.replicas_per_shard,
                p,
            )
            for j, (_, p) in enumerate(self.replica_addrs)
        ]
        self._tmpdir = tempfile.mkdtemp(prefix="rtpu-cluster-")
        topo_path = os.path.join(self._tmpdir, "topology.json")
        with open(topo_path, "w") as f:
            json.dump(self.topology(), f)
        # Every node serves from ``device``: N processes share one card
        # as N CUDA contexts (the cluster's win is N front doors / N
        # GILs; per-node card placement is CUDA_VISIBLE_DEVICES in
        # ``env_extra``).
        env = dict(os.environ)
        env.update(self.env_extra)
        procs = []
        try:
            for i, (h, p) in enumerate(self.addrs):
                log = open(
                    os.path.join(self._tmpdir, f"node{i}.log"), "wb"
                )
                argv = [sys.executable, "-m", "redisson_tpu_torch",
                        "--host", h, "--port", str(p),
                        "--device", self.device,
                        "--cluster",
                        "--cluster-topology", topo_path,
                        "--cluster-myid", self.node_ids[i]]
                if self.replicas_per_shard:
                    # Replication is journal-fed and PSYNC serves the
                    # durable snapshot — primaries need both dirs.
                    argv += self._durability_args(f"node{i}")
                if self.metrics:
                    argv += [
                        "--metrics-port",
                        str(self.metrics_addrs[i][1]),
                    ]
                if self.frontdoor_processes > 1:
                    argv += [
                        "--frontdoor-processes",
                        str(self.frontdoor_processes),
                    ]
                procs.append(subprocess.Popen(
                    argv + self.node_args,
                    stdout=log, stderr=subprocess.STDOUT, env=env,
                ))
                log.close()  # the child holds its own fd now
            self._await_ready(procs, self.addrs, "node")
            # Replicas spawn once every primary serves: their boot runs
            # a FULLRESYNC bootstrap against a live primary.
            for j, (h, p) in enumerate(self.replica_addrs):
                pi = j // self.replicas_per_shard
                log = open(
                    os.path.join(self._tmpdir, f"replica{j}.log"), "wb"
                )
                argv = [sys.executable, "-m", "redisson_tpu_torch",
                        "--host", h, "--port", str(p),
                        "--device", self.device,
                        "--cluster",
                        "--cluster-topology", topo_path,
                        "--cluster-myid", self.replica_ids[j],
                        "--replica-of", "%s:%d" % self.addrs[pi]]
                argv += self._durability_args(f"replica{j}")
                if self.metrics:
                    argv += [
                        "--metrics-port",
                        str(self.replica_metrics_addrs[j][1]),
                    ]
                procs.append(subprocess.Popen(
                    argv + self.node_args,
                    stdout=log, stderr=subprocess.STDOUT, env=env,
                ))
                log.close()
            if self.replica_addrs:
                self._await_ready(
                    procs[self.n_nodes:], self.replica_addrs, "replica"
                )
        except Exception:
            for pr in procs:
                try:
                    pr.kill()
                except OSError:
                    pass
            raise
        with self._lock:
            self._procs = procs
            self._primary_proc_idx = list(range(self.n_nodes))
            self._started = True
        return self

    def _durability_args(self, name: str) -> list:
        """--snapshot-dir/--journal-dir under the supervisor tmpdir
        (replication needs both on every member) + the failure-
        detection timeout every bus agent runs with."""
        ddir = os.path.join(self._tmpdir, name)
        snap = os.path.join(ddir, "snap")
        journal = os.path.join(ddir, "journal")
        os.makedirs(snap, exist_ok=True)
        os.makedirs(journal, exist_ok=True)
        return ["--snapshot-dir", snap, "--journal-dir", journal,
                "--cluster-node-timeout-ms", str(self.node_timeout_ms)]

    def _node_name(self, kind: str, i: int) -> str:
        ids = {"node": self.node_ids, "replica": self.replica_ids}.get(kind)
        return ids[i] if ids is not None and i < len(ids) else kind

    def _await_ready(self, procs, addrs, kind: str = "node") -> None:
        deadline = time.monotonic() + self.startup_timeout_s
        for i, addr in enumerate(addrs):
            while True:
                if procs[i].poll() is not None:
                    rc = procs[i].returncode
                    why = (f" (no CUDA device for --device {self.device})"
                           if rc == 2 and self.device.startswith("cuda")
                           else "")
                    log = os.path.join(self._tmpdir, f"{kind}{i}.log")
                    raise RuntimeError(
                        f"cluster {kind} {i} {self._node_name(kind, i)} "
                        f"({addr}) exited rc={rc} during startup{why}; "
                        f"{log} ends:\n{_log_tail(log)}"
                    )
                try:
                    replies = _request(
                        addr,
                        [[b"PING"], [b"CLUSTER", b"MYID"]],
                        timeout_s=2.0,
                    )
                    if replies[0] == b"PONG":
                        break
                except (OSError, ValueError):
                    pass
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"cluster node {i} ({addr}) not serving after "
                        f"{self.startup_timeout_s:.0f}s"
                    )
                time.sleep(0.1)

    # -- operations --------------------------------------------------------

    def client(self, **kw):
        from redisson_tpu_torch.cluster.client import ClusterClient

        return ClusterClient(self.addrs, **kw)

    def start_federation(self, host: str = "127.0.0.1", port: int = 0):
        """Serve ONE merged /metrics over the member nodes' endpoints,
        every series labeled ``node="host:port"``.  Returns the HTTP server (``.host`` /
        ``.port``); shut down with the supervisor."""
        if not self.metrics or not self.metrics_addrs:
            raise RuntimeError(
                "federation needs ClusterSupervisor(metrics=True)"
            )
        if self._federation is not None:
            return self._federation
        from redisson_tpu_torch.obs.federate import start_federation_endpoint

        self._federation = start_federation_endpoint(
            self.metrics_addrs, host=host, port=port
        )
        return self._federation

    def slots_table(self) -> list:
        """The live ownership table — ``CLUSTER SLOTS`` from the first
        answering primary, as (start, end, node_id, host, port) rows.
        Asks the fleet instead of assuming the boot-time partition: the
        rebalancer (and past migrate_slot calls) move slots, so the
        static math went stale the moment any slot moved."""
        last_err = None
        for i, addr in enumerate(self.addrs):
            if i in self._drained:
                continue
            try:
                reply = _check(
                    _request(addr, [[b"CLUSTER", b"SLOTS"]], 5.0)[0],
                    "CLUSTER SLOTS",
                )
                return [
                    (int(row[0]), int(row[1]), row[2][2].decode(),
                     row[2][0].decode(), int(row[2][1]))
                    for row in reply
                ]
            except (OSError, RuntimeError, ValueError,
                    IndexError) as e:
                last_err = e
        raise RuntimeError(f"no primary answered CLUSTER SLOTS: {last_err}")

    def slot_owner_addr(self, slot: int):
        """(host, port) of ``slot``'s CURRENT owner, or None."""
        for start, end, _nid, host, port in self.slots_table():
            if start <= slot <= end:
                return (host, port)
        return None

    def migrate_slot(self, slot: int, dst_index: int,
                     src_index=None, **kw) -> int:
        """Drive a live migration of ``slot`` to node ``dst_index``
        (source defaults to the slot's current owner per the live
        CLUSTER SLOTS table — the boot partition stops being true the
        moment anything reshards)."""
        if src_index is None:
            src_addr = self.slot_owner_addr(slot)
            if src_addr is None:
                raise RuntimeError(f"slot {slot} has no live owner")
        else:
            src_addr = tuple(self.addrs[src_index])
        if tuple(src_addr) == tuple(self.addrs[dst_index]):
            return 0
        return migrate_slot(
            slot, src_addr, self.addrs[dst_index],
            notify=self.addrs, **kw
        )

    # -- elastic join / drain -----------------------------------

    def _live_topology(self, extra=None) -> dict:
        """The CURRENT cluster map as a topology dict (what a joining
        node boots with): every known primary with its live ranges from
        ``slots_table`` (zero-slot members included — a just-added node
        owns nothing yet), the replica roster, plus ``extra`` =
        (node_id, (host, port)) as a new slotless primary."""
        ranges: dict = {}
        for start, end, nid, _h, _p in self.slots_table():
            ranges.setdefault(nid, []).append([start, end])
        nodes = []
        for i, (h, p) in enumerate(self.addrs):
            if i in self._drained:
                continue
            nid = self.node_ids[i]
            nodes.append({
                "id": nid, "host": h, "port": p,
                "slots": sorted(ranges.get(nid, [])),
            })
        for j, (h, p) in enumerate(self.replica_addrs):
            pi = j // self.replicas_per_shard
            nodes.append({
                "id": self.replica_ids[j], "host": h, "port": p,
                "slots": [], "role": "replica",
                "replica_of": self.node_ids[pi],
            })
        if extra is not None:
            nid, (h, p) = extra
            nodes.append({"id": nid, "host": h, "port": p, "slots": []})
        return {"nodes": nodes}

    def primary_alive(self, index: int) -> bool:
        """Is primary ``index`` (addrs numbering) still running?"""
        with self._lock:
            p = self._procs[self._primary_proc_idx[index]]
            return p.poll() is None

    def add_node(self, shift_slots=None, node_args=()) -> int:
        """Elastic scale-out: spawn one new primary, teach the fleet
        its identity (``CLUSTER MEET`` broadcast), and shift slots onto
        it — ``shift_slots=None`` moves an even 1/(n+1) share from the
        current owners (``0`` to leave the shift to a running
        rebalancer, which sees a zero-load member and packs/sheds onto
        it).  Returns the new node's index (addrs numbering).  The
        process joins the supervisor roster, so ``alive()`` and
        ``shutdown()`` — the CI no-orphans contract — cover it."""
        with self._lock:
            if not self._started:
                raise RuntimeError("add_node needs a started cluster")
        nports = 2 if self.metrics else 1
        with self._held_ports(self.host, nports) as ports:
            addr = (self.host, ports[0])
            nid = "node-%d-%d" % (len(self.node_ids), ports[0])
            topo_path = os.path.join(self._tmpdir, f"topology-{nid}.json")
            with open(topo_path, "w") as f:
                json.dump(self._live_topology(extra=(nid, addr)), f)
            env = dict(os.environ)
            env.update(self.env_extra)
            log = open(os.path.join(self._tmpdir, f"{nid}0.log"), "wb")
            argv = [sys.executable, "-m", "redisson_tpu_torch",
                    "--host", addr[0], "--port", str(addr[1]),
                    "--device", self.device,
                    "--cluster",
                    "--cluster-topology", topo_path,
                    "--cluster-myid", nid]
            if self.replicas_per_shard:
                argv += self._durability_args(nid)
            if self.metrics:
                argv += ["--metrics-port", str(ports[1])]
            if self.frontdoor_processes > 1:
                argv += ["--frontdoor-processes",
                         str(self.frontdoor_processes)]
            proc = subprocess.Popen(
                argv + self.node_args + list(node_args),
                stdout=log, stderr=subprocess.STDOUT, env=env,
            )
            log.close()
            # Roster BEFORE readiness: even a boot that dies half-way is
            # the supervisor's to reap (shutdown() must leave no orphans).
            with self._lock:
                self._procs.append(proc)
                self._primary_proc_idx.append(len(self._procs) - 1)
            index = len(self.addrs)
            self.addrs.append(addr)
            self.node_ids.append(nid)
            if self.metrics:
                self.metrics_addrs.append((self.host, ports[1]))
            self._await_ready([proc], [addr], nid)
        # Existing members learn the new id/address — without this
        # their slot maps cannot SETSLOT toward the newcomer.
        meet = [[b"CLUSTER", b"MEET", nid.encode(),
                 addr[0].encode(), b"%d" % addr[1]]]
        for i, a in enumerate(self.addrs[:-1]):
            if i in self._drained:
                continue
            try:
                _check(_request(tuple(a), meet, 5.0)[0], "CLUSTER MEET")
            except OSError:
                pass  # dead member; failover owns that problem
        for a in self.replica_addrs:
            try:
                _check(_request(tuple(a), meet, 5.0)[0], "CLUSTER MEET")
            except OSError:
                pass
        if shift_slots is None or shift_slots > 0:
            self._shift_share_to(index, shift_slots)
        return index

    def _shift_share_to(self, index: int, limit=None) -> int:
        """Bulk-move an even share of every current owner's slots onto
        primary ``index`` (the supervisor-driven half of elastic join,
        for fleets not running the rebalancer)."""
        nid = self.node_ids[index]
        by_owner: dict = {}
        for start, end, owner, host, port in self.slots_table():
            if owner == nid:
                continue
            by_owner.setdefault((owner, (host, port)), []).extend(
                range(start, end + 1)
            )
        if not by_owner:
            return 0
        # Even final share: new member ends with total/(owners+1).
        total = sum(len(v) for v in by_owner.values())
        share = total // (len(by_owner) + 1)
        if limit is not None:
            share = min(share, int(limit))
        moved = 0
        remaining = share
        for (owner, src_addr), slots in sorted(by_owner.items()):
            if remaining <= 0:
                break
            take = min(len(slots) * share // total + 1, remaining,
                       len(slots))
            chunk = sorted(slots)[-take:]
            moved += migrate_slots_bulk(
                chunk, tuple(src_addr), tuple(self.addrs[index]),
                notify=[
                    a for i, a in enumerate(self.addrs)
                    if i not in self._drained
                ] + list(self.replica_addrs),
            )
            remaining -= take
        return moved

    def drain_node(self, index: int, timeout_s: float = 30.0) -> bool:
        """Elastic scale-in, the add_node inverse: bulk-migrate every
        slot off primary ``index`` (distributed across the remaining
        alive primaries), verify it owns nothing, and only THEN retire
        the process (SIGTERM, SIGKILL fallback).  Returns True when the
        node exited cleanly from the SIGTERM.  The roster keeps its
        slot so indices stay stable; ``alive()`` drops it."""
        nid = self.node_ids[index]
        targets = [
            i for i in range(len(self.addrs))
            if i != index and i not in self._drained
            and self.primary_alive(i)
        ]
        if not targets:
            raise RuntimeError("drain_node needs another alive primary")
        owned = [
            s
            for start, end, owner, _h, _p in self.slots_table()
            if owner == nid
            for s in range(start, end + 1)
        ]
        notify = [
            a for i, a in enumerate(self.addrs)
            if i not in self._drained
        ] + list(self.replica_addrs)
        # Round-robin contiguous shares across the survivors.
        per = (len(owned) + len(targets) - 1) // max(1, len(targets))
        for k, t in enumerate(targets):
            chunk = owned[k * per:(k + 1) * per]
            if not chunk:
                break
            migrate_slots_bulk(
                chunk, tuple(self.addrs[index]),
                tuple(self.addrs[t]), notify=notify,
            )
        left = [
            (start, end)
            for start, end, owner, _h, _p in self.slots_table()
            if owner == nid
        ]
        if left:
            raise RuntimeError(
                f"drain of {nid} left it owning {left!r}"
            )
        self._drained.add(index)
        with self._lock:
            p = self._procs[self._primary_proc_idx[index]]
        try:
            p.send_signal(signal.SIGTERM)
        except OSError:
            pass
        try:
            p.wait(timeout=timeout_s)
            clean = True
        except subprocess.TimeoutExpired:
            clean = False
            p.kill()
            try:
                p.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                pass
        return clean and p.poll() is not None

    def replica_index(self, primary_index: int, k: int = 0) -> int:
        """Roster index of ``primary_index``'s k-th replica — the
        process roster lists primaries first, replicas after in spawn
        order (kill_node/alive numbering)."""
        return self.n_nodes + primary_index * self.replicas_per_shard + k

    def kill_node(self, index: int, wait_s: float = 10.0) -> None:
        """SIGKILL one spawned process (the failover soak's crash
        hammer); the roster keeps its slot so indices stay stable."""
        with self._lock:
            p = self._procs[index]
        try:
            p.kill()
        except OSError:
            pass
        try:
            p.wait(timeout=wait_s)
        except subprocess.TimeoutExpired:
            pass

    def alive(self) -> list:
        """Indices of nodes whose process is still running."""
        with self._lock:
            return [
                i for i, p in enumerate(self._procs) if p.poll() is None
            ]

    def shutdown(self, timeout_s: float = 15.0) -> bool:
        """SIGTERM every node, wait, SIGKILL stragglers.  True when ALL
        nodes exited from the SIGTERM (the clean-shutdown assertion the
        CI smoke job makes); the kill fallback guarantees no orphan
        processes either way."""
        with self._lock:
            procs, self._procs = self._procs, []
            self._started = False
            fed, self._federation = self._federation, None
        if fed is not None:
            try:
                fed.close()
            except Exception:
                pass
        for p in procs:
            if p.poll() is None:
                try:
                    p.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        clean = True
        deadline = time.monotonic() + timeout_s
        for p in procs:
            remaining = max(0.1, deadline - time.monotonic())
            try:
                p.wait(timeout=remaining)
            except subprocess.TimeoutExpired:
                clean = False
                p.kill()
                try:
                    p.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    pass
        return clean and all(p.poll() is not None for p in procs)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()
