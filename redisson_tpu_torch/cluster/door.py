"""Cluster door — the server-side half of the redirect protocol.

One ``ClusterDoor`` per cluster-mode ``RespServer``.  Every keyed
command routes through :meth:`route` before its handler runs:

- keys hashing to MULTIPLE slots → ``-CROSSSLOT`` (hash tags ``{...}``
  are the co-location escape hatch);
- a slot owned elsewhere → ``-MOVED <slot> <host>:<port>`` (or served
  locally when the slot is IMPORTING and the connection sent
  ``ASKING`` — the one-shot redirect handshake);
- a slot this node owns but is MIGRATING away: keys still present
  locally are served (under the move guard, see below), keys already
  moved → ``-ASK``; a multi-key op split across the boundary →
  ``-TRYAGAIN``.

The move guard (``move_lock``) is what makes per-key
migration loss-free under live traffic: ``MIGRATE`` holds it across its
dump → remote-RESTORE → local-delete sequence, and every command
serving a key in a MIGRATING slot (1) takes it and (2) RE-CHECKS key
presence after acquiring (``route_recheck``) — a command that routed
"serve locally" while the mover was mid-key would otherwise proceed
after the delete and resurrect the key on the source, stranding an
acked write when the slot finalizes.  Lock order: the move guard is
always taken BEFORE the grid and registry locks a handler takes,
never after (MIGRATE holds it across its dump and local delete); the
front door therefore never fuses a run on a migrating slot.

The port's copy of ``redisson_tpu/cluster/door.py``, byte formats and
semantics unchanged; its locks are plain ``threading`` locks (the JAX
package wraps them in its lock-order witness).
"""

from __future__ import annotations

import socket
import threading

import time

from redisson_tpu_torch.analysis import witness as _witness
from redisson_tpu_torch.cluster.slotmap import SlotMap
from redisson_tpu_torch.obs import trace as _trace
from redisson_tpu_torch.cluster.slots import NSLOTS, command_keys, key_slot
from redisson_tpu_torch.serve.wireutil import ReplyError, exchange

# Commands served node-locally even though they carry key args the
# router would otherwise judge: MIGRATE executes ON the source (its key
# is mid-handoff by definition), and the blocking pops park on condvars
# — holding the move guard across a park would freeze the migration
# (they serve unguarded; a pop racing a slot handoff re-resolves on the
# client's next redirect).
_LOCAL_ALWAYS = frozenset(("MIGRATE",))
_NEVER_GUARD = frozenset(
    ("BLPOP", "BRPOP", "XREAD", "XREADGROUP", "SUBSCRIBE", "UNSUBSCRIBE")
)


def _err(msg: str) -> bytes:
    return b"-" + msg.encode() + b"\r\n"


class ClusterDoor:
    def __init__(self, server, slotmap: SlotMap, myid: str,
                 announce=None, obs=None, requirepass=None):
        self._server = server
        self.slotmap = slotmap
        self.myid = myid
        self.announce = announce or (server.host, server.port)
        self.obs = obs
        self._requirepass = requirepass
        # Per-key move atomicity (see module docstring).  One lock per
        # node: only commands touching a MIGRATING slot ever contend on
        # it, and migrations run one slot at a time.  Re-entrant: an EVAL
        # on a migrating slot runs under the guard, and its redis.call of
        # the same key routes through the door again on the same thread
        # (a plain lock deadlocks there — the JAX package's does).
        self.move_lock = _witness.named(threading.RLock(), "cluster.move")
        self.migrate_timeout_s = 10.0
        # Persistent migration sockets, one per target node, touched
        # ONLY under move_lock: a TCP connect per migrated key would
        # sit inside the guarded critical section every concurrent
        # write to the migrating slot waits on.
        self._mig_socks: dict = {}
        # Write-time slot->key index (cluster/slotindex.py), installed
        # by the server when the keyspace hooks are wired.  None means
        # keys_in_slot falls back to the full-keyspace scan.
        self.slot_index = None

    @classmethod
    def from_config(cls, server, config, obs=None):
        """Build from Config: an explicit topology (dict or JSON file
        path) wins; else this node is a single-node cluster owning
        ``cluster_slots`` (default: every slot)."""
        import json
        import os

        host, port = server.host, server.port
        announce = getattr(config, "cluster_announce", None)
        if announce:
            ah, _, ap = announce.rpartition(":")
            announce = (ah, int(ap))
        else:
            announce = (host, port)
        myid = getattr(config, "cluster_node_id", None) or (
            "%s:%d" % announce
        )
        topo = getattr(config, "cluster_topology", None)
        if isinstance(topo, str):
            if not os.path.exists(topo):
                raise ValueError(f"cluster_topology file not found: {topo}")
            with open(topo) as f:
                topo = json.load(f)
        if topo:
            slotmap = SlotMap.from_dict(topo)
            if slotmap.addr(myid) is None:
                raise ValueError(
                    f"cluster_node_id {myid!r} not in the topology "
                    f"(nodes: {slotmap.node_ids()})"
                )
        else:
            slots = getattr(config, "cluster_slots", None) or (
                "0-%d" % (NSLOTS - 1)
            )
            ranges = []
            for part in str(slots).split(","):
                a, _, b = part.partition("-")
                ranges.append([int(a), int(b or a)])
            slotmap = SlotMap.from_dict({
                "nodes": [{
                    "id": myid, "host": announce[0], "port": announce[1],
                    "slots": ranges,
                }]
            })
        return cls(server, slotmap, myid, announce=announce, obs=obs,
                   requirepass=getattr(config, "requirepass", None))

    # -- routing -----------------------------------------------------------

    def _count(self, kind: str) -> None:
        if self.obs is not None:
            self.obs.cluster_redirects.inc((kind,))

    def _exists(self, key: bytes) -> bool:
        return self._server._exists_any(key.decode("utf-8", "replace"))

    def command_slot(self, name: str, cmd: list):
        """(slot, keys) for one command, or (None, frame) when the
        command is keyless / local-always (slot None, frame None) or
        cross-slot (slot None, frame = the error)."""
        if name in _LOCAL_ALWAYS:
            return None, None
        keys = command_keys(cmd)
        if not keys:
            return None, None
        slot = key_slot(keys[0])
        for k in keys[1:]:
            if key_slot(k) != slot:
                self._count("crossslot")
                return None, _err(
                    "CROSSSLOT Keys in request don't hash to the same slot"
                )
        return (slot, keys)

    def route(self, name: str, cmd: list, ctx):
        """(reply_frame, guarded): a non-None frame short-circuits the
        command; guarded=True means the caller must run the handler
        under ``move_lock`` after a ``route_recheck``."""
        asking = getattr(ctx, "asking", False)
        slot, extra = self.command_slot(name, cmd)
        if slot is None:
            # Keyless / local-always commands attribute to slot 0, the
            # loadmap's "unslotted" bucket; cross-slot errors (extra is
            # a frame) attribute nowhere.
            ctx.load_slot = 0 if extra is None else None
            return extra, False
        # Load attribution: the dispatch path reads this
        # back after the handler runs — only decisions that SERVE here
        # leave a slot; every redirect/error path below clears it.
        ctx.load_slot = None
        ctx.asking = False  # one-shot: consumed by this keyed command
        keys = extra
        d = self.slotmap.lookup(slot)
        if d.owner == self.myid:
            if d.migrating_to is None:
                ctx.load_slot = slot
                return None, False
            # Presence probe OUTSIDE the slotmap lock (lookup returned a
            # snapshot); the authoritative re-check happens under the
            # move guard in route_recheck.
            present = sum(1 for k in keys if self._exists(k))
            if present == len(keys):
                ctx.load_slot = slot
                return None, name not in _NEVER_GUARD
            if present == 0:
                self._count("ask")
                return _err(
                    "ASK %d %s:%d" % ((slot,) + tuple(d.migrating_addr))
                ), False
            self._count("tryagain")
            return _err(
                "TRYAGAIN Multiple keys request during rehashing of slot"
            ), False
        if d.importing_from is not None and asking:
            self._count("asking_served")
            ctx.load_slot = slot
            return None, False
        if d.owner is None:
            return _err(
                "CLUSTERDOWN Hash slot not served"
            ), False
        self._count("moved")
        return _err(
            "MOVED %d %s:%d" % ((slot,) + tuple(d.owner_addr))
        ), False

    def route_recheck(self, name: str, cmd: list):
        """Re-judge a guarded command AFTER acquiring the move lock: the
        mover may have shipped its keys while the command waited.
        Returns a redirect frame, or None to proceed (presence is now
        stable — the mover needs the same lock)."""
        slot, extra = self.command_slot(name, cmd)
        if slot is None:
            return extra
        keys = extra
        d = self.slotmap.lookup(slot)
        if d.owner != self.myid:
            # The slot finalized AWAY while this command waited on the
            # move guard: serving now would land an acked write on a
            # node that no longer owns the slot — the new owner never
            # sees it, and every future read goes there (the write would
            # resurrect the key on the source with the ack already on
            # the wire).  Redirect; the client re-runs against the
            # authoritative owner.
            if d.owner is None:
                return _err("CLUSTERDOWN Hash slot not served")
            self._count("moved")
            return _err(
                "MOVED %d %s:%d" % ((slot,) + tuple(d.owner_addr))
            )
        if d.migrating_to is None:
            return None  # migration closed with us still owner: serve
        present = sum(1 for k in keys if self._exists(k))
        if present == len(keys):
            return None
        if present == 0:
            self._count("ask")
            return _err(
                "ASK %d %s:%d" % ((slot,) + tuple(d.migrating_addr))
            )
        self._count("tryagain")
        return _err(
            "TRYAGAIN Multiple keys request during rehashing of slot"
        )

    def serves_plainly(self, key: bytes) -> bool:
        """Fast gate for the front-door vectorizer: True only when
        ``key``'s slot is owned here with NO migration state — the only
        case where fusing a run skips no redirect judgment."""
        d = self.slotmap.lookup(key_slot(key))
        return (
            d.owner == self.myid
            and d.migrating_to is None
            and d.importing_from is None
        )

    def frame_cacheable(self, name: str, cmd: list) -> bool:
        """Response-cache install gate: a reply frame may only be
        reused for an identical command while the routing judgment is
        trivially stable — every key plainly served here.  Frames from
        migrating/importing slots (ASKING-served reads, mid-migration
        values) must re-route each time."""
        slot, extra = self.command_slot(name, cmd)
        if slot is None:
            return True  # keyless; cross-slot frames are errors anyway
        d = self.slotmap.lookup(slot)
        return (
            d.owner == self.myid
            and d.migrating_to is None
            and d.importing_from is None
        )

    # -- key enumeration (GETKEYSINSLOT / COUNTKEYSINSLOT) ------------------

    def keys_in_slot(self, slot: int, count=None) -> list:
        # Index-backed since the rebalancer made many-slot
        # migration the common case, so the old O(total keys) re-hash
        # per pump batch (quadratic across a wave) moved to write time
        # (cluster/slotindex.py).  The scan survives below as the
        # DEBUG-level ground-truth cross-check.
        if self.slot_index is not None:
            return self.slot_index.keys(slot, count)
        return self.keys_in_slot_scan(slot, count)

    def keys_in_slot_scan(self, slot: int, count=None) -> list:
        """The pre-index full-keyspace scan: O(total keys) per call,
        re-hashing every key name.  Kept as the authoritative
        cross-check (``DEBUG GETKEYSINSLOT`` / ``DEBUG
        COUNTKEYSINSLOT`` serve from here) — if index and scan ever
        disagree, the index's write-time hooks missed a path."""
        out = []
        for name in self._server._client.get_keys().get_keys():
            if key_slot(name) == slot:
                out.append(name)
                if count is not None and len(out) >= count:
                    break
        return out

    def undumpable_in_slot(self, slot: int) -> list:
        """Keys in ``slot`` that cannot ship over MIGRATE (container
        grid kinds — their dump is pickle-based and never meets a
        socket).  The migration coordinator pre-flights this so a slot
        refuses to migrate CLEANLY, before any IMPORTING/MIGRATING
        state exists, instead of aborting half-pumped."""
        out = []
        for name in self.keys_in_slot(slot):
            try:
                self._server._dump_payload(name)
            except Exception:
                out.append(name)
        return out

    # -- per-key migration (the MIGRATE command body) -----------------------

    def migrate_key(self, host: str, port: int, key: bytes,
                    timeout_ms: int, replace: bool = True) -> str:
        """Atomically move one key to ``host:port``: dump → RESTORE on
        the target (with ASKING: the target's slot is IMPORTING, not
        owned) → local delete, all under the move guard so no
        concurrently-acked local write can land between the dump and
        the delete.  Returns "OK" or "NOKEY"."""
        name = key.decode("utf-8", "replace")
        timeout_s = (timeout_ms / 1000.0) if timeout_ms else (
            self.migrate_timeout_s
        )
        t0 = time.monotonic()
        keysvc = self._server._client.get_keys()
        with self.move_lock:
            blob = self._server._dump_payload(name)
            if blob is None:
                return "NOKEY"
            ttl_ms = keysvc.remain_time_to_live(name)
            cmds = []
            if self._requirepass:
                cmds.append([b"AUTH", self._requirepass.encode()])
            prelude_idx = None
            tctx = _trace.current()
            if tctx is not None and not isinstance(tctx, tuple):
                # Migration-pump trace propagation: the
                # remote RESTORE hop joins the traced MIGRATE's trace
                # via the same wire prelude the cluster client uses.
                # Unknown-command-safe: a plain target errors on the
                # prelude (tolerated below) and the transfer still
                # proceeds, just untraced on that hop.
                prelude_idx = len(cmds)
                cmds.append([b"RTPU.TRACE"] + tctx.wire_args())
            cmds.append([b"ASKING"])
            restore = [b"RESTORE", key,
                       b"%d" % (ttl_ms if ttl_ms > 0 else 0), blob]
            if replace:
                restore.append(b"REPLACE")
            cmds.append(restore)
            # Network round trip under the move guard — deliberate:
            # releasing it between the remote RESTORE and the local
            # delete would re-open exactly the lost-acked-write window
            # the guard exists to close (Redis MIGRATE blocks the same
            # way).  Bounded by the socket timeout; the per-target
            # socket persists across keys (a TCP connect per key would
            # stretch every guarded command's wait).
            replies = self._mig_exchange((host, port), cmds, timeout_s)
            for i, r in enumerate(replies):
                if isinstance(r, ReplyError):
                    if i == prelude_idx:
                        continue  # plain target: prelude unknown, fine
                    raise OSError(f"target refused key transfer: {r}")
            keysvc.delete(name)
        # LATENCY "migration" event: the per-key critical
        # section every concurrent write to the migrating slot waited
        # behind.
        if self.obs is not None:
            lat = getattr(self.obs, "latency", None)
            if lat is not None and lat.threshold_ms > 0:
                lat.record(
                    "migration", (time.monotonic() - t0) * 1e3
                )
        return "OK"

    def _mig_exchange(self, addr, cmds, timeout_s: float) -> list:
        """One pipelined cycle on the cached migration socket for
        ``addr`` (caller holds move_lock).  A dead cached socket gets
        one reconnect; an OSError mid-cycle discards it (desynced —
        replies could cross keys on reuse)."""
        sock = self._mig_socks.pop(addr, None)
        fresh = sock is None
        while True:
            if sock is None:
                sock = socket.create_connection(addr, timeout=timeout_s)
                fresh = True
            try:
                replies = exchange(sock, cmds)
            except OSError:
                sock.close()
                sock = None
                if fresh:
                    raise  # a brand-new socket failed: the target is down
                continue  # stale cached socket: reconnect once
            self._mig_socks[addr] = sock
            return replies

    def close(self) -> None:
        with self.move_lock:
            socks, self._mig_socks = list(self._mig_socks.values()), {}
        for s in socks:
            try:
                s.close()
            except OSError:
                pass

    # -- introspection (INFO cluster / CLUSTER INFO) ------------------------

    def info_lines(self) -> list:
        importing, migrating = self.slotmap.migration_counts()
        lines = [
            "cluster_enabled:1",
            "cluster_state:ok",
            f"cluster_slots_assigned:{self.slotmap.assigned_count()}",
            f"cluster_known_nodes:{len(self.slotmap.node_ids())}",
            f"cluster_size:{len(self.slotmap.node_ids())}",
            f"cluster_myid:{self.myid}",
            f"cluster_my_slots:{self.slotmap.owned_count(self.myid)}",
            f"cluster_slots_importing:{importing}",
            f"cluster_slots_migrating:{migrating}",
            f"cluster_topology_epoch:{self.slotmap.epoch}",
        ]
        if self.obs is not None:
            by_kind = {
                lv[0]: int(c.value)
                for lv, c in self.obs.cluster_redirects.items()
            }
            lines += [
                "cluster_redirects:" + ",".join(
                    f"{k}={v}" for k, v in sorted(by_kind.items())
                ),
                "cluster_slot_migrations:%d" % sum(
                    int(c.value)
                    for _, c in self.obs.cluster_slot_migrations.items()
                ),
            ]
        return lines
