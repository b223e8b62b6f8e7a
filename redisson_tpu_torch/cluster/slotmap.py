"""Slot map + node registry — which node owns which of the 16384 slots,
plus the per-slot migration states (``IMPORTING``/``MIGRATING``) the
redirect protocol reads.

One ``SlotMap`` per server process (the door's routing truth) and one
per slot-aware client (its cached view, refreshed on ``-MOVED``).  All
mutation goes through the slot-map lock; readers take
one consistent snapshot per routing decision (``lookup``) instead of
re-reading fields that a concurrent ``SETSLOT`` could tear.

The port's copy of ``redisson_tpu/cluster/slotmap.py``, byte formats and
semantics unchanged; its locks are plain ``threading`` locks (the JAX
package wraps them in its lock-order witness).
"""

from __future__ import annotations

import threading
from typing import Optional

from redisson_tpu_torch.analysis import witness as _witness
from redisson_tpu_torch.cluster.slots import NSLOTS


class SlotDecision:
    """One consistent routing read for a slot."""

    __slots__ = ("slot", "owner", "owner_addr", "importing_from",
                 "migrating_to", "migrating_addr")

    def __init__(self, slot, owner, owner_addr, importing_from,
                 migrating_to, migrating_addr):
        self.slot = slot
        self.owner = owner
        self.owner_addr = owner_addr
        self.importing_from = importing_from
        self.migrating_to = migrating_to
        self.migrating_addr = migrating_addr


class SlotMap:
    """Slot ownership table: node id per slot + node id -> (host, port).

    Ranges serialize as ``{"nodes": [{"id", "host", "port",
    "slots": [[start, end], ...]}, ...]}`` — the topology-file format the
    supervisor writes and ``--cluster-topology`` loads, and the shape
    ``CLUSTER SLOTS``/``SHARDS`` render from.
    """

    def __init__(self):
        self._lock = _witness.named(threading.Lock(), "cluster.slotmap")
        self._owner: list = [None] * NSLOTS
        self._nodes: dict = {}  # id -> (host, port)
        self.importing: dict = {}  # slot -> source node id
        self.migrating: dict = {}  # slot -> target node id
        self.epoch = 0  # bumped by every topology mutation
        # Replication topology: node roles + whose shard a
        # replica backs, and the per-slot CONFIG EPOCH the failover
        # takeover is gated on — a stale takeover (lost election, stale
        # broadcast) must never overwrite a newer assignment.
        self._roles: dict = {}  # id -> "master" | "replica"
        self._replica_of: dict = {}  # replica id -> primary id
        self._slot_epoch: list = [0] * NSLOTS

    # -- construction ------------------------------------------------------

    @classmethod
    def from_dict(cls, d: dict) -> "SlotMap":
        m = cls()
        for n in d.get("nodes", ()):
            nid = str(n["id"])
            m._nodes[nid] = (str(n["host"]), int(n["port"]))
            role = str(n.get("role") or "master")
            m._roles[nid] = role
            if n.get("replica_of"):
                m._replica_of[nid] = str(n["replica_of"])
            for start, end in n.get("slots", ()):
                start, end = int(start), int(end)
                if not (0 <= start <= end < NSLOTS):
                    raise ValueError(
                        f"slot range {start}-{end} out of 0..{NSLOTS - 1}"
                    )
                for s in range(start, end + 1):
                    m._owner[s] = nid
        return m

    def to_dict(self) -> dict:
        with self._lock:
            out = []
            for nid, (host, port) in sorted(self._nodes.items()):
                n = {
                    "id": nid,
                    "host": host,
                    "port": port,
                    "slots": self._ranges_locked(nid),
                }
                # Role fields only when non-default: the topology-file
                # format stays byte-compatible for primary-only maps.
                if self._roles.get(nid, "master") != "master":
                    n["role"] = self._roles[nid]
                if nid in self._replica_of:
                    n["replica_of"] = self._replica_of[nid]
                out.append(n)
            return {"nodes": out}

    # -- reads -------------------------------------------------------------

    def lookup(self, slot: int) -> SlotDecision:
        """One consistent (owner, migration-state, addresses) read."""
        with self._lock:
            owner = self._owner[slot]
            mig = self.migrating.get(slot)
            return SlotDecision(
                slot,
                owner,
                self._nodes.get(owner),
                self.importing.get(slot),
                mig,
                self._nodes.get(mig) if mig is not None else None,
            )

    def owner(self, slot: int) -> Optional[str]:
        with self._lock:
            return self._owner[slot]

    def addr(self, node_id: str):
        with self._lock:
            return self._nodes.get(node_id)

    def node_ids(self) -> list:
        with self._lock:
            return sorted(self._nodes)

    def owned_count(self, node_id: str) -> int:
        with self._lock:
            return sum(1 for o in self._owner if o == node_id)

    def assigned_count(self) -> int:
        with self._lock:
            return sum(1 for o in self._owner if o is not None)

    def ranges(self, node_id: str) -> list:
        """Contiguous [start, end] slot ranges owned by ``node_id``."""
        with self._lock:
            return self._ranges_locked(node_id)

    def _ranges_locked(self, node_id: str) -> list:
        out: list = []
        start = None
        for s in range(NSLOTS):
            if self._owner[s] == node_id:
                if start is None:
                    start = s
            elif start is not None:
                out.append([start, s - 1])
                start = None
        if start is not None:
            out.append([start, NSLOTS - 1])
        return out

    def slots_table(self) -> list:
        """[(start, end, node_id, host, port)] for every assigned range
        (the CLUSTER SLOTS reply source, ordered by start slot)."""
        out = []
        with self._lock:
            nodes = dict(self._nodes)
            run_owner = None
            start = None
            for s in range(NSLOTS):
                o = self._owner[s]
                if o != run_owner:
                    if run_owner is not None:
                        h, p = nodes[run_owner]
                        out.append((start, s - 1, run_owner, h, p))
                    run_owner, start = o, s
            if run_owner is not None:
                h, p = nodes[run_owner]
                out.append((start, NSLOTS - 1, run_owner, h, p))
        return out

    # -- mutation (CLUSTER SETSLOT / client MOVED learning) ----------------

    def add_node(self, node_id: str, host: str, port: int) -> None:
        with self._lock:
            self._nodes[node_id] = (host, int(port))
            self.epoch += 1

    def set_owner(self, slot: int, node_id: str) -> dict:
        """Finalize ownership (SETSLOT NODE): returns the migration
        state this closed ({"was_importing": ..., "was_migrating": ...})
        so the door can count completed handoffs."""
        with self._lock:
            if node_id not in self._nodes:
                raise KeyError(f"unknown node id {node_id!r}")
            closed = {
                "was_importing": self.importing.pop(slot, None),
                "was_migrating": self.migrating.pop(slot, None),
            }
            self._owner[slot] = node_id
            self.epoch += 1
            return closed

    def set_importing(self, slot: int, from_node: str) -> None:
        with self._lock:
            if from_node not in self._nodes:
                raise KeyError(f"unknown node id {from_node!r}")
            self.importing[slot] = from_node
            self.epoch += 1

    def set_migrating(self, slot: int, to_node: str) -> None:
        with self._lock:
            if to_node not in self._nodes:
                raise KeyError(f"unknown node id {to_node!r}")
            self.migrating[slot] = to_node
            self.epoch += 1

    def set_stable(self, slot: int) -> None:
        with self._lock:
            self.importing.pop(slot, None)
            self.migrating.pop(slot, None)
            self.epoch += 1

    def migration_counts(self) -> tuple:
        with self._lock:
            return len(self.importing), len(self.migrating)

    # -- replication topology + failover takeover ---------------

    def role(self, node_id: str) -> str:
        with self._lock:
            return self._roles.get(node_id, "master")

    def set_role(self, node_id: str, role: str,
                 replica_of: Optional[str] = None) -> None:
        if role not in ("master", "replica"):
            raise ValueError(f"bad role {role!r}")
        with self._lock:
            self._roles[node_id] = role
            if role == "replica" and replica_of:
                self._replica_of[node_id] = replica_of
            else:
                self._replica_of.pop(node_id, None)
            self.epoch += 1

    def replica_of(self, node_id: str) -> Optional[str]:
        with self._lock:
            return self._replica_of.get(node_id)

    def replicas_of(self, primary_id: str) -> list:
        with self._lock:
            return sorted(
                rid for rid, pid in self._replica_of.items()
                if pid == primary_id
            )

    def primary_ids(self) -> list:
        """Node ids with the master role — the failover electorate
        (majority = len//2 + 1, counting unreachable primaries)."""
        with self._lock:
            return sorted(
                nid for nid in self._nodes
                if self._roles.get(nid, "master") == "master"
            )

    def slot_epoch(self, slot: int) -> int:
        with self._lock:
            return self._slot_epoch[slot]

    def apply_takeover(self, old_id: str, new_id: str,
                       epoch: int, slots=None) -> int:
        """Failover takeover (the SETSLOT-broadcast analog): the claimed
        slots move to ``new_id`` stamped with ``epoch``; roles flip (new
        primary is a master, the dead one is demoted to a slotless
        replica entry).  Returns the slot count moved — 0 means the
        broadcast was stale and changed NOTHING.

        The claim set: the winner (``slots=None``) claims whatever its
        OWN map still shows ``old_id`` owning; its broadcast then
        carries those ranges explicitly, and receivers pass them here
        as ``slots`` ([start, end] pairs).  Receivers resolve purely by
        per-slot epoch — NOT by who they currently believe owns the
        slot — so two takeovers of the same primary in successive
        epochs converge to the higher epoch on every node regardless
        of broadcast delivery order (an owner-match rule here diverges:
        a node that applied the epoch-1 claim first would refuse the
        epoch-2 winner, while a node seeing them reversed accepts it).
        A claim's epoch is majority-minted, so a higher epoch always
        supersedes; the ``_slot_epoch[s] < epoch`` gate is what keeps
        a late, lower-epoch broadcast from making two primaries."""
        epoch = int(epoch)
        with self._lock:
            if new_id not in self._nodes:
                raise KeyError(f"unknown node id {new_id!r}")
            if slots is None:
                claim = [
                    s for s in range(NSLOTS) if self._owner[s] == old_id
                ]
            else:
                claim = []
                for start, end in slots:
                    claim.extend(range(int(start), int(end) + 1))
            moved = 0
            for s in claim:
                if self._slot_epoch[s] < epoch:
                    self._owner[s] = new_id
                    self._slot_epoch[s] = epoch
                    moved += 1
            if moved:
                self._roles[new_id] = "master"
                self._replica_of.pop(new_id, None)
                if old_id in self._nodes:
                    self._roles[old_id] = "replica"
                    self._replica_of[old_id] = new_id
                self.epoch += 1
            return moved
