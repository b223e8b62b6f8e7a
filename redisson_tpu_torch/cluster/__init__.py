"""Cluster mode: slot-sharded multi-process serving — the 16384-slot
CRC16 cluster of the JAX package's ``cluster/``, N node processes on one
card (each its own CUDA context) or on many.

- ``slots`` — CRC16/keyslot math, hash tags, command→keys table;
- ``slotmap`` — slot ownership, IMPORTING/MIGRATING states, roles and
  the epoch-gated failover takeover;
- ``slotindex`` — the write-time slot→key index behind GETKEYSINSLOT;
- ``door`` — the server-side redirect protocol (MOVED/ASK/CROSSSLOT/
  TRYAGAIN, per-key migration atomicity under the move guard);
- ``client`` — the slot-aware routing client with pipelined multi-slot
  scatter/gather and the ``fleet_*`` views (``connect_cluster``);
- ``supervisor`` — spawn/migrate/kill/tear down N node processes
  (``migrate_slot``, ``migrate_slots_bulk``);
- ``failover`` — failure detection, epoch elections and takeover;
- ``rebalancer`` — the autonomous rebalancer: per-slot heat from every
  primary's CLUSTER LOADMAP, waves of ``migrate_slot`` moves on the
  coordinator (``--rebalance``, CLUSTER REBALANCE).  Its sibling, the
  fleet doctor, is ``obs/doctor`` (``--doctor``, CLUSTER DOCTOR).

Heavy halves import lazily: a client process that only routes must not
pay for the serving tier.
"""

from __future__ import annotations

from redisson_tpu_torch.cluster.slots import (
    NSLOTS,
    command_keys,
    crc16,
    hash_tag,
    key_slot,
)

_LAZY = {
    "ClusterClient": "client", "ClusterError": "client",
    "CrossSlotError": "client", "ClusterDownError": "client",
    "ClusterSupervisor": "supervisor", "migrate_slot": "supervisor",
    "migrate_slots_bulk": "supervisor",
    "ClusterDoor": "door", "SlotMap": "slotmap",
    "SlotKeyIndex": "slotindex",
    "FailoverState": "failover", "FailoverAgent": "failover",
}


def __getattr__(name):  # PEP 562: lazy heavy halves
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib

    return getattr(
        importlib.import_module(f"redisson_tpu_torch.cluster.{mod}"), name
    )


__all__ = ["NSLOTS", "command_keys", "crc16", "hash_tag", "key_slot",
           *sorted(_LAZY)]
