"""Keyspace slot math of the JAX package's ``cluster/`` (the CRC16 key
slot and the command-to-keys table the front door reads).  The rest of
cluster mode (slot map, redirect door, migration, supervisor) is not
ported yet."""

from __future__ import annotations

from redisson_tpu_torch.cluster.slots import (
    NSLOTS,
    command_keys,
    crc16,
    hash_tag,
    key_slot,
)

__all__ = ["NSLOTS", "command_keys", "crc16", "hash_tag", "key_slot"]
