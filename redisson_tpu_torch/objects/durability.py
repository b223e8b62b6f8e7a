"""Sketch-state durability: TTL, DUMP/RESTORE and snapshots.

Counterpart of ``redisson_tpu/objects/durability.py`` (→
org/redisson/RedissonExpirable.java and RedissonObject#dump/restore; the
client-side analog of Redis RDB persistence):

- ``expire``/``remain_ttl_ms``: a named sketch carries an absolute expiry
  deadline; an expired object vanishes from the keyspace (lazy check on
  lookup plus a background sweeper every 0.25 s).
- ``dump``/``restore``: one object's row + params as data-only bytes,
  ``RTPU | u32 header_len | json header | npy row`` (version 2).
- ``snapshot``/``restore_snapshot``: every pool D2H'd into an ``.npz``
  plus a metadata JSON, written to fsynced tmp files, renamed, and the
  directory fsynced; ``Config.snapshot_dir``/``snapshot_interval_s`` arm
  restore-on-create and periodic snapshots.

The pool layout, the dump header and the snapshot metadata are the JAX
package's, key for key, so a dump or snapshot of either package restores
into the other.

Left out here, with the queue items that bring them: the topology change
and the reshard branch of ``restore_snapshot`` (multi-GPU); the journal
gate and its records (the durability tier); chaos points, degraded
mirrors, residency tiers and the near cache (engine completeness).  A
snapshot taken on a mesh, or holding host/disk-resident tenants, is
refused rather than misread.

Mixed into TorchSketchEngine (objects/engines.py).
"""

from __future__ import annotations

import io
import json
import logging
import os
import struct
import threading
import time
import zlib
from typing import Optional

import numpy as np

from redisson_tpu_torch.tenancy.registry import TenantEntry, spec_for

_log = logging.getLogger(__name__)

_DUMP_VERSION = 2
_DUMP_MAGIC = b"RTPU"
_SNAP_META = "sketch_meta.json"
_SNAP_POOLS = "sketch_pools.npz"
# The JAX package stamps its m-shard threshold (``mbit_threshold_words``,
# default 1 << 22) into every snapshot; one card has no m-sharding, so
# the port writes the default as a stamp for the JAX reader.
_MBIT_THRESHOLD_STAMP = 1 << 22


def _crc_stream(f, chunk: int = 1 << 22) -> int:
    """CRC32 of an open binary file in bounded chunks (a multi-GB pool
    blob is never read resident just to checksum it)."""
    crc = 0
    while True:
        buf = f.read(chunk)
        if not buf:
            return crc
        crc = zlib.crc32(buf, crc)


def _fsync_dir(directory: str) -> None:
    """fsync the directory entry so renames inside it survive a host
    crash (a file's own fsync does not cover its name)."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:  # platform without directory open
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def safe_load_npy(buf: io.BytesIO) -> np.ndarray:
    """np.load for UNTRUSTED dump payloads: a forged .npy header can
    declare a huge shape, so the declared size is checked against the
    bytes present BEFORE anything is allocated."""
    version = np.lib.format.read_magic(buf)
    if version == (1, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(buf)
    elif version == (2, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(buf)
    else:
        raise ValueError(f"unsupported npy version {version}")
    if dtype.hasobject:
        raise ValueError("object arrays are not allowed in dumps")
    count = int(np.prod(shape, dtype=np.int64)) if shape else 1
    nbytes = count * dtype.itemsize
    remaining = len(buf.getbuffer()) - buf.tell()
    if nbytes > remaining:
        raise ValueError(
            f"npy payload declares {nbytes} bytes but only {remaining} follow"
        )
    arr = np.frombuffer(buf.read(nbytes), dtype=dtype, count=count)
    return arr.reshape(shape, order="F" if fortran else "C")


class SketchDurabilityMixin:
    """Requires: self.registry, self.executor, self.topk, self._drain(),
    self.delete(), and ``_sweeper``/``_snapshotter`` (None) and
    ``_snapshot_lock`` set by the engine."""

    def _reap_row(self, pool, row: int) -> None:
        """Zero-then-free a detached row, atomic against reallocation
        under the dispatch lock (a row is reusable only once clean)."""
        with self.executor._dispatch_lock:
            self.executor.zero_row(pool, row)
            pool.free_row(row)

    # -- TTL / expiry (RedissonExpirable analog) ---------------------------

    def _expire_if_due(self, entry) -> bool:
        """True if ``entry`` expired (and was reaped) just now.  Reaps by
        entry IDENTITY (detach_if), so a racing reaper never removes a
        fresh object re-created under the same name."""
        if entry is None or entry.expire_at is None or time.time() < entry.expire_at:
            return False
        if self.registry.detach_if(entry.name, entry) is not None:
            self._drain()
            self._reap_row(entry.pool, entry.row)
            # The heavy-hitter table dies with the object: a successor
            # under this name must not inherit it.
            self.topk.drop(entry.name)
        return True

    def _live_lookup(self, name: str):
        entry = self.registry.lookup(name)
        if entry is not None and self._expire_if_due(entry):
            return None
        return entry

    def expire(self, name: str, ttl_s: float) -> bool:
        """PEXPIRE analog: delete ``ttl_s`` seconds from now."""
        return self.expire_at(name, time.time() + ttl_s)

    def expire_at(self, name: str, ts: float) -> bool:
        entry = self._live_lookup(name)
        if entry is None:
            return False
        entry.expire_at = float(ts)
        self._ensure_sweeper()
        return True

    def clear_expire(self, name: str) -> bool:
        """PERSIST analog: True if a TTL was removed."""
        entry = self._live_lookup(name)
        if entry is None or entry.expire_at is None:
            return False
        entry.expire_at = None
        return True

    def remain_ttl_ms(self, name: str) -> int:
        """PTTL convention: -2 absent, -1 no TTL, else remaining ms."""
        entry = self._live_lookup(name)
        if entry is None:
            return -2
        if entry.expire_at is None:
            return -1
        return max(0, int((entry.expire_at - time.time()) * 1000))

    def _ensure_sweeper(self) -> None:
        """Background expiry sweep, started on the first TTL; checked
        again under the registry lock so two first TTLs start one."""
        if self._sweeper is not None:
            return
        with self.registry._lock:
            if self._sweeper is not None:
                return
            stop = threading.Event()

            def sweep():
                while not stop.wait(0.25):
                    for entry in self.registry.entries():
                        if entry.expire_at is not None:
                            self._expire_if_due(entry)

            t = threading.Thread(target=sweep, name="rtpu-sketch-sweeper", daemon=True)
            self._sweeper = (t, stop)
            t.start()

    def _stop_sweeper(self) -> None:
        sw = self._sweeper
        if sw is not None:
            sw[1].set()
            sw[0].join(timeout=5.0)
            self._sweeper = None

    # -- DUMP / RESTORE (RedissonObject#dump/restore analog) ---------------

    def dump(self, name: str) -> Optional[bytes]:
        """Serialized object state, or None if absent (upstream raises on
        a missing key at RESTORE, not DUMP).  Data-only wire format:
        ``RTPU | u32 header_len | json header | npy row``."""
        entry = self._live_lookup(name)
        if entry is None:
            return None
        self._drain()
        row = self.executor.read_row(entry.pool, entry.row)
        header = json.dumps(
            {
                "v": _DUMP_VERSION,
                "kind": entry.kind,
                "class_key": list(entry.pool.spec.class_key),
                "params": dict(entry.params),
                # CMS: the heavy-hitter candidate table travels with the
                # counters, or a restored top_k() would come back empty.
                "topk": self.topk.export_state(name),
            }
        ).encode("utf-8")
        buf = io.BytesIO()
        np.save(buf, row, allow_pickle=False)
        return _DUMP_MAGIC + struct.pack("<I", len(header)) + header + buf.getvalue()

    def restore(self, name: str, data: bytes, replace: bool = False) -> None:
        """Recreate an object from ``dump`` bytes.  BUSYKEY analog: raises
        if the name exists and ``replace`` is False."""
        if len(data) < 8 or data[:4] != _DUMP_MAGIC:
            raise ValueError("not a sketch dump (bad magic)")
        (hlen,) = struct.unpack("<I", data[4:8])
        d = json.loads(data[8 : 8 + hlen].decode("utf-8"))
        row = safe_load_npy(io.BytesIO(data[8 + hlen :]))
        if d.get("v") != _DUMP_VERSION:
            raise ValueError(f"unsupported dump version: {d.get('v')}")
        # Validate the untrusted candidate table and the row's geometry
        # BEFORE any mutation: a malformed blob must not leave a
        # half-restored object behind.
        topk_decoded = type(self.topk).decode_state(d.get("topk"), name)
        class_key = tuple(d.get("class_key", ()))
        units = spec_for(d["kind"], class_key).row_units
        if row.shape != (units,):
            raise ValueError(f"dump row has shape {row.shape}, pool expects ({units},)")
        if self._live_lookup(name) is not None:
            if not replace:
                raise ValueError(f"BUSYKEY: {name!r} already exists")
            self.delete(name)
        entry, created = self.registry.try_create(name, d["kind"], class_key, d["params"])
        if not created:  # raced a concurrent creator
            raise ValueError(f"BUSYKEY: {name!r} already exists")
        self.executor.write_row(entry.pool, entry.row, row)
        # Unconditional: also clears a ghost table when the dump has none.
        self.topk.import_decoded(topk_decoded, name)

    # -- Snapshots (client-side RDB analog) --------------------------------

    def snapshot(self, directory: str) -> None:
        """Atomic full-state snapshot: every pool D2H plus the registry
        metadata, in fsynced tmp files renamed into place (directory
        fsynced), so neither a concurrent restore nor a host crash sees a
        torn snapshot.  One snapshot at a time (the periodic snapshotter,
        explicit calls and shutdown share the tmp names)."""
        os.makedirs(directory, exist_ok=True)
        with self._snapshot_lock:
            self._drain()
            meta, arrays = self._snapshot_capture()
            self._snapshot_write(directory, meta, arrays)

    def _snapshot_capture(self):
        """Point-in-time (meta, arrays) under the engine locks, in the
        registry-then-dispatch order that try_create -> alloc_row uses
        (the JAX package deadlocked a periodic snapshot against object
        creation when the order was inverted): no create, delete, growth
        or launch interleaves with the D2H reads.  No file I/O here."""
        with self.registry._lock, self.executor._dispatch_lock:
            arrays, pool_meta = {}, []
            for i, pool in enumerate(self.registry.pools()):
                arrays[f"pool_{i}"] = self.executor.state_to_host(pool)
                pool_meta.append({
                    "key": list(pool.spec.key),
                    "kind": pool.spec.kind,
                    "class_key": list(pool.spec.class_key),
                    "capacity": pool.capacity,
                })
            tenants = [
                {
                    "name": e.name,
                    "kind": e.kind,
                    "pool_key": list(e.pool.spec.key),
                    "row": e.row,
                    "params": e.params,
                    "expire_at": e.expire_at,
                    "replica_rows": e.replica_rows,
                    "residency": e.residency,
                }
                for e in self.registry.entries()
            ]
            meta = {
                "residency_blobs": [],
                "version": _DUMP_VERSION,
                "pools": pool_meta,
                "tenants": tenants,
                # Without the candidate tables a restore keeps every CMS
                # counter but forgets which keys were heavy.
                "topk": self.topk.export_state(),
                "num_shards": 1,
                "mbit_threshold_words": _MBIT_THRESHOLD_STAMP,
                "journal_seq": 0,
            }
        return meta, arrays

    def _snapshot_write(self, directory: str, meta: dict, arrays) -> None:
        """Crash-safe install: tmp files fsynced before the renames and
        the directory after.  The metadata carries the pool blob's CRC,
        so a crash between the two renames (new pools under old metadata)
        is detected at restore instead of installing mismatched tables."""
        tmp_npz = os.path.join(directory, _SNAP_POOLS + ".tmp.npz")
        tmp_meta = os.path.join(directory, _SNAP_META + ".tmp")
        np.savez(tmp_npz, **arrays)
        with open(tmp_npz, "rb") as f:
            crc = _crc_stream(f)
            os.fsync(f.fileno())
        meta = dict(meta, pools_crc=crc)
        with open(tmp_meta, "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_npz, os.path.join(directory, _SNAP_POOLS))
        os.replace(tmp_meta, os.path.join(directory, _SNAP_META))
        _fsync_dir(directory)

    def restore_snapshot(self, directory: str) -> bool:
        """Load a snapshot written by ``snapshot`` (by either package);
        True if one was found.  The keyspace must be empty.  Everything
        is validated before the first mutation, so a refused snapshot
        leaves the engine as it was."""
        meta_path = os.path.join(directory, _SNAP_META)
        pools_path = os.path.join(directory, _SNAP_POOLS)
        if not (os.path.exists(meta_path) and os.path.exists(pools_path)):
            return False
        with open(meta_path) as f:
            meta = json.load(f)
        if "pools_crc" in meta:
            with open(pools_path, "rb") as f:
                if _crc_stream(f) != int(meta["pools_crc"]):
                    raise ValueError(
                        "torn snapshot: pool blob CRC does not match its "
                        "metadata (crash between renames?); refusing to restore"
                    )
        if int(meta.get("num_shards", 1)) != 1:
            raise ValueError(
                f"snapshot was taken on {meta['num_shards']} shards; this "
                f"engine restores single-device snapshots only"
            )
        if meta.get("residency_blobs") or any(
            t.get("residency", "device") != "device" or int(t["row"]) < 0
            for t in meta["tenants"]
        ):
            raise ValueError(
                "snapshot holds host- or disk-resident tenants; this engine "
                "has no residency tiers"
            )
        topk_decoded = type(self.topk).decode_state(meta.get("topk"))
        with np.load(pools_path) as data, \
                self.registry._lock, self.executor._dispatch_lock:
            if self.registry.entries():
                live = self.registry.names()
                raise ValueError(
                    f"BUSYKEY: {live[:3]!r} already exist; snapshot restore "
                    f"needs an empty keyspace"
                )
            arrays, capacity = [], {}
            for i, pm in enumerate(meta["pools"]):
                arr = data[f"pool_{i}"]
                spec = spec_for(pm["kind"], tuple(pm["class_key"]))
                cap = int(pm["capacity"])
                if arr.shape != (cap * spec.row_units + 1,):
                    raise ValueError(
                        f"snapshot pool {pm['key']} holds {arr.shape} elements; "
                        f"{cap} rows need {cap * spec.row_units + 1}"
                    )
                arrays.append(arr)
                capacity[spec.key] = cap
            placed = [(tuple(t["pool_key"]), int(t["row"])) for t in meta["tenants"]]
            if len(set(placed)) != len(placed) or not all(
                0 <= row < capacity.get(key, 0) for key, row in placed
            ):
                raise ValueError("snapshot places tenants outside its pools or twice")
            for i, pm in enumerate(meta["pools"]):
                pool = self.registry.pool_for(pm["kind"], tuple(pm["class_key"]))
                # The snapshot's capacity is installed verbatim: re-rounding
                # could clamp a grown pool and hand out occupied rows.
                pool.capacity = int(pm["capacity"])
                pool._free = list(range(pool.capacity - 1, -1, -1))
                pool.generation += 1
                self.executor.state_from_host(pool, arrays[i])
            by_key = {tuple(p.spec.key): p for p in self.registry.pools()}
            for t in meta["tenants"]:
                pool = by_key[tuple(t["pool_key"])]
                row = int(t["row"])
                pool._free.remove(row)
                self.registry._tenants[t["name"]] = TenantEntry(
                    t["name"], t["kind"], pool, row, dict(t["params"]),
                    t.get("expire_at"),
                )
                if t.get("expire_at") is not None:
                    self._ensure_sweeper()
        self.topk.import_decoded(topk_decoded)
        return True

    def _start_snapshotter(self, directory: str, interval_s: float) -> None:
        stop = threading.Event()

        def loop():
            while not stop.wait(interval_s):
                try:
                    self.snapshot(directory)
                except Exception:  # best-effort persistence, never silent
                    _log.exception("periodic snapshot to %s failed", directory)

        t = threading.Thread(target=loop, name="rtpu-snapshotter", daemon=True)
        self._snapshotter = (t, stop)
        t.start()

    def _stop_snapshotter(self) -> None:
        sn = self._snapshotter
        if sn is not None:
            sn[1].set()
            # A snapshot may be mid-write: the final one must come after it.
            sn[0].join(timeout=30.0)
            self._snapshotter = None
