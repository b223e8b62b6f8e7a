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
into the other.  While a breaker is open, DUMP and snapshots take a
degraded object's bytes from its host mirror (the device row is stale
then), so they keep every mirror-acked write.  Residency tiers travel
too: a HOST-resident tenant's mirror is captured as a standalone array
(``tier_array``), a DISK-resident one by its blob's file name and CRC
(``residency_blobs`` lists them, and blob GC keeps every file the latest
snapshot names); restore reinstates both tiers.  Delete, rename and
expiry drop tier and near-cache state with the object.  Chaos points:
``snapshot.save`` (dump and snapshot), ``snapshot.load`` (restore and
restore_snapshot) and ``snapshot.rename`` (between the tmp-file fsync and
the renames).

Journal coordination, as in the JAX package: TTL changes and RESTORE
append ``obj.expire``/``obj.persist``/``obj.restore`` records under the
commit gate; a snapshot records the journal's cut under the gate (its
``journal_seq``) and retires the covered segments once its files are
durable, and a restore hands that cut to the tail replay.

Topology: snapshots stamp the shard count and the m-shard threshold; a
restore onto another topology remaps row by row (``_extract_rows``), and
``change_topology`` reshards the live engine (the sharded executor,
executor/sharded_executor.py).

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

from redisson_tpu_torch import chaos as _chaos
from redisson_tpu_torch.analysis import witness as _witness
from redisson_tpu_torch.parallel import mesh as _mesh
from redisson_tpu_torch.tenancy.registry import TenantEntry, spec_for

_log = logging.getLogger(__name__)

_DUMP_VERSION = 2
_DUMP_MAGIC = b"RTPU"
HOST_DUMP_MAGIC = b"RTPH"  # the host engine's dumps (objects/engines.py)
_SNAP_META = "sketch_meta.json"
_SNAP_POOLS = "sketch_pools.npz"


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


def _tiered(t: dict) -> bool:
    """A snapshot tenant on the host or disk tier (no device row)."""
    return t.get("residency", "device") != "device" or int(t["row"]) < 0


def parse_device_dump(data: bytes):
    """``(header, row)`` of a card engine's dump (``RTPU``): the magic,
    header and version checked, the row loaded with ``safe_load_npy``."""
    if len(data) < 8 or data[:4] != _DUMP_MAGIC:
        raise ValueError("not a sketch dump (bad magic)")
    (hlen,) = struct.unpack("<I", data[4:8])
    d = json.loads(data[8 : 8 + hlen].decode("utf-8"))
    row = safe_load_npy(io.BytesIO(data[8 + hlen :]))
    if d.get("v") != _DUMP_VERSION:
        raise ValueError(f"unsupported dump version: {d.get('v')}")
    return d, row


def check_dump_row(d: dict, row: np.ndarray) -> tuple:
    """The dump's class key, once its row has its pool's shape."""
    class_key = tuple(d.get("class_key", ()))
    units = spec_for(d["kind"], class_key).row_units
    if row.shape != (units,):
        raise ValueError(f"dump row has shape {row.shape}, pool expects ({units},)")
    return class_key


def device_dump(kind: str, class_key, params: dict, row: np.ndarray, topk) -> bytes:
    """A card engine's dump: ``RTPU | u32 header_len | json header | npy
    row``."""
    header = json.dumps(
        {
            "v": _DUMP_VERSION,
            "kind": kind,
            "class_key": list(class_key),
            "params": dict(params),
            # CMS: the heavy-hitter candidate table travels with the
            # counters, or a restored top_k() would come back empty.
            "topk": topk,
        }
    ).encode("utf-8")
    buf = io.BytesIO()
    np.save(buf, row, allow_pickle=False)
    return _DUMP_MAGIC + struct.pack("<I", len(header)) + header + buf.getvalue()


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
    self.delete(), ``_sweeper``/``_snapshotter`` (None) and
    ``_snapshot_lock`` set by the engine, the degraded-mirror surface
    (self._mirrors, self._mirror_lock, self._host_row), the commit gate
    (self._journal_gate), self.nearcache and self.residency."""

    @staticmethod
    def _entry_rows(entry) -> list:
        """Every device row an entry owns: the primary and, for a
        read-replicated Bloom filter, its replicas.  A HOST/DISK-resident
        entry (row < 0) owns none."""
        if entry.row is None or entry.row < 0:
            return []
        return list(entry.replica_rows) if entry.replica_rows else [entry.row]

    def _reap_rows(self, pool, rows, epoch: int) -> None:
        """Zero-then-free detached rows, atomic against reallocation under
        the dispatch lock (a row is reusable only once clean), and guarded
        by the pool's topology epoch, as the JAX package's is: a live
        change_topology between the caller's detach and this call would
        already have freed the rows in its free-list rebuild.  Today's
        callers (delete, expiry, rename) hold ``_journal_gate`` from the
        detach through this call and the swap takes that gate first, so
        the guard is a backstop for a caller that reaps outside the gate.
        The row holder that does run outside it, the residency quarantine,
        carries the same epoch check (``ResidencyManager.reclaim``)."""
        with pool._dispatch_lock:
            if pool.topology_epoch != epoch:
                return
            for row in rows:
                # rtpulint: disable=RT001 zero-then-free must be atomic vs reallocation under the dispatch lock (the discipline residency.reclaim cites): releasing between would hand out a dirty row
                self.executor.zero_row(pool, row)
                pool.free_row(row)

    # -- TTL / expiry (RedissonExpirable analog) ---------------------------

    def _expire_if_due(self, entry) -> bool:
        """True if ``entry`` expired (and was reaped) just now.  Reaps by
        entry IDENTITY (detach_if), so a racing reaper never removes a
        fresh object re-created under the same name.  Under the commit
        gate, like delete: a tier transition of the same entry either
        completes first (its row is then quarantined, not reaped here) or
        finds the entry gone."""
        if entry is None or entry.expire_at is None or time.time() < entry.expire_at:
            return False
        with self._journal_gate:
            epoch = entry.pool.topology_epoch
            if self.registry.detach_if(entry.name, entry) is None:
                return True
            self._drain()
            self._reap_rows(entry.pool, self._entry_rows(entry), epoch)
            # The heavy-hitter table, cached reads (a structural epoch
            # advance), residency state (heat, host bytes, the disk blob)
            # and a mirror die with the object: a successor under this
            # name must not inherit them.
            self.topk.drop(entry.name)
            self.nearcache.drop_object(entry.name)
            self.residency.drop(entry.name)
            if self._mirrors:
                with self._mirror_lock:
                    self._mirrors.pop(entry.name, None)
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
        with self._journal_gate:
            entry = self._live_lookup(name)
            if entry is None:
                return False
            entry.expire_at = float(ts)
            # Journaled as the absolute deadline (the PEXPIREAT form):
            # replay re-arms it, and a deadline already past at recovery
            # lazily reaps, as the live path would.
            seq = self._journal_rec("obj.expire", name, at=float(ts))
            self._ensure_sweeper()
        return self._ack(True, seq)  # fence outside the gate

    def clear_expire(self, name: str) -> bool:
        """PERSIST analog: True if a TTL was removed."""
        with self._journal_gate:
            entry = self._live_lookup(name)
            if entry is None or entry.expire_at is None:
                return False
            entry.expire_at = None
            seq = self._journal_rec("obj.persist", name)
        return self._ack(True, seq)  # fence outside the gate

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
        if _chaos.ENABLED:
            _chaos.fire("snapshot.save")
        # A degraded entry's truth is its mirror: dumping the device row
        # would roll back every mirror-acked write on a later RESTORE.
        row = self._host_row(entry)
        return device_dump(entry.kind, entry.pool.spec.class_key, entry.params,
                           row, self.topk.export_state(name))

    def restore(self, name: str, data: bytes, replace: bool = False) -> None:
        """Recreate an object from ``dump`` bytes.  BUSYKEY analog: raises
        if the name exists and ``replace`` is False.  A dump of the host
        engine (``use_host_sketch()``) restores too: its golden model
        becomes a device row first, and the journal holds the device
        dump it became."""
        if data[:4] == HOST_DUMP_MAGIC:
            from redisson_tpu_torch.objects.degraded import row_from_model
            from redisson_tpu_torch.objects.engines import HostSketchEngine

            kind, params, model, topk = HostSketchEngine.decode_dump(data, name)
            data = device_dump(kind, *row_from_model(kind, params, model), topk)
        with self._journal_gate:
            self._restore_impl(name, data, replace)
            # Journaled as the raw dump blob (wholesale state replace):
            # replay routes back through restore() itself.
            seq = self._journal_rec(
                "obj.restore", name, data=data, replace=bool(replace)
            )
        self._ack(None, seq)  # fence outside the gate

    def _restore_impl(self, name: str, data: bytes, replace: bool) -> None:
        if _chaos.ENABLED:
            _chaos.fire("snapshot.load", data=data)
        d, row = parse_device_dump(data)
        # Validate the untrusted candidate table and the row's geometry
        # BEFORE any mutation: a malformed blob must not leave a
        # half-restored object behind.
        topk_decoded = type(self.topk).decode_state(d.get("topk"), name)
        class_key = check_dump_row(d, row)
        if self._live_lookup(name) is not None:
            if not replace:
                raise ValueError(f"BUSYKEY: {name!r} already exists")
            self.delete(name)
        self._guard_foreign(name)  # one keyspace: RESTORE can't shadow grid
        entry, created = self.registry.try_create(name, d["kind"], class_key, d["params"])
        if not created:  # raced a concurrent creator
            raise ValueError(f"BUSYKEY: {name!r} already exists")
        if entry.row < 0:
            # Born cold (created past the device budget): the restored
            # state lives in a HOST mirror until heat promotes it.
            self._install_residency_mirror(entry, row=row)
        else:
            self.executor.write_row(entry.pool, entry.row, row)
        # Unconditional: also clears a ghost table when the dump has none.
        self.topk.import_decoded(topk_decoded, name)
        # RESTORE replaces readable state wholesale: retire every cached
        # read of this name (structural epoch advance).
        self.nearcache.drop_object(name)

    # -- Snapshots (client-side RDB analog) --------------------------------

    def snapshot(self, directory: str) -> None:
        """Atomic full-state snapshot: every pool D2H plus the registry
        metadata, in fsynced tmp files renamed into place (directory
        fsynced), so neither a concurrent restore nor a host crash sees a
        torn snapshot.  One snapshot at a time (the periodic snapshotter,
        explicit calls and shutdown share the tmp names).

        Journal coordination: the gate is held across drain → cut →
        capture, so the cut recorded in the metadata splits the records
        exactly into snapshot-covered (retired by ``mark_snapshot`` once
        the files are durable) and tail (replayed at recovery)."""
        if _chaos.ENABLED:
            _chaos.fire("snapshot.save")
        os.makedirs(directory, exist_ok=True)
        with self._snapshot_lock:
            # The gate holds writers and tier transitions off across
            # drain → capture, so the capture is one point in time.
            journal = self.journal
            with self._journal_gate:
                # rtpulint: disable=RT001 the drain barrier MUST run inside the snapshot lock: it is what makes the capture consistent, and the only waiters on this lock are other whole-snapshot callers (periodic/explicit/shutdown), never the write path
                self._drain()
                journal_cut = journal.cut() if journal is not None else 0
                meta, arrays = self._snapshot_capture()
            meta["journal_seq"] = journal_cut
            self._snapshot_write(directory, meta, arrays)
            self._last_save_ts = time.time()  # LASTSAVE
            if journal is not None:
                # The snapshot covering records <= cut is durable: retire
                # the covered segments (the BGREWRITEAOF analog).
                journal.mark_snapshot(journal_cut)
            # Blob GC barrier: the latest durable snapshot now names
            # exactly these blob files; retired blobs outside the set may
            # be deleted.
            self.residency.note_snapshot_refs(meta["residency_blobs"])
            # Companion-state hook (the client wires the grid keyspace
            # here): runs outside the engine locks, inside the snapshot
            # lock, so periodic, explicit and shutdown snapshots persist
            # the whole logical keyspace, not just the sketch pools.
            if self.snapshot_extra is not None:
                self.snapshot_extra(directory)

    def _snapshot_capture(self):
        """Point-in-time (meta, arrays) under the engine locks, in the
        mirror -> registry -> dispatch order that reconcile (mirror ->
        write_row) and try_create -> alloc_row use (the JAX package
        deadlocked a periodic snapshot against object creation when the
        order was inverted): no create, delete, growth, launch or mirror
        op interleaves with the D2H reads.  No file I/O here."""
        with self._mirror_lock, self.registry._lock, self.executor._dispatch_lock:
            arrays, pool_meta = {}, []
            pools = self.registry.pools()
            for i, pool in enumerate(pools):
                arrays[f"pool_{i}"] = self.executor.state_to_host(pool)
                pool_meta.append({
                    "key": list(pool.spec.key),
                    "kind": pool.spec.kind,
                    "class_key": list(pool.spec.class_key),
                    "capacity": pool.capacity,
                })
            if self._mirrors:
                # Degraded overlay: a mirrored entry's truth lives on the
                # host — patch its row into the captured array so a
                # snapshot taken mid-degradation keeps mirror-acked writes.
                pool_idx = {id(p): i for i, p in enumerate(pools)}
                S, thresh = self._topology()
                for e in self.registry.entries():
                    mirror = self._mirrors.get(e.name)
                    if mirror is None or e.row < 0:
                        continue
                    i = pool_idx[id(e.pool)]
                    self._overlay_row(arrays[f"pool_{i}"], pool_meta[i], S, thresh,
                                      e.row, mirror.encode(e.pool.row_units))
            # Residency tiers: a HOST-resident tenant's truth is its
            # mirror — captured as a standalone array; a DISK-resident
            # tenant's truth is its blob — captured by exact file name and
            # CRC (blobs are versioned, and GC never deletes a file the
            # latest snapshot names).  A born-cold tenant with neither has
            # all-zero state and restores as a first-touch zero mirror.
            disk_index = self.residency.disk_index()
            blob_refs = []
            tenants = []
            for j, e in enumerate(self.registry.entries()):
                t = {
                    "name": e.name,
                    "kind": e.kind,
                    "pool_key": list(e.pool.spec.key),
                    "row": e.row,
                    "params": e.params,
                    "expire_at": e.expire_at,
                    "replica_rows": e.replica_rows,
                    "residency": e.residency,
                }
                if e.row < 0:
                    mirror = self._mirrors.get(e.name)
                    info = disk_index.get(e.name)
                    if mirror is not None:
                        key = f"tier_{j}"
                        arrays[key] = np.asarray(mirror.encode(e.pool.row_units))
                        t["residency"] = "host"
                        t["tier_array"] = key
                    elif info is not None:
                        t["residency"] = "disk"
                        t["blob"] = info["file"]
                        t["blob_crc"] = int(info["crc"])
                        t["blob_nbytes"] = int(info["nbytes"])
                        blob_refs.append(info["file"])
                    else:
                        t["residency"] = "host"  # born cold: zeros
                tenants.append(t)
            meta = {
                "residency_blobs": blob_refs,
                "version": _DUMP_VERSION,
                "pools": pool_meta,
                "tenants": tenants,
                # Without the candidate tables a restore keeps every CMS
                # counter but forgets which keys were heavy.
                "topk": self.topk.export_state(),
                # The topology stamp: a restore onto another shard count
                # (or m-shard threshold) remaps row by row.
                "num_shards": self._topology()[0],
                "mbit_threshold_words": self._topology()[1],
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
        if _chaos.ENABLED:
            # The crash window between write and rename: a fault here
            # must leave the previous snapshot intact and loadable.
            _chaos.fire("snapshot.rename")
        os.replace(tmp_npz, os.path.join(directory, _SNAP_POOLS))
        os.replace(tmp_meta, os.path.join(directory, _SNAP_META))
        _fsync_dir(directory)

    def _topology(self):
        """(shard count, m-shard threshold) of the current executor."""
        return getattr(self.executor, "S", 1), self.config.gpu_sketch.mbit_threshold_words

    @staticmethod
    def _pool_units(pm: dict) -> int:
        """Row width of a snapshot pool, from its kind and size class."""
        return spec_for(pm["kind"], tuple(pm["class_key"])).row_units

    @classmethod
    def _layout_shape(cls, pm: dict, S: int, thresh: int) -> tuple:
        """Array shape of a snapshot pool in a topology's layout."""
        return _mesh.layout_shape(pm["kind"], cls._pool_units(pm),
                                  int(pm["capacity"]), S, thresh)

    @classmethod
    def _extract_rows(cls, arr: np.ndarray, pm: dict, s_old: int, mbit_thresh: int):
        """Row getter over a pool array of ANOTHER topology: decodes the
        flat single-device, the ``[S, rows_local*U+1]`` row-sharded or the
        ``[S, cap*(U/S)+1]`` m-sharded layout on the host."""
        kind, u = pm["kind"], cls._pool_units(pm)
        return lambda row: _mesh.read_host_row(arr, kind, u, s_old, mbit_thresh, row)

    @classmethod
    def _overlay_row(cls, arr: np.ndarray, pm: dict, S: int, mbit_thresh: int,
                     row: int, data) -> None:
        """Inverse of ``_extract_rows`` for ONE row: write ``data`` at
        ``row``'s place in a host pool array of the given topology (the
        degraded overlay of ``snapshot``)."""
        _mesh.write_host_row(arr, pm["kind"], cls._pool_units(pm), S,
                             mbit_thresh, row, data)

    def restore_snapshot(self, directory: str) -> bool:
        """Load a snapshot written by ``snapshot`` (by either package);
        True if one was found.  The keyspace must be empty.  Everything
        is validated before the first mutation, so a refused snapshot
        leaves the engine as it was.

        Resharding: a snapshot taken at another shard count (or m-shard
        threshold) restores all the same — each tenant's row is decoded
        from the old layout on the host and written through the current
        executor into a freshly allocated row, in snapshot order (the
        explicit device-array remap that stands in for cluster
        resharding).  Read replicas are dropped then: their placement was
        per old shard; re-replicate on demand."""
        meta_path = os.path.join(directory, _SNAP_META)
        pools_path = os.path.join(directory, _SNAP_POOLS)
        if not (os.path.exists(meta_path) and os.path.exists(pools_path)):
            return False
        if _chaos.ENABLED:
            _chaos.fire("snapshot.load")
        with open(meta_path) as f:
            meta = json.load(f)
        if "pools_crc" in meta:
            with open(pools_path, "rb") as f:
                if _crc_stream(f) != int(meta["pools_crc"]):
                    raise ValueError(
                        "torn snapshot: pool blob CRC does not match its "
                        "metadata (crash between renames?); refusing to restore"
                    )
        topk_decoded = type(self.topk).decode_state(meta.get("topk"))
        # Journal recovery barrier: records with seq <= this are covered
        # by the snapshot; the tail replays on top.
        restored_seq = int(meta.get("journal_seq") or 0)
        s_new, new_thresh = self._topology()
        with np.load(pools_path) as data, \
                self.registry._lock, self.executor._dispatch_lock:
            if "num_shards" in meta:
                s_old = int(meta["num_shards"])
            elif meta["pools"]:
                # A snapshot without the stamp: a sharded state is 2-D.
                arr0 = data["pool_0"]
                s_old = arr0.shape[0] if arr0.ndim == 2 else 1
            else:
                s_old = s_new
            old_thresh = int(meta.get("mbit_threshold_words", new_thresh))
            # Verbatim install needs the same LAYOUT: the shard count and,
            # on a mesh, the m-shard threshold (which rearranges bitset
            # words without changing array shapes).
            same = s_old == s_new and (s_new == 1 or old_thresh == new_thresh)
            if self.registry.entries():
                live = self.registry.names()
                raise ValueError(
                    f"BUSYKEY: {live[:3]!r} already exist; snapshot restore "
                    f"needs an empty keyspace"
                )
            arrays, capacity = [], {}
            for i, pm in enumerate(meta["pools"]):
                arr = data[f"pool_{i}"]
                shape = self._layout_shape(pm, s_old, old_thresh)
                if arr.shape != shape:
                    raise ValueError(
                        f"snapshot pool {pm['key']} holds {arr.shape} elements; "
                        f"{pm['capacity']} rows on {s_old} shard(s) need {shape}"
                    )
                arrays.append(arr)
                capacity[tuple(pm["key"])] = int(pm["capacity"])
            # HOST/DISK tenants own no row (and need no pool of their own
            # in the snapshot: a tenant born cold into a fresh size class
            # has none).
            tiered = [t for t in meta["tenants"] if _tiered(t)]
            for t in tiered:
                if t.get("residency") == "disk":
                    # A missing blob would silently lose the object:
                    # refuse before the first mutation.
                    blob_dir = self.residency.directory
                    if not t.get("blob") or not blob_dir or not os.path.exists(
                            os.path.join(blob_dir, t["blob"])):
                        raise ValueError(
                            f"residency blob {t.get('blob')!r} for {t['name']!r} "
                            f"is missing (residency_dir={blob_dir!r})")
                if t.get("tier_array") and t["tier_array"] not in data.files:
                    raise ValueError(f"snapshot tenant {t['name']!r} lacks its tier array")
            placed = [(tuple(t["pool_key"]), int(r))
                      for t in meta["tenants"] if not _tiered(t)
                      for r in (t.get("replica_rows") or [t["row"]])]
            if len(set(placed)) != len(placed) or not all(
                0 <= row < capacity.get(key, 0) for key, row in placed
            ):
                raise ValueError("snapshot places tenants outside its pools or twice")
            getters = {}
            for i, pm in enumerate(meta["pools"]):
                if same:
                    pool = self.registry.pool_for(pm["kind"], tuple(pm["class_key"]))
                    # The snapshot's capacity is installed verbatim:
                    # re-rounding could clamp a grown pool and hand out
                    # occupied rows.
                    pool.capacity = int(pm["capacity"])
                    pool._free = list(range(pool.capacity - 1, -1, -1))
                    pool.generation += 1
                    self.executor.state_from_host(pool, arrays[i])
                else:
                    getters[tuple(pm["key"])] = self._extract_rows(
                        arrays[i], pm, s_old, old_thresh)
            by_key = {tuple(p.spec.key): p for p in self.registry.pools()}
            pending_mirrors = []  # (entry, row array): HOST tenants
            pending_disk = []  # (name, file, crc, nbytes): DISK tenants
            for t in meta["tenants"]:
                if _tiered(t):
                    # HOST/DISK tenant: no device row in any topology; its
                    # tier installs after the registry/dispatch locks are
                    # released (the mirror lock orders before them
                    # engine-wide).
                    pool = by_key.get(tuple(t["pool_key"]))
                    if pool is None:
                        pool = self.registry.pool_for(t["kind"], tuple(t["pool_key"])[1:])
                    tier = t.get("residency", "host")
                    entry = TenantEntry(
                        t["name"], t["kind"], pool, -1, dict(t["params"]),
                        t.get("expire_at"), residency=tier,
                    )
                    self.registry._tenants[t["name"]] = entry
                    if tier == "disk":
                        pending_disk.append((
                            t["name"], t["blob"], int(t.get("blob_crc", 0)),
                            int(t.get("blob_nbytes", 0)),
                        ))
                    elif t.get("tier_array"):
                        pending_mirrors.append((entry, np.asarray(data[t["tier_array"]])))
                    # else: born cold — zeros on first touch.
                elif same:
                    pool = by_key[tuple(t["pool_key"])]
                    entry = TenantEntry(
                        t["name"], t["kind"], pool, int(t["row"]), dict(t["params"]),
                        t.get("expire_at"), t.get("replica_rows"),
                    )
                    for r in self._entry_rows(entry):
                        pool._free.remove(r)
                    self.registry._tenants[t["name"]] = entry
                else:
                    # Reshard: old row numbers belong to the old layout —
                    # allocate a fresh row and write the decoded one
                    # through the CURRENT executor.
                    entry, _ = self.registry.try_create(
                        t["name"], t["kind"], tuple(t["pool_key"])[1:], dict(t["params"]))
                    entry.expire_at = t.get("expire_at")
                    getter = getters[tuple(t["pool_key"])]
                    # rtpulint: disable=RT001 reshard-restore must be atomic vs concurrent lookups and creates: both locks stay held for the whole install, or a half-restored keyspace becomes visible
                    self.executor.write_row(entry.pool, entry.row, getter(int(t["row"])))
                if t.get("expire_at") is not None:
                    self._ensure_sweeper()
        for entry, rowdata in pending_mirrors:
            self._install_residency_mirror(entry, row=rowdata)
        for name, fname, crc, nbytes in pending_disk:
            self.residency.adopt_blob(name, fname, crc, nbytes)
        self.topk.import_decoded(topk_decoded)
        self._restored_journal_seq = restored_seq
        # Whole-keyspace event: every cached read predates the restored
        # state.
        self.nearcache.invalidate_all()
        return True

    # -- Online reshard (the ClusterConnectionManager slot remap) ----------

    def change_topology(self, num_shards: int) -> bool:
        """Live reshard: move the running engine onto a new shard count
        without a restart or a keyspace wipe, losing no acked write under
        concurrent traffic.

        Protocol, the JAX package's:

        1. the commit gate and the registry lock — new writes, tier
           transitions, snapshots, lookups and creates wait for the swap
           (ops already past their lookup keep flowing into the
           coalescer; they stay valid, see 5);
        2. drain the coalescer: everything queued dispatches on the OLD
           executor and layout;
        3. the dispatch lock: device state is quiescent;
        4. copy every pool to the host, decode its rows with the
           topology-aware extractor (the snapshot reshard's), compose the
           new layout on the host, and install a fresh executor that
           INHERITS the dispatch lock object (queued dispatch closures
           read ``self.executor`` late, so segments submitted mid-swap
           run on the new one);
        5. release: row numbers are topology-STABLE (only their placement
           changes), so ops that captured a row before the swap stay
           correct as they are.

        Read replication is switched off by the swap (placement was per
        old shard); the replica rows stay QUARANTINED — written with the
        filter's data in the new layout, never returned to the free list
        — because a producer may have read ``entry.replica_rows`` before
        the swap and submit to them after it (writes land in a valid
        copy, reads see correct bits).  A bounded leak of S_old - 1 rows
        per replicated object per reshard; a snapshot/restore cycle
        reclaims them.  Returns False if the topology is unchanged.  On
        failure the engine rolls back to the old topology (config,
        executor, every pool): no partial swap survives."""
        s_new = int(num_shards)
        s_old = getattr(self.executor, "S", 1)
        if s_new == s_old:
            return False
        if s_new < 1:
            raise ValueError(f"num_shards must be >= 1, got {s_new}")
        from redisson_tpu_torch.executor.torch_executor import TorchCommandExecutor

        cfg = self.config.gpu_sketch
        with self._journal_gate, self.registry._lock:
            with _witness.allow_blocking(
                "swap protocol: drain blocks under the registry lock by "
                "design (change_topology docstring, steps 1-2)"
            ):
                # rtpulint: disable=RT001 the documented swap protocol: the registry lock blocks NEW lookups while queued ops drain on the old layout; draining outside it would let a post-drain op capture the old executor mid-swap
                self._drain()
            old_exec = self.executor
            thresh = cfg.mbit_threshold_words
            with old_exec._dispatch_lock:
                cfg.num_shards = s_new
                try:
                    if s_new > 1:
                        from redisson_tpu_torch.executor.sharded_executor import (
                            ShardedTorchCommandExecutor,
                        )

                        new_exec = ShardedTorchCommandExecutor(self.config)
                    else:
                        new_exec = TorchCommandExecutor(self.config)
                except Exception:
                    cfg.num_shards = s_old
                    raise
                # ONE dispatch lock for the engine's lifetime: queued
                # closures and pool.alloc_row hold this object.
                new_exec._dispatch_lock = old_exec._dispatch_lock
                # The successor records into the same registry and
                # aggregate (a reshard must not zero the op counters).
                new_exec.obs = old_exec.obs
                new_exec.metrics = old_exec.metrics
                entries = self.registry.entries()
                # Phase 1, pure: compose every pool's new-layout array and
                # free list on the host; nothing mutates until all pools
                # are composed.
                plans = []  # (pool, cap_new, new_arr, new_free)
                for pool in self.registry.pools():
                    spec = pool.spec
                    pm = {"kind": spec.kind, "class_key": list(spec.class_key),
                          "capacity": pool.capacity}
                    getter = self._extract_rows(
                        old_exec.state_to_host(pool), pm, s_old, thresh)
                    u = spec.row_units
                    mbit_new = _mesh.mbit_layout(spec.kind, u, s_new, thresh)
                    # Row numbers are kept: capacity only rounds UP (to an
                    # S-multiple for the row-sharded layout).
                    if s_new == 1 or mbit_new:
                        cap_new = pool.capacity
                    else:
                        cap_new = -(-pool.capacity // s_new) * s_new
                    # Every row an in-flight op may target survives with
                    # its data: primaries AND read replicas.
                    keep = [r for e in entries if e.pool is pool
                            for r in self._entry_rows(e)]
                    pm_new = dict(pm, capacity=cap_new)
                    new_arr = np.zeros(self._layout_shape(pm_new, s_new, thresh),
                                       np.dtype(spec.dtype))
                    for r in keep:
                        self._overlay_row(new_arr, pm_new, s_new, thresh, r, getter(r))
                    used = set(keep)
                    new_free = [r for r in range(cap_new - 1, -1, -1) if r not in used]
                    plans.append((pool, cap_new, new_arr, new_free))
                # Phase 2, journaled: any failure restores every pool, the
                # config and the executor binding.
                undo = []
                try:
                    for pool, cap_new, new_arr, new_free in plans:
                        undo.append((pool, pool.state, pool.capacity, pool._free,
                                     pool.generation, pool.topology_epoch,
                                     pool._factory))
                        pool.capacity = cap_new
                        pool._free = new_free
                        pool.generation += 1
                        # Reaps that detached BEFORE this swap must not
                        # zero or free again: the rebuild above reclaimed
                        # their rows (_reap_rows checks this epoch under
                        # the dispatch lock held here).
                        pool.topology_epoch += 1
                        pool._factory = new_exec
                        new_exec.state_from_host(pool, new_arr)
                except Exception:
                    for pool, st, cap, free, gen, ep, fac in undo:
                        pool.state, pool.capacity, pool._free = st, cap, free
                        pool.generation, pool.topology_epoch = gen, ep
                        pool._factory = fac
                    cfg.num_shards = s_old
                    raise
                # Point of no return: all device state installed.
                for e in entries:
                    e.replica_rows = None  # quarantined, not freed
                self.registry._factory = new_exec
                self.executor = new_exec
                if self.prewarmer is not None:
                    # Adopt the successor and re-run every ladder against
                    # the new layout (a stale binding would warm nothing
                    # while prewarm_wait reported a warm cache).
                    self.prewarmer.rebind_executor(new_exec)
                # Retire the old executor LAST: a caller that read
                # engine.executor before the swap and waits on the
                # dispatch lock is forwarded to the successor (_locked).
                old_exec._successor = new_exec
                # Defensive whole-keyspace invalidation: values are
                # layout-independent, but a mid-swap read may have raced
                # the install.
                self.nearcache.invalidate_all()
                old_exec._retired = True
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
