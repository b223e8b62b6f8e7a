"""Point-in-time recovery: deterministic journal tail replay.

The port's copy of ``redisson_tpu/durability/recovery.py``.

Recovery = ``restore_snapshot`` (device state as of the snapshot's
journal cut) + replay of every journal record AFTER the cut through the
HOST GOLDEN ENGINE: each touched object gets a golden mirror
(objects/degraded.py — the same models every kernel is tested against)
seeded from its restored device row, the tail ops apply with exact
golden semantics, and the final mirror states write back into device
rows, one H2D copy per row.  The device resumes bit-identical to what
the kernels would have produced — the contract (golden == device) is
what makes host-side replay sound.  Replay needs only each record's
state effect, never its per-op results, so the order-free kinds (Bloom
and HLL adds, BitSet set/clear/flip) apply vectorized
(``add_state``/``assign``/``flip_state``) instead of through the
mirrors' per-op serving loops.  Keyed Bloom and HLL records carry
raw codec lanes; replay hashes them with ``utils/hashing.hash128_np``,
bit-identical to the murmur the card ran on the live path.

Replay reads and writes rows through the CURRENT executor
(``_host_row``/``write_row``), so a HOST- or DISK-resident entry replays
against its mirror and receives the replayed mirror back instead of a
device write.

TTL interplay: ``obj.expire`` records re-arm ``expire_at``; a deadline
already in the past at replay time lazily reaps the object exactly as
it would have live (a later record on that name then sees an empty
keyspace slot, like the original run would have after the sweep).

The engine suppresses journaling (``_journal_replaying``) for the
structural engine methods replay calls — a recovery must never journal
its own replay.
"""

from __future__ import annotations

import numpy as np

from redisson_tpu_torch.utils import hashing


def _live_entry(engine, name: str, kind=None):
    """Current live entry for ``name`` (lazy-expiring, like the live
    path), or None; kind mismatches are skipped, not raised — a record
    that raced a delete+recreate of another kind replays as a no-op,
    same as the live op would have errored without mutating."""
    try:
        entry = engine._live_lookup(name)
    except Exception:
        return None
    if entry is None or (kind is not None and entry.kind != kind):
        return None
    return entry


class _ReplaySession:
    """One recovery pass: name -> golden mirror, seeded lazily from the
    restored device rows, written back wholesale at the end."""

    def __init__(self, engine):
        self.engine = engine
        self.mirrors: dict = {}

    # -- mirror bookkeeping ------------------------------------------------

    def mirror(self, name: str, kind=None):
        """The golden mirror for ``name``, seeding from the device row on
        first touch; None when the object is absent/expired/wrong-kind."""
        entry = _live_entry(self.engine, name, kind)
        if entry is None:
            self.mirrors.pop(name, None)
            return None
        mir = self.mirrors.get(name)
        if mir is None:
            from redisson_tpu_torch.objects.degraded import mirror_for_entry

            # _host_row, not a raw read_row: a HOST/DISK-resident
            # entry seeds from its mirror/blob — a
            # DISK-resident sketch replays without touching the device.
            row = np.asarray(self.engine._host_row(entry))
            mir = mirror_for_entry(entry, row)
            self.mirrors[name] = mir
        return mir

    def host_row(self, name: str, kind=None):
        """``name``'s truth during replay: its mirror's encoding when one
        is live (it holds replayed-but-not-written-back state), else the
        device row."""
        entry = _live_entry(self.engine, name, kind)
        if entry is None:
            return None
        mir = self.mirrors.get(name)
        if mir is not None:
            return np.asarray(mir.encode(entry.pool.row_units))
        return np.asarray(self.engine._host_row(entry))

    def drop(self, name: str) -> None:
        self.mirrors.pop(name, None)

    # -- per-op application ------------------------------------------------

    def apply(self, rec: dict) -> None:
        op = rec.get("op")
        fn = getattr(self, "_op_" + str(op).replace(".", "_"), None)
        if fn is None:
            raise ValueError(f"unknown journal record op {op!r}")
        fn(rec)

    # bloom ---------------------------------------------------------------

    def _op_bloom_init(self, rec):
        eng = self.engine
        self.drop(rec["name"])  # a successor never inherits a mirror
        eng.bloom_try_init(rec["name"], int(rec["ei"]), float(rec["fp"]))

    def _bloom_apply_hashed(self, name, h1, h2):
        from redisson_tpu_torch.tenancy import PoolKind

        entry = _live_entry(self.engine, name, PoolKind.BLOOM)
        mir = self.mirror(name, PoolKind.BLOOM)
        if entry is None or mir is None:
            return
        m = entry.params["size"]
        h1m, h2m = hashing.km_reduce_mod(
            np.asarray(h1), np.asarray(h2), m
        )
        mir.add_state(h1m, h2m)

    def _op_bloom_add(self, rec):
        self._bloom_apply_hashed(rec["name"], rec["h1"], rec["h2"])

    def _op_bloom_addk(self, rec):
        blocks = np.asarray(rec["blocks"])
        lengths = np.asarray(rec["lengths"])
        if lengths.ndim == 0:
            lengths = np.full(blocks.shape[0], lengths, np.uint32)
        h1, h2 = hashing.hash128_np(blocks, lengths)
        self._bloom_apply_hashed(rec["name"], h1, h2)

    # hll -----------------------------------------------------------------

    def _op_hll_add(self, rec):
        from redisson_tpu_torch.tenancy import PoolKind

        self.engine.hll_ensure(rec["name"])
        mir = self.mirror(rec["name"], PoolKind.HLL)
        if mir is not None:
            mir.add_state(rec["c0"], rec["c1"], rec["c2"])

    def _op_hll_addk(self, rec):
        blocks = np.asarray(rec["blocks"])
        lengths = np.asarray(rec["lengths"])
        if lengths.ndim == 0:
            lengths = np.full(blocks.shape[0], lengths, np.uint32)
        c0, c1, c2, _ = hashing.murmur3_x86_128(blocks, lengths)
        self._op_hll_add(
            {"name": rec["name"], "c0": c0, "c1": c1, "c2": c2}
        )

    def _op_hll_merge(self, rec):
        from redisson_tpu_torch.tenancy import PoolKind

        self.engine.hll_ensure(rec["name"])
        mir = self.mirror(rec["name"], PoolKind.HLL)
        if mir is None:
            return
        rows = [
            r for r in (
                self.host_row(n, PoolKind.HLL) for n in rec["srcs"]
            ) if r is not None
        ]
        if rows:
            mir.merge_rows(rows)

    # bitset --------------------------------------------------------------

    def _bitset_mirror(self, name, min_bits: int):
        """Mirror with the entry migrated (if needed) to hold
        ``min_bits`` — the replay analog of bitset_ensure's size-class
        migration.  The existing mirror survives migration (its golden
        model grows on demand; write-back sizes to the final pool)."""
        from redisson_tpu_torch.tenancy import PoolKind

        self.engine.bitset_ensure(name, max(1, int(min_bits)))
        return self.mirror(name, PoolKind.BITSET)

    def _op_bitset_set(self, rec):
        idx = np.asarray(rec["idx"], np.uint32)
        mir = self._bitset_mirror(
            rec["name"], int(idx.max()) + 1 if idx.size else 1
        )
        if mir is not None:
            mir.assign(idx, bool(rec["value"]))

    def _op_bitset_flip(self, rec):
        idx = np.asarray(rec["idx"], np.uint32)
        mir = self._bitset_mirror(
            rec["name"], int(idx.max()) + 1 if idx.size else 1
        )
        if mir is not None:
            mir.flip_state(idx)

    def _op_bitset_range(self, rec):
        mir = self._bitset_mirror(rec["name"], int(rec["to"]))
        if mir is not None:
            mir.set_range(int(rec["frm"]), int(rec["to"]), bool(rec["value"]))

    def _op_bitset_bitop(self, rec):
        """Golden-side BITOP (mirrors _bitset_bitop_impl's degraded
        branch): operands grow into one size class, sources contribute
        their replay truth, dest is REPLACED."""
        from redisson_tpu_torch.objects.degraded import _bits_from_words
        from redisson_tpu_torch.tenancy import PoolKind

        eng = self.engine
        dest, srcs, bop = rec["name"], list(rec["srcs"]), rec["bop"]
        max_bits = max(
            (eng.bitset_capacity_bits(n) for n in (dest, *srcs)),
            default=0,
        ) or 32 * 32
        dst = eng._bitset_entry_with_capacity(dest, max_bits)
        src_nbits = []
        for n in srcs:
            e = eng._bitset_entry_with_capacity(n, max_bits)
            src_nbits.append(e.params.get("nbits", 0))
        nbits = (
            -(-src_nbits[0] // 8) * 8 if bop == "not"
            else max(src_nbits, default=0)
        )
        nb_phys = dst.pool.row_units * 32
        srcs_bits = [
            _bits_from_words(self.host_row(n, PoolKind.BITSET), nb_phys)
            for n in srcs
        ]
        if bop == "not":
            out = np.zeros(nb_phys, bool)
            out[:nbits] = ~srcs_bits[0][:nbits]
        else:
            fn = {
                "and": np.logical_and,
                "or": np.logical_or,
                "xor": np.logical_xor,
            }[bop]
            out = srcs_bits[0].copy()
            for b in srcs_bits[1:]:
                out = fn(out, b)
        mir = self.mirror(dest, PoolKind.BITSET)
        if mir is not None:
            mir.replace_bits(out)
            dst.params["nbits"] = nbits

    # cms -----------------------------------------------------------------

    def _op_cms_init(self, rec):
        self.drop(rec["name"])
        self.engine.cms_try_init(
            rec["name"], int(rec["depth"]), int(rec["width"])
        )

    def _op_cms_add(self, rec):
        from redisson_tpu_torch.tenancy import PoolKind

        entry = _live_entry(self.engine, rec["name"], PoolKind.CMS)
        mir = self.mirror(rec["name"], PoolKind.CMS)
        if entry is None or mir is None:
            return
        w = entry.params["width"]
        h1w, h2w = hashing.km_reduce_mod(
            np.asarray(rec["h1"]), np.asarray(rec["h2"]), w
        )
        mir.update_estimate(h1w, h2w, np.asarray(rec["w"], np.uint32))

    def _op_cms_reset(self, rec):
        from redisson_tpu_torch.tenancy import PoolKind

        mir = self.mirror(rec["name"], PoolKind.CMS)
        if mir is not None:
            mir.reset()

    def _op_cms_merge(self, rec):
        from redisson_tpu_torch.tenancy import PoolKind

        mir = self.mirror(rec["name"], PoolKind.CMS)
        if mir is None:
            return
        rows = [
            r for r in (
                self.host_row(n, PoolKind.CMS) for n in rec["srcs"]
            ) if r is not None
        ]
        if rows:
            mir.merge_rows(rows)

    # structural ----------------------------------------------------------

    def _op_obj_del(self, rec):
        self.drop(rec["name"])
        self.engine.delete(rec["name"])

    def _op_obj_rename(self, rec):
        old, new = rec["name"], rec["new"]
        if self.engine.rename(old, new):
            self.mirrors.pop(new, None)
            m = self.mirrors.pop(old, None)
            if m is not None:
                self.mirrors[new] = m
        else:
            self.drop(old)

    def _op_obj_expire(self, rec):
        self.engine.expire_at(rec["name"], float(rec["at"]))

    def _op_obj_persist(self, rec):
        self.engine.clear_expire(rec["name"])

    def _op_obj_restore(self, rec):
        # RESTORE replaces state wholesale: replay through the engine's
        # own restore (device write included), dropping any mirror so a
        # later record re-seeds from the restored row.
        self.drop(rec["name"])
        try:
            self.engine.restore(
                rec["name"], np.asarray(rec["data"], np.uint8).tobytes(),
                replace=bool(rec.get("replace", False)),
            )
        except ValueError:
            # BUSYKEY without replace: the live call errored the same
            # way without mutating — a faithful no-op.
            pass

    # grid keyspace -----------------------------------
    #
    # Grid records are full-entry-state and idempotent.  They cannot
    # apply here directly: during engine-init replay the client's
    # GridStore does not exist yet (the engine is constructed first).
    # They queue on the ENGINE, and the client applies them — in seq
    # order, latest-wins — right after its grid snapshot restore.  The
    # replica stream-apply path calls GridStore.apply_journal_record
    # directly and never routes through this deferral.

    def _defer_grid(self, rec):
        pend = getattr(self.engine, "_pending_grid_replay", None)
        if pend is None:
            pend = self.engine._pending_grid_replay = []
        pend.append(rec)

    def _op_grid_state(self, rec):
        self._defer_grid(rec)

    def _op_grid_del(self, rec):
        self._defer_grid(rec)

    def _op_repl_mark(self, rec):
        # Replica stream bookmark (durability/replica.py): the highest
        # replayed mark is the primary offset this node had applied.
        self.engine._last_repl_mark = max(
            int(getattr(self.engine, "_last_repl_mark", 0)),
            int(rec["offset"]),
        )

    # -- write-back --------------------------------------------------------

    def writeback(self) -> int:
        """Install every touched mirror's final state into its device
        row(s); returns the number of rows written."""
        eng = self.engine
        wrote = 0
        for name, mir in self.mirrors.items():
            entry = _live_entry(eng, name)
            if entry is None:
                continue
            if entry.row is None or entry.row < 0:
                # HOST/DISK tier: the replayed mirror IS the
                # recovered truth — install it as the entry's residency
                # mirror (no device write; a DISK sketch touched by the
                # tail lands HOST-resident with its blob retired).
                eng._install_residency_mirror(entry, mirror=mir)
                wrote += 1
                continue
            row = np.asarray(mir.encode(entry.pool.row_units))
            eng.executor.write_row(entry.pool, entry.row, row)
            wrote += 1
        return wrote


def replay_journal(engine, journal, after_seq: int) -> int:
    """Replay every record with seq > ``after_seq`` into ``engine``
    (already snapshot-restored); returns the record count replayed.
    Runs at engine init, before any traffic — single-threaded."""
    import time

    t0 = time.perf_counter()
    engine._journal_replaying = True
    try:
        session = _ReplaySession(engine)
        n = 0
        for _seq, rec in journal.records_after(after_seq):
            session.apply(rec)
            n += 1
        rows = session.writeback()
        # What the last recovery did (records, rows written back, seconds).
        engine.recovery_stats = {"records": n, "rows_written": rows,
                                 "seconds": time.perf_counter() - t0}
        # Whole-keyspace event: any near-cache state predates the
        # replayed rows (engine init builds the cache before recovery).
        nc = getattr(engine, "nearcache", None)
        if nc is not None:
            nc.invalidate_all()
        return n
    finally:
        engine._journal_replaying = False
