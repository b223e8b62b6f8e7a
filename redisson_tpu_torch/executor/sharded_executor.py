"""ShardedTorchCommandExecutor — the executor over S logical shards.

Counterpart of ``redisson_tpu/executor/sharded_executor.py`` (the
ClusterConnectionManager + CommandExecutor analog): tenant row ``r``
lives on shard ``r % S`` of a ``[S, local_len]`` pool, and
``Config.use_gpu_sketch(num_shards=S)`` is the only switch — the engine
and the coalescer see the method surface of ``TorchCommandExecutor``.

Dispatch model, the JAX package's partition-by-owner: the host splits
every op batch by owner shard into ``[S, Bp]`` blocks (``_Partition``,
numpy), ships each placement its own shards' ``[S/D, Bp]`` block in one
H2D copy, and the mesh body of ``parallel/mesh.py`` runs each shard's
ops on that shard's row of its placement's block.  Per-op results come
back ``[S, Bp]`` (bit-packed ``[S, Bp/32]``), one block per placement,
and are restored to arrival order on the host.  Whole-row ops run on the
row's owner; cross-shard BITOP, PFMERGE and CMS.MERGE gather their
sources from their owners to the destination's device.

Layouts, byte for byte the JAX package's (so snapshots, dumps and pool
arrays cross between the packages):

- tenant pools: ``[S, capacity / S * row_units + 1]``, capacity rounded
  up to a multiple of S;
- m-sharded BitSet pools (``row_units >= mbit_threshold_words`` and
  divisible by S): ``[S, capacity * (row_units / S) + 1]`` — every shard
  holds its word window of every row;
- growth drops each shard's scratch element and appends zeros (the new
  rows, then a fresh scratch element).

The layout rule itself lives in ``parallel/mesh.py`` (``mbit_layout``,
``local_units``, ``row_slices``), shared with the snapshot and reshard
code that reads and writes these arrays on the host.

Placement (``MeshContext``): the shards sit in contiguous blocks on
the executor's device slice (``torch_executor.executor_devices``), one
block per device, up to S of them; one device keeps the single
``[S, local_len]`` stack.  With ``num_processes`` > 1 the engine has
joined a torch.distributed group: this process holds its contiguous
1/P of the global shards, every process computes the same partition and
runs only its own shards' blocks, and results, row reads and snapshots
travel from their owners by collectives, so every process returns the
whole answer.  Every process must issue the same calls in the same
order.

The sequential CMS kernel K1 works on a single table and the runs-
metadata paths describe ops in arrival order, which partitioning
reorders, so both capability flags are off: the engine routes
``add_all_seq`` to the whole-batch CMS path and coalesced Bloom/BitSet
traffic to the per-op paths, as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

from redisson_tpu_torch import chaos as _chaos
from redisson_tpu_torch.executor.torch_executor import (
    LazyResult,
    TorchCommandExecutor,
    _as_u32,
    _build,
    _locked,
    _note_first_launch,
    _serialized,
    _trim_lanes,
    bloom_count_from_bitcount,
    process_group,
)
from redisson_tpu_torch.ops import bitops, bitset as bitset_ops, cms_seq, golden
from redisson_tpu_torch.ops import hll as hll_ops
from redisson_tpu_torch.parallel import mesh as pm


class _Partition:
    """Host-side owner-shard split of one op batch: the [S, Bp] scatter
    layout and the inverse mapping that restores per-op results to
    arrival order.  ``shard`` may be any per-op owner assignment — row %
    S for tenant-sharded pools (``from_rows``), the word block for
    m-sharded bitmaps."""

    __slots__ = ("S", "B", "Bp", "order", "sh_sorted", "slot", "lrows",
                 "valid", "counts")

    @classmethod
    def from_rows(cls, S: int, rows, bucket_fn) -> "_Partition":
        rows = np.asarray(rows, np.int64)
        p = cls(S, rows % S, bucket_fn)
        p.lrows = (rows // S).astype(np.int32)
        return p

    def __init__(self, S: int, shard, bucket_fn):
        shard = np.asarray(shard, np.int64)
        self.S = S
        self.B = int(shard.shape[0])
        self.lrows = None
        self.order = np.argsort(shard, kind="stable")
        counts = np.bincount(shard, minlength=S)
        self.counts = counts  # per-shard op counts (the obs shard family)
        self.Bp = bucket_fn(int(counts.max()) if self.B else 1)
        self.sh_sorted = shard[self.order]
        offsets = np.zeros(S, np.int64)
        np.cumsum(counts[:-1], out=offsets[1:])
        self.slot = np.arange(self.B, dtype=np.int64) - offsets[self.sh_sorted]
        valid = np.zeros((S, self.Bp), bool)
        valid[self.sh_sorted, self.slot] = True
        self.valid = valid

    def scatter(self, col, fill=0):
        """[B] (or [B, L]) column -> [S, Bp] (or [S, Bp, L]) block."""
        col = np.asarray(col)
        shape = (self.S, self.Bp) + col.shape[1:]
        out = np.full(shape, fill, col.dtype)
        out[self.sh_sorted, self.slot] = col[self.order]
        return out

    def unpack_bools(self, packed: np.ndarray) -> np.ndarray:
        """[S, Bp/32] packed results -> bool[B] in arrival order."""
        un = bitops.unpack_bool_u32(
            np.ascontiguousarray(packed).reshape(-1), self.S * self.Bp
        ).reshape(self.S, self.Bp)
        res = np.empty(self.B, bool)
        res[self.order] = un[self.sh_sorted, self.slot]
        return res

    def gather_vals(self, block: np.ndarray) -> np.ndarray:
        """[S, Bp] per-op values -> [B] in arrival order."""
        res = np.empty(self.B, block.dtype)
        res[self.order] = block[self.sh_sorted, self.slot]
        return res


def _words(col) -> np.ndarray:
    """A column as 4-byte words: bools become 0/1, ints their uint32
    bit pattern."""
    col = np.asarray(col)
    if col.dtype == np.bool_:
        return col.astype(np.uint32)
    return col.astype(np.uint32, copy=False) if col.dtype.itemsize == 4 else \
        col.astype(np.int64).astype(np.uint32)


class ShardedTorchCommandExecutor(TorchCommandExecutor):
    # K1 runs on one table; sharded CMS traffic takes the partitioned
    # whole-batch path instead (the JAX package's supports_pallas_cms).
    supports_seq_cms = False
    # Partition-by-owner reorders ops on the host before dispatch, so run
    # metadata cannot describe the shipped order: per-op-array paths.
    supports_runs_metadata = False

    def __init__(self, config):
        super().__init__(config)
        n = int(config.gpu_sketch.num_shards)
        self.ctx = pm.MeshContext(devices=self.devices, n_shards=n,
                                  group=process_group(self._cfg, self.device))
        self.S = self.ctx.n_shards
        # A launch runs on every placement's device: one pair of timing
        # events per distinct device.
        self.launch_devices = tuple(dict.fromkeys(self.ctx.devices))

    # -- pool-state factory --------------------------------------------------

    def _mbit_layout(self, row_units: int, kind: str) -> bool:
        return pm.mbit_layout(kind, row_units, self.S, self._cfg.mbit_threshold_words)

    def round_capacity(self, capacity: int, row_units: int = 0, kind: str = "") -> int:
        if self._mbit_layout(row_units, kind):
            # m-sharded rows span every shard: no S-multiple needed; the
            # giant-row clamp of the single-device executor applies.
            return super().round_capacity(capacity, row_units)
        return -(-capacity // self.S) * self.S

    def _local_units(self, capacity: int, row_units: int, kind: str) -> int:
        return pm.local_units(kind, row_units, capacity, self.S,
                              self._cfg.mbit_threshold_words)

    def make_pool_state(self, capacity: int, row_units: int, dtype=np.uint32,
                        kind: str = ""):
        """[S, local_len]: each shard's flat pool plus its own scratch."""
        local = self._local_units(capacity, row_units, kind)
        return self.ctx.make_state(local + 1, self._torch_dtype(dtype))

    def grow_pool_state(self, state, old_cap: int, new_cap: int, row_units: int,
                        dtype=np.uint32, kind: str = ""):
        extra = (self._local_units(new_cap, row_units, kind)
                 - self._local_units(old_cap, row_units, kind) + 1)

        def grow(block):
            zeros = torch.zeros((block.shape[0], extra), dtype=block.dtype,
                                device=block.device)
            # block[:, :-1] drops every shard's old scratch element.
            return torch.cat([block[:, :-1], zeros], dim=1)

        if isinstance(state, pm.PlacedState):
            return pm.PlacedState(self.ctx, [grow(b) for b in state.blocks])
        return grow(state)

    @_serialized
    def state_to_host(self, pool) -> np.ndarray:
        """The ``[S, local_len]`` pool, byte-identical to the JAX
        executor's: the placements' blocks in order; across processes one
        shard block at a time from its owner (every process must call it
        at the same point, as any dispatch)."""
        st = pool.state
        if not isinstance(st, pm.PlacedState):
            return self._host_view(st)
        if self.ctx.group is None:
            return np.concatenate([self._host_view(b) for b in st.blocks])
        return np.stack([self._host_view(self.ctx.from_owner(s, lambda s=s: st[s]))
                         for s in range(self.S)])

    @_serialized
    def state_from_host(self, pool, arr: np.ndarray) -> None:
        """Install a host ``[S, local_len]`` pool: each placement takes
        its own shards' rows."""
        if not self.ctx.placed:
            pool.state = self._to_device(pool, arr)
            return
        pool.state = pm.PlacedState(self.ctx, [
            self._to_device(pool, arr[sh.start : sh.stop], dev)
            for _, dev, sh in self.ctx.placements()
        ])

    # -- placement helpers -----------------------------------------------------

    def _is_mbit(self, pool) -> bool:
        return self._mbit_layout(pool.row_units, pool.spec.kind)

    def _mbit_wl(self, pool) -> int:
        return pool.row_units // self.S

    def _part(self, rows) -> _Partition:
        p = _Partition.from_rows(self.S, rows, self._bucket)
        if self.obs is not None:  # per-shard routing counts (obs registry)
            self.obs.record_shard_counts(p.counts)
        return p

    def _mpart(self, pool, idx):
        """Partition single-bit ops by word shard; returns (partition,
        local bit index within the shard's word window).  int64 math:
        uint32 has no ``>>`` or ``//`` on every torch device."""
        WL = self._mbit_wl(pool)
        idx = np.asarray(idx, np.int64)
        shard = (idx >> 5) // WL
        p = _Partition(self.S, shard, self._bucket)
        if self.obs is not None:
            self.obs.record_shard_counts(p.counts)
        return p, (idx - shard * (WL * 32)).astype(np.uint32)

    def _scatter_put(self, p: _Partition, cols):
        """Scatter each ``(column, fill)`` into the [S, Bp(, L)] layout:
        each placement of this process gets ONE staging block (pinned on
        CUDA) of its own shards' rows, shipped to its device with one H2D
        copy.  Returns the columns' device views (int32 bit-views;
        boolean columns as 0/1 words) and the bool[S, Bp] valid mask,
        which rides each block as its shards' op counts — tensors on a
        single stack, ``Blocks`` of one view per placement otherwise."""
        cols = [(_words(c), fill) for c, fill in cols]
        if _chaos.ENABLED:  # sharded scatter-staging fault point
            for col, _ in cols:
                _chaos.fire("h2d.scatter", data=col)
        views, valids = [], []
        for _, dev, shards in self.ctx.placements():
            a, b = shards.start, shards.stop
            # Ops sorted by shard: this placement's are one contiguous run.
            i0, i1 = np.searchsorted(p.sh_sorted, (a, b))
            sh, slot, order = p.sh_sorted[i0:i1] - a, p.slot[i0:i1], p.order[i0:i1]
            shapes = [(b - a, p.Bp) + c.shape[1:] for c, _ in cols]
            sizes = [int(np.prod(s)) for s in shapes]
            buf, host = self._staging(b - a + sum(sizes))
            buf[: b - a] = p.counts[a:b]
            off = b - a
            for (col, fill), shape, n in zip(cols, shapes, sizes):
                view = buf[off : off + n].reshape(shape)
                view[...] = np.uint32(fill)
                view[sh, slot] = col[order]
                off += n
            packed = self._ship(host, dev)
            out, off = [], b - a
            for shape, n in zip(shapes, sizes):
                out.append(packed[off : off + n].view(shape))
                off += n
            slots = torch.arange(p.Bp, device=dev)
            valids.append(slots[None, :] < packed[: b - a].to(torch.int64)[:, None])
            views.append(out)
        if not self.ctx.placed:
            return views[0], valids[0]
        return [pm.Blocks(c) for c in zip(*views)], pm.Blocks(valids)

    # -- rows --------------------------------------------------------------------

    def _read_row_dev(self, pool, row: int) -> torch.Tensor:
        """A device copy of one row in the flat order of its words (on
        its owner's device; an m-sharded row on the first device)."""
        if self._is_mbit(pool):
            WL = self._mbit_wl(pool)
            rows = pm.msharded_row_map(
                self.ctx, lambda local, r: bitops.row_slice(local, r, WL))(pool.state, row)
            if isinstance(rows, pm.Blocks):
                rows = torch.cat([b.to(self.device) for b in rows])
            return rows.reshape(-1)  # [S, WL] -> [U]
        return pm.sharded_row_read(self.ctx, row_units=pool.row_units)(pool.state, row)

    def _row_device(self, pool, row: int):
        """Where a row payload should land: its owner's device (the
        first for an m-sharded row, or another process's)."""
        s = row % self.S
        if self._is_mbit(pool) or not self.ctx.is_local(s):
            return self.device
        return self.ctx.shard_device(s)

    def _write_row_dev(self, pool, row: int, data: torch.Tensor) -> None:
        if self._is_mbit(pool):
            WL = self._mbit_wl(pool)
            pm.msharded_row_write(self.ctx, words_local=WL)(
                pool.state, row, data.reshape(self.S, WL))
        else:
            pm.sharded_row_write(self.ctx, row_units=pool.row_units)(pool.state, row, data)

    @_locked
    def read_row(self, pool, row: int) -> np.ndarray:
        return self._host_view(self._read_row_dev(pool, row))

    @_locked
    def write_row(self, pool, row: int, data: np.ndarray) -> None:
        self._write_row_dev(pool, row,
                            self._to_device(pool, data, self._row_device(pool, row)))

    @_locked
    def zero_row(self, pool, row: int) -> None:
        for ix in pm.row_slices(pool.spec.kind, pool.row_units, self.S,
                                self._cfg.mbit_threshold_words, row):
            if self.ctx.is_local(ix[0]):
                pool.state[ix].zero_()

    @_locked
    def copy_row(self, src_pool, src_row: int, dst_pool, dst_row: int) -> None:
        """dst row = src row zero-padded to the dst row's width, on the
        device, whatever the two layouts (a bitset's size-class
        migration may move a tenant row into an m-sharded pool)."""
        src = self._read_row_dev(src_pool, src_row)
        dst = torch.zeros(dst_pool.row_units, dtype=src.dtype, device=src.device)
        dst[: src.shape[0]] = src
        self._write_row_dev(dst_pool, dst_row, dst)

    # -- bloom -------------------------------------------------------------------

    def _bloom_mixed_part(self, pool, rows, m_arr, k: int, h1m, h2m, is_add) -> LazyResult:
        """Partitioned host-hashed path: every single-bit Bloom op (adds
        are ``is_add`` ops, contains not) ships to its owner shard and runs
        the exact mixed op there."""
        fn = pm.psharded_bloom_mixed(self.ctx, k=k, words_per_row=pool.row_units)
        p = self._part(rows)
        (lr, a, b, m, add), valid = self._scatter_put(p, (
            (p.lrows, 0), (h1m, 0), (h2m, 0), (m_arr, 1), (is_add, 0)))
        add = pm.Blocks(x != 0 for x in add) if isinstance(add, pm.Blocks) else add != 0
        _, packed = fn(pool.state, lr, a, b, m, add, valid)
        return LazyResult(packed, transform=p.unpack_bools)

    @_locked
    def bloom_add(self, pool, rows, m_arr, k: int, h1m, h2m) -> LazyResult:
        return self._bloom_mixed_part(pool, rows, m_arr, k, h1m, h2m,
                                      np.ones(len(h1m), bool))

    @_locked
    def bloom_contains(self, pool, rows, m_arr, k: int, h1m, h2m) -> LazyResult:
        return self._bloom_mixed_part(pool, rows, m_arr, k, h1m, h2m,
                                      np.zeros(len(h1m), bool))

    @_locked
    def bloom_mixed(self, pool, rows, m_arr, k: int, h1m, h2m, is_add) -> LazyResult:
        return self._bloom_mixed_part(pool, rows, m_arr, k, h1m, h2m, is_add)

    def _bloom_st(self, pool, row, m, k, h1m, h2m, add: bool):
        B = len(h1m)
        return self._bloom_mixed_part(
            pool, np.full(B, row, np.int32), np.full(B, m, np.uint32), k,
            h1m, h2m, np.full(B, add, bool),
        )

    @_locked
    def bloom_add_fast_st(self, pool, row: int, m: int, k: int, h1m, h2m) -> LazyResult:
        """No single-tenant bit-delta path on a mesh (the row lives on one
        shard anyway): the exact mixed op, whose flags are exact
        sequential — a refinement of the fast add's pre-batch flags."""
        return self._bloom_st(pool, row, m, k, h1m, h2m, True)

    @_locked
    def bloom_contains_st(self, pool, row: int, m: int, k: int, h1m, h2m) -> LazyResult:
        return self._bloom_st(pool, row, m, k, h1m, h2m, False)

    def _bloom_mixed_keys_impl(self, pool, rows, m_arr, k: int, blocks, lengths,
                               is_add) -> LazyResult:
        """Partitioned device-hash path: key lanes ship to the owning shard
        only; murmur and the exact 64-bit mod run per shard."""
        wpr = pool.row_units
        blocks = np.asarray(blocks)
        blocks_t, L = _trim_lanes(blocks, self.obs)
        fn = pm.psharded_bloom_mixed_keys(self.ctx, k=k, words_per_row=wpr,
                                          target_lanes=L)
        B = blocks.shape[0]
        lengths = np.asarray(lengths, np.uint32)
        if lengths.ndim == 0:
            lengths = np.full(B, lengths, np.uint32)
        p = self._part(rows)
        (lr, bl, ln, m, add), valid = self._scatter_put(p, (
            (p.lrows, 0), (blocks_t, 0), (lengths, 0), (m_arr, 1), (is_add, 0)))
        add = pm.Blocks(a != 0 for a in add) if isinstance(add, pm.Blocks) else add != 0
        _, packed = fn(pool.state, lr, bl, ln, m, add, valid)
        return LazyResult(packed, transform=p.unpack_bools)

    @_locked
    def bloom_mixed_keys(self, pool, rows, m_arr, k: int, blocks, lengths, is_add) -> LazyResult:
        return self._bloom_mixed_keys_impl(pool, rows, m_arr, k, blocks, lengths, is_add)

    @_locked
    def bloom_mixed_keys_runs(self, pool, k: int, blocks, lengths, run_rows, run_m,
                              run_flags, run_starts) -> LazyResult:
        """The run-length form, expanded to per-op columns on the host
        (partitioning reorders ops, so runs cannot ride the H2D copy)."""
        counts = np.diff(np.asarray(run_starts, np.int64))
        B = int(counts.sum())
        if np.ndim(lengths) == 0:
            lengths = np.full(B, lengths, np.uint32)
        return self._bloom_mixed_keys_impl(
            pool, np.repeat(np.asarray(run_rows, np.int32), counts),
            np.repeat(np.asarray(run_m, np.uint32), counts), k,
            np.asarray(blocks)[:B], np.asarray(lengths, np.uint32)[:B],
            np.repeat(np.asarray(run_flags, bool), counts),
        )

    def _bloom_keys_st(self, pool, row, m, k, blocks, lengths, add: bool):
        B = blocks.shape[0]
        return self._bloom_mixed_keys_impl(
            pool, np.full(B, row, np.int32), np.full(B, m, np.uint32), k,
            blocks, lengths, np.full(B, add, bool),
        )

    @_locked
    def bloom_contains_keys_st(self, pool, row: int, m: int, k: int, blocks, lengths) -> LazyResult:
        return self._bloom_keys_st(pool, row, m, k, blocks, lengths, False)

    @_locked
    def bloom_add_keys_st(self, pool, row: int, m: int, k: int, blocks, lengths) -> LazyResult:
        """No single-tenant bit-delta path on a mesh (the row lives on one
        shard anyway): the exact mixed op, whose flags are exact
        sequential — a refinement of the bulk add's pre-call flags."""
        return self._bloom_keys_st(pool, row, m, k, blocks, lengths, True)

    @_locked
    def bloom_count(self, pool, row: int, m: int, k: int) -> LazyResult:
        wpr = pool.row_units
        x = pm.sharded_row_reduce(
            self.ctx, lambda local, lrow: bitops.popcount_row(local, lrow, wpr))(pool.state, row)
        return LazyResult(x, transform=lambda xv: bloom_count_from_bitcount(xv, m, k))

    # -- hll ---------------------------------------------------------------------

    def _hll_changed_part(self, pool, rows, c0, c1, c2):
        p = self._part(rows)
        (lr, a, b, c), valid = self._scatter_put(
            p, ((p.lrows, 0), (c0, 0), (c1, 0), (c2, 0)))
        _, packed = pm.psharded_hll_add_changed(self.ctx)(pool.state, lr, a, b, c, valid)
        return packed, p

    @_locked
    def hll_add(self, pool, rows, c0, c1, c2) -> LazyResult:
        self._hll_changed_part(pool, rows, c0, c1, c2)
        return LazyResult(True)

    @_locked
    def hll_add_changed(self, pool, rows, c0, c1, c2) -> LazyResult:
        packed, p = self._hll_changed_part(pool, rows, c0, c1, c2)
        return LazyResult(packed, transform=p.unpack_bools)

    @_locked
    def hll_add_single(self, pool, row: int, c0, c1, c2) -> LazyResult:
        rows = np.full(len(c0), row, np.int32)
        packed, p = self._hll_changed_part(pool, rows, c0, c1, c2)
        return LazyResult(packed, transform=lambda v: bool(np.any(p.unpack_bools(v))))

    @_locked
    def hll_add_keys_single(self, pool, row: int, blocks, lengths, chunk: int = 0) -> LazyResult:
        """Direct PFADD from raw codec lanes, hashed on the owner shard in
        one pass (``chunk`` is the single-device pass size; registers only
        grow, so one pass leaves the same registers and the same any)."""
        blocks = np.asarray(blocks)
        B = blocks.shape[0]
        if B == 0:
            return LazyResult(False)
        blocks_t, L = _trim_lanes(blocks, self.obs)
        p = self._part(np.full(B, row, np.int32))
        lengths = np.asarray(lengths, np.uint32)
        if lengths.ndim == 0:
            lengths = np.full(B, lengths, np.uint32)
        (lr, bl, ln), valid = self._scatter_put(
            p, ((p.lrows, 0), (blocks_t, 0), (lengths, 0)))
        _, packed = pm.psharded_hll_add_keys(self.ctx, target_lanes=L)(
            pool.state, lr, bl, ln, valid)
        return LazyResult(packed, transform=lambda v: bool(np.any(p.unpack_bools(v))))

    @_locked
    def hll_count(self, pool, row: int) -> LazyResult:
        hist = pm.sharded_row_reduce(self.ctx, hll_ops.hll_histogram)(pool.state, row)
        return LazyResult(hist,
                          transform=lambda h: int(round(golden.ertl_estimate(h))))

    @_locked
    def hll_merge(self, pool, dst_row: int, src_rows) -> LazyResult:
        pm.sharded_hll_merge(self.ctx)(pool.state, dst_row, np.asarray(src_rows, np.int64))
        return LazyResult(None)

    # -- bitset --------------------------------------------------------------------

    def _bitset_mixed_impl(self, pool, rows, idx, opcodes) -> LazyResult:
        ops_fill = bitset_ops.OP_GET  # padded ops read: the scratch keeps its bits
        if self._is_mbit(pool):
            WL = self._mbit_wl(pool)
            p, lidx = self._mpart(pool, idx)
            cols = ((rows, 0), (lidx, 0), (opcodes, ops_fill))
        else:
            WL = pool.row_units
            p = self._part(rows)
            cols = ((p.lrows, 0), (idx, 0), (opcodes, ops_fill))
        (r, i, op), valid = self._scatter_put(p, cols)
        _, packed = pm.psharded_bitset_mixed(self.ctx, words_per_row=WL)(
            pool.state, r, i, op, valid)
        return LazyResult(packed, transform=p.unpack_bools)

    @_locked
    def bitset_mixed(self, pool, rows, idx, opcodes) -> LazyResult:
        return self._bitset_mixed_impl(pool, rows, idx, opcodes)

    @_locked
    def bitset_mixed_runs(self, pool, idx, run_rows, run_ops, run_starts) -> LazyResult:
        """The run-length form, expanded to per-op columns on the host."""
        counts = np.diff(np.asarray(run_starts, np.int64))
        B = int(counts.sum())
        return self._bitset_mixed_impl(
            pool, np.repeat(np.asarray(run_rows, np.int32), counts),
            np.asarray(idx, np.uint32)[:B],
            np.repeat(np.asarray(run_ops, np.uint32), counts),
        )

    def _bitset_rw(self, kernel, pool, rows, idx) -> LazyResult:
        if self._is_mbit(pool):
            WL = self._mbit_wl(pool)
            p, lidx = self._mpart(pool, idx)
            cols = ((rows, 0), (lidx, 0))
        else:
            WL = pool.row_units
            p = self._part(rows)
            cols = ((p.lrows, 0), (idx, 0))
        (r, i), valid = self._scatter_put(p, cols)
        _, packed = pm.psharded_bitset_rw(self.ctx, kernel, words_per_row=WL)(
            pool.state, r, i, valid)
        return LazyResult(packed, transform=p.unpack_bools)

    @_locked
    def bitset_set(self, pool, rows, idx) -> LazyResult:
        return self._bitset_rw(bitset_ops.bitset_set, pool, rows, idx)

    @_locked
    def bitset_clear_bits(self, pool, rows, idx) -> LazyResult:
        return self._bitset_rw(bitset_ops.bitset_clear, pool, rows, idx)

    @_locked
    def bitset_flip(self, pool, rows, idx) -> LazyResult:
        return self._bitset_rw(bitset_ops.bitset_flip, pool, rows, idx)

    @_locked
    def bitset_get(self, pool, rows, idx) -> LazyResult:
        if self._is_mbit(pool):
            WL = self._mbit_wl(pool)
            p, lidx = self._mpart(pool, idx)
            cols = ((rows, 0), (lidx, 0))
        else:
            WL = pool.row_units
            p = self._part(rows)
            cols = ((p.lrows, 0), (idx, 0))
        (r, i), valid = self._scatter_put(p, cols)
        packed = pm.psharded_bitset_get(self.ctx, words_per_row=WL)(pool.state, r, i, valid)
        return LazyResult(packed, transform=p.unpack_bools)

    def _windows(self, pool):
        """Each shard's first global bit in an m-sharded row, and the
        window width."""
        win = self._mbit_wl(pool) * 32
        return np.arange(self.S, dtype=np.int64) * win, win

    @_locked
    def bitset_set_range(self, pool, row: int, from_bit: int, to_bit: int,
                         value: bool) -> LazyResult:
        if self._is_mbit(pool):
            WL = self._mbit_wl(pool)
            offs, win = self._windows(pool)
            fb = np.clip(int(from_bit) - offs, 0, win)
            tb = np.clip(int(to_bit) - offs, 0, win)
            pm.msharded_set_range(self.ctx, words_local=WL, value=value)(
                pool.state, row, fb, tb)
        else:
            pm.sharded_bitset_set_range(self.ctx, words_per_row=pool.row_units, value=value)(
                pool.state, row, from_bit, to_bit)
        return LazyResult(None)

    def _row_scalar(self, pool, row, local_fn, combine):
        """A whole-row scalar: on the owner shard for a tenant row; per
        shard, combined on the host, for an m-sharded row.
        ``local_fn(local_state, local_row, words)``."""
        if self._is_mbit(pool):
            WL = self._mbit_wl(pool)
            parts = pm.msharded_row_map(
                self.ctx, lambda local, r: local_fn(local, r, WL))(pool.state, row)
            return LazyResult(parts, transform=combine)
        wpr = pool.row_units
        x = pm.sharded_row_reduce(
            self.ctx, lambda local, lrow: local_fn(local, lrow, wpr))(pool.state, row)
        return LazyResult(x, transform=int)

    @_locked
    def bitset_cardinality(self, pool, row: int) -> LazyResult:
        return self._row_scalar(pool, row, bitops.popcount_row,
                                lambda v: int(np.sum(v)))

    @_locked
    def bitset_length(self, pool, row: int) -> LazyResult:
        win = self._mbit_wl(pool) * 32

        def combine(parts):
            glob = [s * win + int(p) for s, p in enumerate(np.asarray(parts)) if p > 0]
            return max(glob) if glob else 0

        return self._row_scalar(pool, row, bitops.bit_length_row, combine)

    @_locked
    def bitset_bitpos(self, pool, row: int, target_bit: int) -> LazyResult:
        win = self._mbit_wl(pool) * 32

        def combine(parts):
            parts = np.asarray(parts)
            if target_bit:
                hits = [s * win + int(p) for s, p in enumerate(parts) if p >= 0]
                return min(hits) if hits else -1
            # Target 0: a shard reporting ``win`` has a full window.
            for s, p in enumerate(parts):
                if p < win:
                    return s * win + int(p)
            return self.S * win

        return self._row_scalar(
            pool, row, lambda local, r, w: bitops.bitpos_row(local, r, w, target_bit), combine)

    @_locked
    def bitset_bitop(self, pool, dst_row: int, src_rows, op: str,
                     limit_bits=None) -> LazyResult:
        n_src = len(src_rows)
        masked = limit_bits is not None
        src = np.asarray(src_rows, np.int64)
        if self._is_mbit(pool):
            WL = self._mbit_wl(pool)
            offs, win = self._windows(pool)
            limit_local = np.clip((int(limit_bits) if masked else 0) - offs, 0, win)
            pm.msharded_bitop(self.ctx, words_local=WL, op=op, n_src=n_src,
                              masked=masked)(pool.state, dst_row, src, limit_local)
        else:
            pm.sharded_bitop(self.ctx, words_per_row=pool.row_units, op=op, n_src=n_src,
                             masked=masked)(pool.state, dst_row, src,
                                            int(limit_bits) if masked else 0)
        return LazyResult(None)

    @_locked
    def bitset_get_row(self, pool, row: int) -> LazyResult:
        return LazyResult(self._read_row_dev(pool, row), transform=_as_u32)

    # -- cms -----------------------------------------------------------------------

    def _cms_part(self, pool, rows, h1w, h2w, weights, d, w, mode):
        fn = pm.psharded_cms_update_estimate(
            self.ctx, d=d, w=w, cells_per_row=pool.row_units,
            estimate_only=(mode == "est"), update_only=(mode == "upd"))
        p = self._part(rows)
        (lr, a, b, wt), valid = self._scatter_put(
            p, ((p.lrows, 0), (h1w, 0), (h2w, 0), (weights, 0)))
        out = fn(pool.state, lr, a, b, wt, valid)
        if mode == "upd":
            return LazyResult(None)
        est = out if mode == "est" else out[1]
        return LazyResult(est, transform=lambda v: _as_u32(p.gather_vals(v)))

    @_locked
    def cms_update_estimate(self, pool, rows, h1w, h2w, weights, d: int, w: int) -> LazyResult:
        """Coalesced CMS path: updates then batch-final estimates."""
        return self._cms_part(pool, rows, h1w, h2w, weights, d, w, "updest")

    @_locked
    def cms_estimate(self, pool, rows, h1w, h2w, d: int, w: int) -> LazyResult:
        zeros = np.zeros(len(rows), np.uint32)
        return self._cms_part(pool, rows, h1w, h2w, zeros, d, w, "est")

    @_locked
    def cms_update_estimate_seq(self, pool, row: int, h1w, h2w, weights, d: int, w: int) -> LazyResult:
        """K1 on one tenant's table, taken from its owner shard and written
        back (the engine does not route here while sharded:
        ``supports_seq_cms`` is False)."""
        B = h1w.shape[0]
        view = bitops.row_slice(pool.state[row % self.S], row // self.S, pool.row_units)
        a, b, wt = self._op_cols(B, h1w, h2w, weights, device=view.device)
        table = view[: d * w].clone()
        if self.device.type == "cuda" and not _build.loaded("cms_seq"):
            _note_first_launch(("k1.build", str(self.device)))
        est = cms_seq.cms_update_estimate_seq(table, a, b, wt, d=d, w=w)
        view[: d * w].copy_(table)
        return LazyResult(est, transform=_as_u32)

    @_locked
    def cms_merge(self, pool, dst_row: int, src_rows) -> LazyResult:
        pm.sharded_cms_merge(self.ctx, cells_per_row=pool.row_units)(
            pool.state, dst_row, np.asarray(src_rows, np.int64))
        return LazyResult(None)
