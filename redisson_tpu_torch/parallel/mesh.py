"""Sharded op builders: the mesh bodies of the sharded executor.

Counterpart of ``redisson_tpu/parallel/mesh.py``.  The JAX package runs
each builder as a ``shard_map`` over a 1-D mesh of one shard per device,
over the devices of every process.  Here a mesh is S LOGICAL shards laid
on D placements in each of P processes: shard s sits on global placement
``s // (S / (D*P))``, contiguous blocks, so D*P = S is the JAX package's
one shard per device.  Each placement holds one ``[S/(D*P), local_len]``
tensor on its own device (``PlacedState``); at D = P = 1 the pool is the
single ``[S, local_len]`` stack.  A device list that repeats a device
gives separate placements on that device.  Every builder returns a plain
function over tensors whose body runs the single-device op of ``ops/``
on each of this process's shards in turn.

State layout, identical to the JAX package's so pool bytes match: a
``[S, local_len]`` array (the placements' blocks in order); each shard's
row is a flat ``[rows_local * row_units + 1]`` pool with its own
trailing scratch element.  Tenant row r lives on shard ``r % S`` at
local row ``r // S``.  A giant single-tenant bitmap (m-sharding) splits
its words instead: global word g of a row lives on shard ``g // W_local``.

How the ``shard_map`` forms translate:

- ``state[0]`` inside a shard body is ``state[s]`` here, a contiguous
  view: the ops of ``ops/`` update pools in place, so writes through it
  land in the placement's block.  Every shard runs its body, including
  shards with no real op: padded ops touch each shard's scratch element
  exactly as they do on the mesh, so the scratch words stay byte-equal.
- ``lax.axis_index("shard")`` is the loop index ``s``.
- ``psum`` of owner-masked values is the owner's value (or the OR / sum
  over the shards); ``pmax`` of source rows is a max over the rows
  gathered from their owners.  A value crosses placements as a copy to
  the device that needs it (``Tensor.to``: a peer copy between cards),
  and processes as a broadcast from its owner (``ProcessGroup``).
- Per-shard result blocks come back one per placement (``Blocks``);
  across processes they are all-gathered, so every process holds the
  whole answer (the JAX package's ``ensure_addressable``).

Inputs may be numpy arrays or tensors; uint32 values travel as int64 in
``[0, 2**32)`` or as int32 bit-views (the ops read both).  Builders with
``out_state`` return the (updated-in-place) state first, as the JAX ones
return the new state.
"""

from __future__ import annotations

import numpy as np
import torch

from redisson_tpu_torch.ops import bitops, bloom, cms as cms_ops, hll as hll_ops
from redisson_tpu_torch.ops import bitset as bitset_ops, fastpath
from redisson_tpu_torch.ops.golden import HLL_M
from redisson_tpu_torch.utils import hashing

# Element types a broadcast header can name (bool travels as uint8).
_WIRE_DTYPES = (torch.int32, torch.int64, torch.uint8, torch.bool,
                torch.float32, torch.float64)
_MAX_DIMS = 6


class Blocks(list):
    """A result held as one tensor per placement of a mesh, in shard
    order: it reaches the host block by block and concatenates there
    along its first axis."""

    def to_host(self) -> np.ndarray:
        return np.concatenate([b.cpu().numpy() for b in self])


class ProcessGroup:
    """This process's part in the torch.distributed group a mesh spans:
    its rank, the group's size, and the device its collectives run on —
    this process's card under nccl; host memory under gloo, so operands
    on a card are staged through the host.  A failed collective raises
    (torch.distributed's error): no process carries on alone."""

    def __init__(self, rank: int, size: int, backend: str, device):
        self.rank, self.size, self.backend = int(rank), int(size), str(backend)
        self.device = torch.device(device) if self.backend == "nccl" else torch.device("cpu")

    @classmethod
    def current(cls, device) -> "ProcessGroup":
        """The default group the engine joined (objects/engines.py)."""
        import torch.distributed as dist

        return cls(dist.get_rank(), dist.get_world_size(), dist.get_backend(), device)

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        dtype = torch.uint8 if t.dtype == torch.bool else t.dtype
        return t.to(self.device, dtype).contiguous().clone()

    def broadcast(self, t, src: int) -> torch.Tensor:
        """``t`` of rank ``src`` on every rank (None elsewhere): a fixed
        header (type and shape) first, then the payload."""
        import torch.distributed as dist

        hdr = [0] * (2 + _MAX_DIMS)
        if self.rank == src:
            if t.dim() > _MAX_DIMS:
                raise ValueError(f"cannot broadcast a {t.dim()}-d tensor")
            hdr[0], hdr[1] = _WIRE_DTYPES.index(t.dtype), t.dim()
            hdr[2 : 2 + t.dim()] = list(t.shape)
        hdr_t = torch.tensor(hdr, dtype=torch.int64).to(self.device)
        dist.broadcast(hdr_t, src)
        code, nd, *dims = hdr_t.tolist()
        dtype = _WIRE_DTYPES[code]
        if self.rank == src:
            buf = self._wire(t)
        else:
            buf = torch.empty(dims[:nd], device=self.device,
                              dtype=torch.uint8 if dtype == torch.bool else dtype)
        dist.broadcast(buf, src)
        return buf.to(torch.bool) if dtype == torch.bool else buf

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (one shape on all), concatenated in rank
        order along the first axis."""
        import torch.distributed as dist

        buf = self._wire(t)
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf)
        out = torch.cat(parts)
        return out.to(torch.bool) if t.dtype == torch.bool else out

    def all_reduce_or(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        buf = self._wire(t)
        dist.all_reduce(buf, op=dist.ReduceOp.MAX)
        return buf.to(torch.bool)


class MeshContext:
    """The device mesh: S logical shards on this process's placements
    (``devices``, one block each) in each process of ``group`` (None:
    this process alone).  More devices than a process's S/P shards: the
    first S/P are used, as the JAX package takes ``devices[:n_shards]``."""

    def __init__(self, devices=None, n_shards: int | None = None,
                 group: ProcessGroup | None = None):
        if devices is None:
            devices = ["cuda"]
        if isinstance(devices, (str, torch.device)):
            devices = [devices]
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("a mesh needs at least one device")
        P = 1 if group is None else group.size
        S = len(devices) * P if n_shards is None else int(n_shards)
        if S < 1:
            raise ValueError(f"n_shards must be >= 1, got {S}")
        devices = devices[: max(1, S // P)]
        D = len(devices)
        if S % (D * P):
            where = f"{D} placements" + (f" in each of {P} processes" if P > 1 else "")
            raise ValueError(
                f"{S} shards do not split evenly over {where}: num_shards "
                f"must be a multiple of {D * P}"
            )
        self.group = group
        self.devices = devices
        self.device = devices[0]
        self.n_shards = S
        self.n_processes = P
        self.rank = 0 if group is None else group.rank
        self.per = S // (D * P)  # shards per placement
        self.lo = self.rank * (S // P)  # this process's shards: [lo, hi)
        self.hi = self.lo + S // P
        # One block per placement only when there is more than one: the
        # single stack of one process on one placement stays a tensor.
        self.placed = D > 1 or P > 1

    # -- where shards live ---------------------------------------------------

    def placements(self) -> list:
        """(index, device, global shards) of this process's placements."""
        return [(j, d, range(self.lo + j * self.per, self.lo + (j + 1) * self.per))
                for j, d in enumerate(self.devices)]

    def owner(self, s: int) -> int:
        """The process holding shard ``s``."""
        return s // (self.n_shards // self.n_processes)

    def is_local(self, s: int) -> bool:
        return self.lo <= s < self.hi

    def locate(self, s: int) -> tuple:
        """(placement, row in its block) of a shard this process holds."""
        if not self.is_local(s):
            raise ValueError(f"shard {s} is held by process {self.owner(s)}, "
                             f"not by process {self.rank}")
        return divmod(s - self.lo, self.per)

    def shard_device(self, s: int):
        return self.devices[self.locate(s)[0]]

    def local_shards(self) -> list:
        """(global shard, device) of every shard this process holds."""
        return [(s, d) for _, d, shards in self.placements() for s in shards]

    # -- state and operands --------------------------------------------------

    def make_state(self, local_len: int, dtype):
        """A zeroed ``[S, local_len]`` pool (``dtype`` a torch dtype)."""
        if not self.placed:
            return torch.zeros((self.n_shards, local_len), dtype=dtype,
                               device=self.device)
        return PlacedState(self, [torch.zeros((self.per, local_len), dtype=dtype,
                                              device=d) for d in self.devices])

    def tensor(self, x, device=None):
        """``x`` on ``device`` (the mesh's first by default): numpy
        uint32 becomes int64 lanes, a tensor moves as it is."""
        dev = self.device if device is None else device
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        a = np.asarray(x)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        return torch.as_tensor(a, device=dev)

    # -- results across placements and processes ------------------------------

    def collect(self, outs: list):
        """Per-placement ``[S/(D*P), ...]`` result blocks as the caller's
        result: the one block of a single stack; ``Blocks`` over several
        placements; across processes, all-gathered to ``[S, ...]``."""
        if not self.placed:
            return outs[0]
        if self.group is None:
            return Blocks(outs)
        g = self.group
        return g.all_gather(torch.cat([o.to(g.device) for o in outs]))

    def reduce_or(self, outs: list) -> torch.Tensor:
        """OR of per-placement bool tensors, over every process."""
        out = outs[0]
        for o in outs[1:]:
            out = out | o.to(out.device)
        if self.group is not None:
            out = self.group.all_reduce_or(out).to(self.device)
        return out

    def from_owner(self, s: int, fn, device=None) -> torch.Tensor:
        """``fn()`` (a tensor) computed where shard ``s`` lives, on every
        process: a broadcast from its owner across processes.  Moved to
        ``device`` when one is given."""
        if self.group is None:
            t = fn()
        else:
            t = self.group.broadcast(fn() if self.is_local(s) else None, self.owner(s))
        return t if device is None else t.to(device)


class PlacedState:
    """A ``[S, local_len]`` pool as this process's placements hold it:
    one ``[S/(D*P), local_len]`` block per placement.  ``state[s]`` and
    ``state[s, cols]`` index a local shard's row as a view, as on the
    single stack; ``shape`` is the whole pool's."""

    __slots__ = ("ctx", "blocks")

    def __init__(self, ctx: MeshContext, blocks):
        self.ctx = ctx
        self.blocks = list(blocks)

    @property
    def shape(self) -> tuple:
        return (self.ctx.n_shards,) + tuple(self.blocks[0].shape[1:])

    @property
    def dtype(self):
        return self.blocks[0].dtype

    @property
    def device(self):
        return self.blocks[0].device

    @property
    def _version(self) -> int:
        """Changes with any in-place write to a block or a view of one
        (the dispatch wrapper's retry guard)."""
        return sum(b._version for b in self.blocks)

    def numel(self) -> int:
        """Elements this process holds."""
        return sum(b.numel() for b in self.blocks)

    def element_size(self) -> int:
        return self.blocks[0].element_size()

    def __getitem__(self, ix):
        s, rest = (ix[0], ix[1:]) if isinstance(ix, tuple) else (ix, ())
        j, i = self.ctx.locate(int(s))
        return self.blocks[j][(i,) + rest]


# --------------------------------------------------------------------------
# Pool layouts: the one rule for where a row's words live at S shards and
# m-shard threshold ``thresh``.  The sharded executor sizes and indexes its
# device state with it; snapshot, restore and reshard decode and encode
# host arrays of any topology with it.
# --------------------------------------------------------------------------

_BITSET = "bitset"  # tenancy.PoolKind.BITSET


def mbit_layout(kind: str, row_units: int, S: int, thresh: int) -> bool:
    """Whether rows of this kind and width split their words over the S
    shards (m-sharding): BitSet rows at or above the threshold whose
    words divide evenly.  At S = 1 both layouts are the flat pool."""
    return kind == _BITSET and row_units >= thresh and row_units % S == 0


def local_units(kind: str, row_units: int, capacity: int, S: int,
                thresh: int) -> int:
    """Data elements of a pool on each shard, its scratch element
    excluded."""
    if S == 1:
        return capacity * row_units
    if mbit_layout(kind, row_units, S, thresh):
        return capacity * (row_units // S)
    return capacity // S * row_units


def layout_shape(kind: str, row_units: int, capacity: int, S: int,
                 thresh: int) -> tuple:
    """Array shape of a pool: flat at S = 1, else ``[S, local + 1]``."""
    local = local_units(kind, row_units, capacity, S, thresh) + 1
    return (local,) if S == 1 else (S, local)


def row_slices(kind: str, row_units: int, S: int, thresh: int, row: int) -> list:
    """Where one row's words live in a pool array of this layout: index
    tuples, in the row's flat word order."""
    u = row_units
    if S == 1:
        return [(slice(row * u, (row + 1) * u),)]
    if mbit_layout(kind, u, S, thresh):
        wl = u // S
        return [(s, slice(row * wl, (row + 1) * wl)) for s in range(S)]
    local = row // S
    return [(row % S, slice(local * u, (local + 1) * u))]


def read_host_row(arr: np.ndarray, kind: str, row_units: int, S: int,
                  thresh: int, row: int) -> np.ndarray:
    """One row's words out of a host pool array of this layout."""
    parts = [arr[ix] for ix in row_slices(kind, row_units, S, thresh, row)]
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def write_host_row(arr: np.ndarray, kind: str, row_units: int, S: int,
                   thresh: int, row: int, data) -> None:
    """Inverse of ``read_host_row``: ``data`` into ``row``'s place."""
    data = np.asarray(data)[:row_units]
    off = 0
    for ix in row_slices(kind, row_units, S, thresh, row):
        n = ix[-1].stop - ix[-1].start
        arr[ix] = data[off : off + n]
        off += n


def _row_data(ctx, data, device=None):
    """Row payload in the pool's element type on ``device``: uint32
    words as int32 bit-views, uint8 registers as they are."""
    dev = ctx.device if device is None else device
    if isinstance(data, torch.Tensor):
        return data.to(dev)
    a = np.ascontiguousarray(data)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(a, device=dev)


def _rows_of(ctx, rows, dev):
    """(shard, local row) int64 tensors of tenant rows, on ``dev``."""
    rows = ctx.tensor(rows, dev).to(torch.int64)
    return rows % ctx.n_shards, rows // ctx.n_shards


def _valid(ctx, valid, n: int, dev):
    if valid is None:
        return torch.ones(n, dtype=torch.bool, device=dev)
    return ctx.tensor(valid, dev).to(torch.bool)


def _u32s(ctx, dev, *cols):
    return [hashing.u32(ctx.tensor(c, dev)) for c in cols]


# --------------------------------------------------------------------------
# Tenant-sharded Bloom / HLL (replicate-and-mask: every shard sees every
# op and keeps the ones it owns)
# --------------------------------------------------------------------------


def sharded_bloom_add(ctx: MeshContext, *, k: int, words_per_row: int,
                      pack_results: bool = False):
    """fn(state[S, L], rows, h1m, h2m, m_arr, valid) -> (state, newly
    bool[B]) with exact single-device semantics; ``pack_results`` packs
    newly 32 per word."""

    def fn(state, rows, h1m, h2m, m_arr, valid):
        outs = []
        for _, dev, shards in ctx.placements():
            shard, lrows = _rows_of(ctx, rows, dev)
            a, b, m = _u32s(ctx, dev, h1m, h2m, m_arr)
            v = _valid(ctx, valid, a.shape[0], dev)
            out = torch.zeros(a.shape[0], dtype=torch.bool, device=dev)
            for s in shards:
                own = (shard == s) & v
                newly = bloom.bloom_add(state[s], lrows, a, b, m=m, k=k,
                                        words_per_row=words_per_row, valid=own)
                out |= own & newly
            outs.append(out)
        out = ctx.reduce_or(outs)
        return state, (bitops.pack_bool_u32(out) if pack_results else out)

    return fn


def sharded_bloom_contains(ctx: MeshContext, *, k: int, words_per_row: int,
                           pack_results: bool = False):
    def fn(state, rows, h1m, h2m, m_arr, valid):
        outs = []
        for _, dev, shards in ctx.placements():
            shard, lrows = _rows_of(ctx, rows, dev)
            a, b, m = _u32s(ctx, dev, h1m, h2m, m_arr)
            v = _valid(ctx, valid, a.shape[0], dev)
            out = torch.zeros(a.shape[0], dtype=torch.bool, device=dev)
            for s in shards:
                own = (shard == s) & v
                res = bloom.bloom_contains(state[s], torch.where(own, lrows, 0),
                                           a, b, m=m, k=k,
                                           words_per_row=words_per_row)
                out |= own & res
            outs.append(out)
        out = ctx.reduce_or(outs)
        return bitops.pack_bool_u32(out) if pack_results else out

    return fn


def sharded_hll_add(ctx: MeshContext):
    def fn(state, rows, c0, c1, c2, valid):
        for _, dev, shards in ctx.placements():
            shard, lrows = _rows_of(ctx, rows, dev)
            a, b, c = (ctx.tensor(x, dev) for x in (c0, c1, c2))
            v = _valid(ctx, valid, a.shape[0], dev)
            for s in shards:
                own = (shard == s) & v
                hll_ops.hll_add(state[s], torch.where(own, lrows, 0), a, b, c,
                                valid=own)
        return state

    return fn


def sharded_hll_histogram(ctx: MeshContext):
    """PFCOUNT path: the row lives on one shard (the others contribute
    zeros to the JAX package's psum)."""

    def fn(state, row):
        row = int(row)
        s = row % ctx.n_shards
        return ctx.from_owner(
            s, lambda: hll_ops.hll_histogram(state[s], row // ctx.n_shards))

    return fn


# --------------------------------------------------------------------------
# m-sharded giant bitmap (config 3: 2^30-bit RBitSet)
# --------------------------------------------------------------------------


def _mbit_words(ctx, idx, s: int, words_local: int, dev):
    """(owned mask, local word, bit) of global bit indexes on shard s;
    the word math runs in int64 (uint32 lacks ``>>`` and ``//``)."""
    idx = hashing.u32(ctx.tensor(idx, dev))
    gword, bit = idx >> 5, idx & 31
    own = (gword // words_local) == s
    return own, gword - s * words_local, bit


def sharded_mbit_set(ctx: MeshContext, *, words_local: int):
    """SETBIT batch on a bitmap sharded along words.  fn(state[S,
    words_local+1], idx, valid) -> (state, prev bool[B])."""

    def fn(state, idx, valid):
        n = np.shape(idx)[0]
        outs = []
        for _, dev, shards in ctx.placements():
            v = _valid(ctx, valid, n, dev)
            out = torch.zeros(n, dtype=torch.bool, device=dev)
            for s in shards:
                own, lword, bit = _mbit_words(ctx, idx, s, words_local, dev)
                own = own & v
                lword = bitops.route_invalid_to_scratch(lword, own, words_local + 1)
                prev = bitops.scatter_set_bits(state[s], lword, bit)
                out |= own & (prev != 0)
            outs.append(out)
        return state, ctx.reduce_or(outs)

    return fn


def sharded_mbit_get(ctx: MeshContext, *, words_local: int):
    def fn(state, idx):
        n = np.shape(idx)[0]
        outs = []
        for _, dev, shards in ctx.placements():
            out = torch.zeros(n, dtype=torch.bool, device=dev)
            for s in shards:
                own, lword, bit = _mbit_words(ctx, idx, s, words_local, dev)
                res = bitops.gather_bits(state[s], torch.where(own, lword, 0), bit)
                out |= own & (res != 0)
            outs.append(out)
        return ctx.reduce_or(outs)

    return fn


# --------------------------------------------------------------------------
# Partition-by-owner builders: the host splits each batch by owner shard
# into [S, Bp] op blocks (executor/sharded_executor.py ``_Partition``), so
# shard s runs only its own ops and per-op results come back [S, Bp]
# (bit-packed [S, Bp/32]) with no collective at all within a process.
# --------------------------------------------------------------------------


def _block(ctx, col, j: int, shards: range, dev):
    """The rows of placement ``j``'s shards of a column: its entry of a
    per-placement ``Blocks`` (the executor ships them so), or a slice of
    a whole ``[S, ...]`` column moved to ``dev``."""
    if isinstance(col, Blocks):
        return col[j]
    return ctx.tensor(col[shards.start : shards.stop], dev)


def _psharded(ctx: MeshContext, inner, *, out_state: bool):
    """fn(state, *cols) running ``inner(local_state, *shard_cols)`` on
    every shard of this process; results stack to ``[S, ...]`` per
    placement (``MeshContext.collect``)."""

    def fn(state, *cols):
        outs = []
        for j, dev, shards in ctx.placements():
            pc = [_block(ctx, c, j, shards, dev) for c in cols]
            outs.append(torch.stack([inner(state[s], *(c[i] for c in pc))
                                     for i, s in enumerate(shards)]))
        res = ctx.collect(outs)
        return (state, res) if out_state else res

    return fn


def psharded_bloom_mixed(ctx: MeshContext, *, k: int, words_per_row: int):
    """fn(state, lrows, h1m, h2m, m, is_add, valid) -> (state,
    packed[S, Bp/32]); every column [S, Bp], rows already shard-local."""

    def inner(local, lrows, h1m, h2m, m_arr, is_add, valid):
        m_arr = hashing.u32(m_arr)
        res = bloom.bloom_mixed(local, lrows, hashing.u32(h1m), hashing.u32(h2m),
                                is_add, m=m_arr, k=k,
                                words_per_row=words_per_row, valid=valid)
        return bitops.pack_bool_u32(res)

    return _psharded(ctx, inner, out_state=True)


def psharded_bloom_mixed_keys(ctx: MeshContext, *, k: int, words_per_row: int,
                              target_lanes: int):
    """Device-hash variant: raw codec lanes [S, Bp, L] hash per shard."""

    def inner(local, lrows, blocks, lengths, m_arr, is_add, valid):
        res = fastpath.bloom_mixed_keys(
            local, lrows, blocks, lengths, m_arr, is_add, valid,
            k=k, words_per_row=words_per_row, target_lanes=target_lanes,
        )
        return bitops.pack_bool_u32(res)

    return _psharded(ctx, inner, out_state=True)


def psharded_bitset_mixed(ctx: MeshContext, *, words_per_row: int):
    def inner(local, lrows, idx, opcodes, valid):
        obs = bitset_ops.bitset_mixed(local, lrows, idx, opcodes,
                                      words_per_row=words_per_row, valid=valid)
        return bitops.pack_bool_u32(obs)

    return _psharded(ctx, inner, out_state=True)


def psharded_bitset_rw(ctx: MeshContext, kernel, *, words_per_row: int):
    """set / clear / flip: ``kernel`` is ``bitset_ops.bitset_set`` etc."""

    def inner(local, lrows, idx, valid):
        prev = kernel(local, lrows, idx, words_per_row=words_per_row, valid=valid)
        return bitops.pack_bool_u32(prev)

    return _psharded(ctx, inner, out_state=True)


def psharded_bitset_get(ctx: MeshContext, *, words_per_row: int):
    def inner(local, lrows, idx, valid):
        res = bitset_ops.bitset_get(local, torch.where(valid, lrows, 0), idx,
                                    words_per_row=words_per_row)
        return bitops.pack_bool_u32(res & valid)

    return _psharded(ctx, inner, out_state=False)


def psharded_hll_add_changed(ctx: MeshContext):
    def inner(local, lrows, c0, c1, c2, valid):
        changed = hll_ops.hll_add_changed(local, torch.where(valid, lrows, 0),
                                          c0, c1, c2, valid=valid)
        return bitops.pack_bool_u32(changed)

    return _psharded(ctx, inner, out_state=True)


def psharded_hll_add_keys(ctx: MeshContext, *, target_lanes: int):
    """Device-hash PFADD: murmur per shard, then the scatter-max with
    changed flags."""

    def inner(local, lrows, blocks, lengths, valid):
        c0, c1, c2, _ = hashing.murmur3_x86_128_torch(
            fastpath.pad_lanes(blocks, target_lanes), lengths
        )
        changed = hll_ops.hll_add_changed(local, torch.where(valid, lrows, 0),
                                          c0, c1, c2, valid=valid)
        return bitops.pack_bool_u32(changed)

    return _psharded(ctx, inner, out_state=True)


def psharded_cms_update_estimate(ctx: MeshContext, *, d: int, w: int,
                                 cells_per_row: int, estimate_only: bool = False,
                                 update_only: bool = False):
    """Three modes: update+estimate -> (state, est[S, Bp]);
    ``estimate_only`` -> est[S, Bp]; ``update_only`` -> state.  Estimates
    are int32 bit-views, 0 for padded ops."""

    def inner(local, lrows, h1w, h2w, weights, valid):
        safe_rows = torch.where(valid, lrows, 0)
        if not estimate_only:
            wts = torch.where(valid, hashing.u32(weights), 0)
            cms_ops.cms_update(local, safe_rows, h1w, h2w, wts, d=d, w=w,
                               cells_per_row=cells_per_row)
        if update_only:
            return torch.zeros(0, dtype=torch.int32, device=local.device)
        est = cms_ops.cms_estimate(local, safe_rows, h1w, h2w, d=d, w=w,
                                   cells_per_row=cells_per_row)
        return torch.where(valid, est, 0)

    body = _psharded(ctx, inner, out_state=not estimate_only)
    if update_only:
        return lambda state, *cols: body(state, *cols)[0]
    return body


# --------------------------------------------------------------------------
# m-sharded multi-tenant bitset pools (config 3): rows at or above
# Config.mbit_threshold_words split their WORDS contiguously across
# shards — global word g of row r lives on shard g // W_local at local row
# r.  Batch ops reuse the psharded_* builders with local coordinates; the
# builders below cover the whole-row ops, which are shard-local.
# --------------------------------------------------------------------------


def msharded_row_map(ctx: MeshContext, fn_local):
    """``fn_local(local_state, row)`` per shard over its word slice;
    results stack to [S, ...] (``MeshContext.collect``) for the host to
    combine."""

    def fn(state, row):
        row = int(row)
        return ctx.collect([
            torch.stack([torch.as_tensor(fn_local(state[s], row)) for s in shards])
            for _, _, shards in ctx.placements()
        ])

    return fn


def msharded_row_write(ctx: MeshContext, *, words_local: int):
    """Overwrite one row: ``data`` arrives pre-split [S, W_local]."""

    def fn(state, row, data):
        row = int(row)
        for s, dev in ctx.local_shards():
            bitops.row_update(state[s], row, _row_data(ctx, data[s], dev), words_local)
        return state

    return fn


def msharded_set_range(ctx: MeshContext, *, words_local: int, value: bool):
    """Range set/clear: the host clips the global [from, to) to each
    shard's window (``fb``/``tb`` per shard)."""

    def fn(state, row, fb, tb):
        row = int(row)
        for s, _ in ctx.local_shards():
            bitset_ops.bitset_set_range(state[s], row, int(fb[s]), int(tb[s]),
                                        words_per_row=words_local, value=value)
        return state

    return fn


def msharded_bitop(ctx: MeshContext, *, words_local: int, op: str, n_src: int,
                   masked: bool = False):
    """BITOP on m-sharded rows: every operand's words for a shard are
    local to it.  ``limit`` arrives per shard (the NOT mask clipped to the
    local window)."""

    def fn(state, dst_row, src_rows, limit):
        for _, dev, shards in ctx.placements():
            src = ctx.tensor(src_rows, dev).to(torch.int64)
            assert src.shape[0] == n_src
            for s in shards:
                bitset_ops.bitset_bitop_rows(
                    state[s], int(dst_row), src, words_per_row=words_local, op=op,
                    limit_bits=int(limit[s]) if masked else None,
                )
        return state

    return fn


# --------------------------------------------------------------------------
# Cross-shard collectives: PFMERGE / BITOP / CMS.MERGE between rows on
# different shards, and the owner-computes row ops
# --------------------------------------------------------------------------


def _gather_rows(ctx, state, rows, units: int, device):
    """[n, units] copies of tenant rows on ``device``, each read on its
    owner shard (the masked psum broadcast of the JAX package): a peer
    copy from another placement, a broadcast from another process."""
    S = ctx.n_shards
    return torch.stack([
        ctx.from_owner(r % S, lambda r=r: bitops.row_slice(state[r % S], r // S, units),
                       device)
        for r in (int(x) for x in np.asarray(rows).reshape(-1))
    ])


def _dst(ctx, row: int):
    """(shard, held here, device) of a destination row: sources travel
    to its device; another process's destination only sends."""
    s = row % ctx.n_shards
    local = ctx.is_local(s)
    return s, local, ctx.shard_device(s) if local else ctx.device


def sharded_hll_merge(ctx: MeshContext):
    """dst_row <- max(dst_row, src rows), rows anywhere on the mesh."""
    S = ctx.n_shards

    def fn(state, dst_row, src_rows):
        dst_row = int(dst_row)
        s, local, dev = _dst(ctx, dst_row)
        merged = _gather_rows(ctx, state, src_rows, HLL_M, dev)
        if local:
            hll_ops.hll_merge_rows(state[s], dst_row // S, merged)
        return state

    return fn


def sharded_bitop(ctx: MeshContext, *, words_per_row: int, op: str, n_src: int,
                  masked: bool = False):
    """BITOP across shards: operand rows gathered from their owners, the
    op computed, only the dst owner writes.  ``masked`` (NOT): the
    complement is ANDed with a [0, limit) mask."""
    S = ctx.n_shards

    def fn(state, dst_row, src_rows, limit):
        dst_row = int(dst_row)
        s, local, dev = _dst(ctx, dst_row)
        full = _gather_rows(ctx, state, src_rows, words_per_row, dev)
        assert full.shape[0] == n_src
        if local:
            bitset_ops.bitset_bitop(state[s], dst_row // S, full,
                                    words_per_row=words_per_row, op=op,
                                    limit_bits=int(limit) if masked else None)
        return state

    return fn


def sharded_bitset_set_range(ctx: MeshContext, *, words_per_row: int, value: bool):
    S = ctx.n_shards

    def fn(state, row, from_bit, to_bit):
        row = int(row)
        if ctx.is_local(row % S):
            bitset_ops.bitset_set_range(state[row % S], row // S, int(from_bit),
                                        int(to_bit), words_per_row=words_per_row,
                                        value=value)
        return state

    return fn


def sharded_row_reduce(ctx: MeshContext, fn_local):
    """Owner computes: ``fn_local(local_state, local_row)`` runs on the
    row's shard (the others' zeros add nothing to the JAX psum), and its
    value reaches every process.  Serves BITCOUNT, length, bitpos and the
    HLL histogram."""
    S = ctx.n_shards

    def fn(state, row):
        row = int(row)
        return ctx.from_owner(row % S, lambda: fn_local(state[row % S], row // S))

    return fn


def sharded_row_read(ctx: MeshContext, *, row_units: int):
    """A copy of one tenant row, read on its owner."""
    S = ctx.n_shards

    def fn(state, row):
        row = int(row)
        return ctx.from_owner(
            row % S, lambda: bitops.row_slice(state[row % S], row // S, row_units).clone())

    return fn


def sharded_row_write(ctx: MeshContext, *, row_units: int):
    """Overwrite one tenant row (only its owner changes)."""
    S = ctx.n_shards

    def fn(state, row, data):
        row = int(row)
        s = row % S
        if ctx.is_local(s):
            bitops.row_update(state[s], row // S,
                              _row_data(ctx, data, ctx.shard_device(s)), row_units)
        return state

    return fn


def sharded_cms_merge(ctx: MeshContext, *, cells_per_row: int):
    """CMS.MERGE: the source rows gathered from their owners and summed
    (mod 2**32, a CMS is linear) into the dst owner's row."""
    S = ctx.n_shards

    def fn(state, dst_row, src_rows):
        dst_row = int(dst_row)
        s, local, dev = _dst(ctx, dst_row)
        full = _gather_rows(ctx, state, src_rows, cells_per_row, dev)
        if local:
            cms_ops.cms_merge_rows(state[s], dst_row // S, full,
                                   cells_per_row=cells_per_row)
        return state

    return fn
