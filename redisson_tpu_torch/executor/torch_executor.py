"""TorchCommandExecutor — the device boundary of the sketch engine.

Counterpart of ``redisson_tpu/executor/tpu_executor.py``:

- pool state is one flat tensor per size class on the executor's
  ``torch.device`` in the JAX package's layout: uint32 words held as
  int32 bit-views, or uint8 HyperLogLog registers (``state_to_host``
  returns identical bytes);
- op batches are padded to power-of-two buckets (``_bucket``) and packed
  into ONE host block per flush, copied to the device in one H2D
  (pinned memory on CUDA);
- kernels update pool state in place under the dispatch lock;
- results come back as ``LazyResult``: a device tensor (or one block per
  placement of a mesh) plus a transform, copied to the host on
  ``.result()``;
- the executor's devices are a slice of the local cards
  (``executor_devices``: ``device_indices``, or this process's share of
  the cards); the first is the single-device executor's device, and the
  sharded executor places its shards on all of them;
- the dispatch wrapper ``_locked`` is the chaos point
  ``dispatch.<method>``, sheds ops whose ambient deadline lapsed before
  they reach the device, and turns a failure after the method's first
  in-place pool write into ``NonRetryableDispatchError``, so no retry
  applies an op twice.  The ``fetch`` and ``h2d.staging`` chaos points
  sit at the D2H result copy and the staged H2D copy;
- the outermost wrapped call records a pair of timing events around the
  launch on the stream of each of ``launch_devices`` (obs/spans.py
  ``LaunchTimer``; the start moves to the launch's staged H2D copy,
  ``_ship``, where it makes one), and the launch retires when its
  ``LazyResult`` is fetched: its device time and the idle gap before it
  are read then.

PyTorch runs eagerly, so there is no compile cache; bucketing is kept
because padded ops are part of the semantics the JAX package defines
(they are routed to the scratch word and leave every tenant row alone).
"""

from __future__ import annotations

import functools
import math
import threading
import time
from typing import Optional

import numpy as np
import torch

from redisson_tpu_torch import chaos as _chaos, overload as _ovl
from redisson_tpu_torch.config import device_slice
from redisson_tpu_torch.executor.failures import (
    DeadlineExceededError,
    ExecutorRetiredError,
    NonRetryableDispatchError,
)
from redisson_tpu_torch.obs import spans as _spans
from redisson_tpu_torch.parallel.mesh import Blocks, PlacedState as _PlacedState
from redisson_tpu_torch.ops import (
    _build,
    bitops,
    bloom as bloom_ops,
    bitset as bitset_ops,
    cms as cms_ops,
    cms_seq,
    fastpath,
    golden,
    hll as hll_ops,
)
from redisson_tpu_torch.utils import hashing

# Ops per pass of the single-tenant keyed paths.  The non-exact add takes
# its newly-added flags against the state before each pass, so the pass
# size is part of its semantics (the JAX package scans chunks of this
# size, making flags chunk-sequential); it also bounds temporaries.
_SCAN_CHUNK = 1 << 20


class LazyResult:
    """Async result handle (RFuture analog): holds a device tensor (or
    ``Blocks``); copies it to the host, slices off padding and applies
    ``transform`` only on ``.result()``.  The launch that produced it
    (``_timing``, set by the dispatch wrapper) retires once it is home."""

    _timing = None

    def __init__(self, value, n: Optional[int] = None, transform=None):
        self._value = value
        self._n = n
        self._transform = transform
        self._done = None

    def result(self, timeout=None):
        # ``timeout`` accepted for signature parity with the coalescer's
        # HintedFuture; a tensor fetch is synchronous.
        fetched = self._done is not None  # resolved by collect_group's copy
        if self._done is None:
            v = self._value
            if isinstance(v, (torch.Tensor, Blocks)):
                # Only a real device fetch can fault here: host results
                # (mirror answers, ImmediateResult) have no transfer.
                if _chaos.ENABLED:
                    _chaos.fire("fetch")
                v = v.to_host() if isinstance(v, Blocks) else v.cpu().numpy()
                fetched = True
            self.resolve_from(v)
        launch = self._timing
        if launch is not None:
            self._timing = None
            launch.timer.retire(launch, fetched)
        return self._done

    def resolve_from(self, host):
        """Resolve with an already-fetched host copy (collect_group)."""
        if self._done is None:
            v = host
            if self._n is not None:
                v = v[: self._n]
            if self._transform is not None:
                v = self._transform(v)
            self._done = v
            self._value = None
        return self._done

    def get(self):
        return self.result()

    def done(self) -> bool:
        return self._done is not None


def bloom_count_from_bitcount(x, m: int, k: int) -> int:
    """BITCOUNT inversion n = -m/k * ln(1 - X/m) (RedissonBloomFilter#count),
    rounded with Python ``round`` and ``m`` once every bit is set, so the
    integer equals the JAX package's."""
    x = int(x)
    if x >= m:
        return m
    return int(round(-m / k * math.log(1 - x / m)))


def local_devices(device) -> list:
    """The local enumeration a device slice indexes: every card
    (``torch.cuda.device_count()``) for a CUDA device, else the one
    device.  Tests and the card's smoke replace this function to lay
    several placements on one device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def resolve_device_slice(indices, devices=None) -> list:
    """The devices ``indices`` names, in the caller's order, out of the
    local enumeration (``devices`` overrides it, for fake lists): the
    whole enumeration for None; an entry out of range, a repeat or an
    empty slice raises."""
    if devices is None:
        devices = local_devices("cuda")
    if indices is None:
        return list(devices)
    out, seen = [], set()
    for i in indices:
        i = int(i)
        if not 0 <= i < len(devices):
            raise ValueError(
                f"device_indices entry {i} out of range: {len(devices)} local devices")
        if i in seen:
            raise ValueError(f"device_indices entry {i} repeated")
        seen.add(i)
        out.append(devices[i])
    if not out:
        raise ValueError("device_indices must not be empty")
    return out


def executor_devices(cfg) -> list:
    """An executor's device slice (``cfg`` a GpuSketchConfig): the
    ``device_indices`` slice of the local cards; else, for a device
    without an index, the whole enumeration — or, with several
    processes, this process's contiguous share of the cards (all share
    the default card when there are fewer cards than processes); else
    the device itself."""
    dev = torch.device(cfg.device)
    idx = cfg.device_indices
    if idx is None and dev.index is None and dev.type == "cuda" and cfg.num_processes > 1:
        idx = device_slice(cfg.process_id, cfg.num_processes, torch.cuda.device_count())
        if idx is None:
            return [dev]
    if idx is not None:
        return resolve_device_slice(idx, local_devices(dev))
    if dev.index is None:
        return local_devices(dev)
    return [dev]


def process_backend(device, num_processes: int) -> str:
    """The torch.distributed backend for ``num_processes`` processes on
    ``device``, from the topology alone: nccl when every process has a
    card of its own; gloo when they share a card or run on the CPU
    (nccl refuses two ranks on one card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= int(num_processes):
        return "nccl"
    return "gloo"


def process_group(cfg, device):
    """The mesh's ProcessGroup for ``cfg`` (a GpuSketchConfig): None for
    one process; else the group the engine joined, which must match the
    config's size and rank."""
    if int(cfg.num_processes) <= 1:
        return None
    import torch.distributed as dist

    from redisson_tpu_torch.parallel.mesh import ProcessGroup

    if not dist.is_initialized():
        raise RuntimeError(
            f"num_processes={cfg.num_processes} but no torch.distributed group "
            f"is initialized: set coordinator_address so the engine joins one"
        )
    if (dist.get_world_size(), dist.get_rank()) != (int(cfg.num_processes), int(cfg.process_id)):
        raise RuntimeError(
            f"the torch.distributed group is rank {dist.get_rank()} of "
            f"{dist.get_world_size()}, the config says process_id "
            f"{cfg.process_id} of {cfg.num_processes}"
        )
    if dist.get_backend() == "nccl":
        # nccl's communicator binds to the current card.
        torch.cuda.set_device(torch.device(device))
    return ProcessGroup.current(device)


def _pow2ceil(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _as_u32(v: np.ndarray) -> np.ndarray:
    return v.view(np.uint32)


def _fill_words(buf, off: int, n_pad: int, arr, dtype, fill=0) -> int:
    """Write ``arr`` into buf[off:off+n_pad] viewed as a 4-byte ``dtype``,
    padding the tail with ``fill``; returns the next offset."""
    view = buf[off : off + n_pad].view(dtype)
    n = arr.shape[0]
    view[:n] = arr
    view[n:] = fill
    return off + n_pad


def _fill_bits(buf, off: int, n_pad: int, flags) -> int:
    """Pack a bool column at 1 bit per op (zero-padded); returns the next
    offset."""
    nw = n_pad >> 5
    words = bitops.host_pack_bool_u32(np.asarray(flags, bool))
    view = buf[off : off + nw]
    view[: words.shape[0]] = words
    view[words.shape[0]:] = 0
    return off + nw


def _fill_blocks(buf, off: int, n_pad: int, blocks) -> int:
    """Write a [B, L] uint32 lane block, zero-padded to [n_pad, L]."""
    B, L = blocks.shape
    view = buf[off : off + n_pad * L].reshape(n_pad, L)
    view[:B] = blocks
    view[B:] = 0
    return off + n_pad * L


def _trim_lanes(blocks):
    """Drop trailing all-zero lane columns before the H2D copy (the
    kernel rebuilds them, fastpath.pad_lanes); returns (trimmed, lanes)."""
    L = blocks.shape[1]
    used = L
    while used > 1 and not np.any(blocks[:, used - 1]):
        used -= 1
    return blocks[:, :used], L


# Row-maintenance methods exempt from the direct-dispatch deadline shed:
# they run inside compound engine operations (delete's detach -> zero,
# a migration's copy -> zero, reconcile's write-back, dumps) where an
# abort between steps would tear state — a detached but unzeroed row
# could be reallocated carrying stale bits.  Every serving-path method
# sheds.
_DEADLINE_EXEMPT = frozenset(("read_row", "write_row", "zero_row", "copy_row"))


def _nops_of(name: str, args) -> int:
    """Best-effort op count of a dispatch call: the longest sized operand
    after the pool (the per-op column).  str/bytes args never count, and
    write_row's payload is a row image, not an op batch."""
    if name == "write_row":
        return 1
    best = 1
    for a in args[1:]:
        if isinstance(a, (str, bytes)):
            continue
        try:
            n = len(a)
        except TypeError:
            continue
        best = max(best, n)
    return best


# First launches, process-wide: the set of (op, bucket, device, pool
# signature) keys every executor has dispatched, and their count.  A first
# launch is where the one-time costs of the card land — CUDA's lazy load
# of a kernel module on its first launch, the caching allocator's first
# block of a bucket's staging and result sizes — plus one key for the K1
# build (``ops/_build.py``).  The pre-warmer (executor/prewarm.py) drives
# the same keys through the lock-free method bodies, so a warm serving
# path adds none; ``first_launch_count`` is what shows it.
_ROW_OPS = frozenset(("read_row", "write_row", "zero_row", "copy_row"))
_first_lock = threading.Lock()
_first_launched: set = set()
_first_launches = 0


def first_launch_count() -> int:
    """Process-wide count of first launches (monotonic)."""
    return _first_launches


def _note_first_launch(key) -> None:
    global _first_launches
    if key in _first_launched:  # the common case: a set probe, no lock
        return
    with _first_lock:
        if key not in _first_launched:
            _first_launched.add(key)
            _first_launches += 1


def _launch_key(ex, name: str, args) -> tuple:
    pool = args[0] if args else None
    spec = getattr(pool, "spec", None)
    sig = () if spec is None else (spec.key, pool.capacity)
    bucket = 0 if name in _ROW_OPS else ex._bucket(_nops_of(name, args))
    return (name, bucket, str(ex.device), sig)


def _locked(fn):
    """Serialize a dispatch method on the executor's dispatch lock (every
    method that reads or updates pool state in place) and guard it:

    - an op whose ambient deadline (overload.deadline_scope) has lapsed
      sheds before the lock and again after the lock wait, strictly
      before the device sees it (row maintenance exempt, see
      ``_DEADLINE_EXEMPT``);
    - chaos point ``dispatch.<method>`` fires under the lock, before the
      body runs;
    - a call that reaches an executor a live ``change_topology`` retired
      (callers read ``engine.executor`` before they take the lock) is
      forwarded to the successor (the same lock object, reentrant); a
      ``*_runs`` call whose successor has no runs path raises the
      retryable ExecutorRetiredError instead, and the coalescer's retry
      loop re-binds and re-checks ``supports_runs_metadata``;
    - a failure after the body's first in-place write of a pool it was
      given surfaces as NonRetryableDispatchError.  PyTorch bumps a
      tensor's version counter on every in-place op, views included, and
      K1's wrapper bumps it by hand (it writes through a raw pointer), so
      an unchanged version proves the pools untouched and the dispatch
      safe to retry."""
    name = fn.__name__
    fault_point = "dispatch." + name
    annotation = "rtpu:" + name
    sheddable = name not in _DEADLINE_EXEMPT

    def _shed_expired(self, args, stage: str) -> None:
        nops = _nops_of(name, args)
        obs = self.obs
        if obs is not None:
            obs.shed_ops.inc(("deadline",), nops)
            obs.deadline_exceeded.inc(("direct",), nops)
        raise DeadlineExceededError(
            f"op deadline expired {stage} direct dispatch ({name}, {nops} ops)",
            stage="direct",
        )

    @functools.wraps(fn)
    def counted(self, *args, **kwargs):
        _note_first_launch(_launch_key(self, name, args))
        return fn(self, *args, **kwargs)

    def _recorded(self, args, kwargs):
        obs, metrics = self.obs, self.metrics
        if (obs is None and metrics is None) or self._dispatch_recording:
            # Nothing to record into, or a nested wrapped call (the
            # outermost wrapper records; the dispatch lock is reentrant
            # and held, so the plain attribute is safe).
            return counted(self, *args, **kwargs)
        self._dispatch_recording = True
        t0 = time.monotonic()
        launch = None
        if obs is not None:
            # Timing events around the launch on its streams; a coalesced
            # launch carries its segment's span (the flush thread names it).
            span = _spans.current_launch()
            launch = obs.launches.begin(self.launch_devices,
                                        name if span is None else span.op, span)
        out = None
        _spans.set_timing(launch)
        try:
            # Named region in a torch.profiler capture (opened only while
            # one records): the card's kernels launched inside correlate
            # with the dispatch records by name.
            with _spans.host_range(annotation):
                out = counted(self, *args, **kwargs)
        finally:
            _spans.set_timing(None)
            self._dispatch_recording = False
            if launch is not None:
                obs.launches.end(launch)
                if isinstance(out, LazyResult):
                    out._timing = launch
                else:
                    # No result to fetch (or already on the host): it
                    # retires once its events are seen complete.
                    obs.launches.retire(launch)
        dur = time.monotonic() - t0
        nops = _nops_of(name, args)
        if metrics is not None:
            # Direct dispatch (no coalescer in front): the only recorder
            # of the legacy aggregate.
            metrics.record_dispatch(nops=nops, enqueue_s=dur)
        if obs is not None:
            obs.record_dispatch(name, nops, dur)
        return out

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        deadline = _ovl.current_deadline() if sheddable else None
        if deadline is not None and time.monotonic() >= deadline:
            _shed_expired(self, args, "before")
        with self._dispatch_lock:
            if _chaos.ENABLED:
                _chaos.fire(fault_point)
            if deadline is not None and time.monotonic() >= deadline:
                _shed_expired(self, args, "waiting for the lock of")
            if self._retired:
                succ = self._successor
                if succ is not None and not (
                    name.endswith("_runs") and not succ.supports_runs_metadata
                ):
                    return getattr(succ, name)(*args, **kwargs)
                raise ExecutorRetiredError(
                    f"{type(self).__name__} was retired by a topology change"
                )
            # Pool states: device tensors, or a mesh's per-placement blocks
            # (parallel/mesh.py PlacedState), both with a version counter.
            pools = [a for a in args
                     if isinstance(getattr(a, "state", None), (torch.Tensor, _PlacedState))]
            versions = [p.state._version for p in pools]
            try:
                return _recorded(self, args, kwargs)
            except NonRetryableDispatchError:
                raise
            except Exception as e:
                if any(p.state._version != v for p, v in zip(pools, versions)):
                    raise NonRetryableDispatchError(
                        f"{name} failed after writing pool state: {e!r}"
                    ) from e
                raise

    # The lock-free body (first launches still counted): the pre-warmer
    # calls it against private scratch pools.
    wrapper.__wrapped__ = counted
    return wrapper


def _serialized(fn):
    """The dispatch lock alone: whole-pool transport for snapshots, which
    is not a dispatch (no chaos point, no deadline)."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._dispatch_lock:
            return fn(self, *args, **kwargs)

    return wrapper


class TorchCommandExecutor:
    """Owns the device, the pool-state layout and every kernel launch."""

    # Sequential CMS (ops/cms_seq.py) runs on every device this executor
    # supports: CUDA launches the K1 kernel, the CPU its plain version.
    supports_seq_cms = True
    # The coalesced Bloom and BitSet paths may ship run-length metadata
    # (``*_runs``) instead of per-op rows.
    supports_runs_metadata = True

    def __init__(self, config):
        self._cfg = config.gpu_sketch
        dev = torch.device(self._cfg.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "use_gpu_sketch(device='cuda') but torch sees no CUDA device; "
                "pass device='cpu' to run on the CPU"
            )
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {dev}")
        # The device slice; the single-device executor holds its first.
        self.devices = executor_devices(self._cfg)
        self.device = self.devices[0]
        # The devices one launch runs on (its timing events' streams).
        self.launch_devices = (self.device,)
        self._dispatch_lock = threading.RLock()
        # The engine's Observability bundle (direct-dispatch shed counts).
        self.obs = None
        # The engine's serve.metrics.Metrics when no coalescer records in
        # front (direct dispatch): each outermost dispatch records once.
        self.metrics = None
        self._dispatch_recording = False
        # Set by a live change_topology once a successor took over.
        self._retired = False
        self._successor = None

    # -- pool-state factory ------------------------------------------------

    def round_capacity(self, capacity: int, row_units: int = 0, kind: str = "") -> int:
        # Giant rows: cap the initial footprint at 2**27 words and let
        # doubling growth take over (the JAX package's rule, so both hold
        # pools of the same shape).
        if row_units and capacity * row_units > (1 << 27):
            return max(1, (1 << 27) // row_units)
        return capacity

    @staticmethod
    def _torch_dtype(dtype):
        """Device element type of a pool spec's numpy dtype: uint8
        registers stay uint8; uint32 words are held as int32 bit-views."""
        return torch.uint8 if np.dtype(dtype) == np.uint8 else torch.int32

    @staticmethod
    def _host_view(t: torch.Tensor) -> np.ndarray:
        """A host copy of pool elements in the JAX package's dtype."""
        a = t.cpu().numpy()
        return (a if a.dtype == np.uint8 else _as_u32(a)).copy()

    def _to_device(self, pool, data: np.ndarray, device=None) -> torch.Tensor:
        device = self.device if device is None else device
        if self._torch_dtype(pool.spec.dtype) == torch.uint8:
            host = np.ascontiguousarray(data, dtype=np.uint8)
        else:
            host = np.ascontiguousarray(data, dtype=np.uint32).view(np.int32)
        if device.type != "cuda":
            return torch.from_numpy(host.copy())
        # One host copy into pinned memory, then one DMA: a 128 MiB row
        # (journal recovery's writeback, a promotion) crosses in one copy.
        staged = torch.empty(
            host.shape, dtype=torch.uint8 if host.dtype == np.uint8 else torch.int32,
            pin_memory=True,
        )
        staged.numpy()[...] = host
        return staged.to(device)

    def make_pool_state(self, capacity: int, row_units: int, dtype=np.uint32,
                        kind: str = ""):
        """Flat [capacity*row_units + 1]; trailing scratch element."""
        return torch.zeros(capacity * row_units + 1, dtype=self._torch_dtype(dtype),
                           device=self.device)

    def grow_pool_state(self, state, old_cap: int, new_cap: int, row_units: int,
                        dtype=np.uint32, kind: str = ""):
        extra = torch.zeros((new_cap - old_cap) * row_units + 1,
                            dtype=state.dtype, device=self.device)
        # state[:-1] drops the old scratch element; extra brings the new one.
        return torch.cat([state[:-1], extra])

    @_serialized
    def state_to_host(self, pool) -> np.ndarray:
        """The pool's elements, byte-identical to the JAX executor's."""
        return self._host_view(pool.state)

    @_serialized
    def state_from_host(self, pool, arr: np.ndarray) -> None:
        pool.state = self._to_device(pool, arr)

    @_locked
    def read_row(self, pool, row: int) -> np.ndarray:
        return self._host_view(bitops.row_slice(pool.state, row, pool.row_units))

    @_locked
    def write_row(self, pool, row: int, data: np.ndarray) -> None:
        bitops.row_update(pool.state, row, self._to_device(pool, data), pool.row_units)

    @_locked
    def zero_row(self, pool, row: int) -> None:
        """Clear a tenant row (delete, and the old row of a migration)."""
        bitops.row_slice(pool.state, row, pool.row_units).zero_()

    @_locked
    def copy_row(self, src_pool, src_row: int, dst_pool, dst_row: int) -> None:
        """dst row = src row zero-padded to the dst row's width, on the
        device (a bitset's size-class migration)."""
        src = bitops.row_slice(src_pool.state, src_row, src_pool.row_units)
        dst = bitops.row_slice(dst_pool.state, dst_row, dst_pool.row_units)
        dst[: src.shape[0]].copy_(src)
        dst[src.shape[0]:].zero_()

    # -- staging -------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        # 32-divisibility: boolean results leave the device packed
        # 32 per word, so the floor and a user-set min_bucket round up to
        # a multiple of 32.
        mb = -(-max(32, self._cfg.min_bucket) // 32) * 32
        return max(mb, _pow2ceil(max(1, n)))

    def _staging(self, nwords: int):
        """(uint32 numpy view, int32 host tensor) of ``nwords``: pinned on
        CUDA, so the one copy per flush is asynchronous.  PyTorch's host
        allocator keeps a pinned block out of reuse until the copy that
        read it has completed."""
        host = torch.empty(nwords, dtype=torch.int32,
                           pin_memory=self.device.type == "cuda")
        return _as_u32(host.numpy()), host

    def _ship(self, host: torch.Tensor, device=None) -> torch.Tensor:
        if _chaos.ENABLED:  # staged-H2D fault point, before the copy
            _chaos.fire("h2d.staging", data=host.numpy())
        device = self.device if device is None else device
        timing = _spans.current_timing()
        if timing is not None:  # the launch's device work starts with this copy
            self.obs.launches.staged(timing, device)
        return host.to(device, non_blocking=True)

    def collect_group(self, lazies) -> None:
        """Result mailbox: results of one (dtype, shape) are concatenated
        on the device and fetched with ONE D2H, then each LazyResult
        resolves from its slice.  Other items resolve on their own
        ``.result()``."""
        by_sig: dict = {}
        for lz in lazies:
            v = getattr(lz, "_value", None)
            if getattr(lz, "_done", 1) is None and isinstance(v, torch.Tensor):
                by_sig.setdefault((v.dtype, tuple(v.shape)), []).append(lz)
        for (_dtype, shape), group in by_sig.items():
            if len(group) < 2:
                continue
            flat = torch.cat([lz._value.reshape(-1) for lz in group]).cpu().numpy()
            n = int(np.prod(shape))
            for i, lz in enumerate(group):
                lz.resolve_from(flat[i * n : (i + 1) * n].reshape(shape).copy())

    # -- bloom ---------------------------------------------------------------

    def _result_bits(self, res: torch.Tensor, B: int) -> LazyResult:
        return LazyResult(
            bitops.pack_bool_u32(res),
            transform=lambda v: bitops.unpack_bool_u32(v, B),
        )

    def _hashed_block(self, Bp: int, *cols):
        """Ship per-op 4-byte columns (``(array, fill)``, padded to ``Bp``)
        in one staging block; returns their device views as int64 lanes
        holding the uint32 values."""
        buf, host = self._staging(len(cols) * Bp)
        o = 0
        for arr, fill in cols:
            o = _fill_words(buf, o, Bp, np.asarray(arr, np.uint32), np.uint32, fill)
        packed = hashing.u32(self._ship(host))
        return [packed[i * Bp : (i + 1) * Bp] for i in range(len(cols))]

    def _bloom_hashed(self, pool, rows, m_arr, k: int, h1m, h2m, is_add) -> LazyResult:
        """Combined add+contains of host-reduced hashes (``h1m, h2m`` < m)
        with per-op rows, m and flags: the exact sequential mixed op.  The
        batch ships as ONE staging block per flush: rows, m (padded with
        1: the mod needs it nonzero), h1m, h2m and the bit-packed flags."""
        B = len(h1m)
        Bp = self._bucket(B)
        Wb = Bp >> 5
        buf, host = self._staging(4 * Bp + Wb)
        o = _fill_words(buf, 0, Bp, np.asarray(rows, np.int32), np.int32)
        o = _fill_words(buf, o, Bp, np.asarray(m_arr, np.uint32), np.uint32, 1)
        o = _fill_words(buf, o, Bp, np.asarray(h1m, np.uint32), np.uint32)
        o = _fill_words(buf, o, Bp, np.asarray(h2m, np.uint32), np.uint32)
        _fill_bits(buf, o, Bp, is_add)
        packed = self._ship(host)
        cols = hashing.u32(packed[Bp : 4 * Bp])
        res = bloom_ops.bloom_mixed(
            pool.state, packed[:Bp], cols[Bp:2 * Bp], cols[2 * Bp:],
            bitops.unpack_bool_u32_dev(packed[4 * Bp:], Bp),
            m=cols[:Bp], k=k, words_per_row=pool.row_units,
            valid=self._valid(Bp, B),
        )
        return self._result_bits(res, B)

    @_locked
    def bloom_mixed(self, pool, rows, m_arr, k: int, h1m, h2m, is_add) -> LazyResult:
        """Host-hashed add+contains mix (the JAX package's coalesced
        hashed path): mixed multi-tenant traffic stays in one segment per
        (pool, k) with exact arrival-order results."""
        return self._bloom_hashed(pool, rows, m_arr, k, h1m, h2m, is_add)

    @_locked
    def bloom_add(self, pool, rows, m_arr, k: int, h1m, h2m) -> LazyResult:
        """Host-hashed add with exact sequential newly-added flags."""
        return self._bloom_hashed(pool, rows, m_arr, k, h1m, h2m,
                                  np.ones(len(h1m), bool))

    @_locked
    def bloom_contains(self, pool, rows, m_arr, k: int, h1m, h2m) -> LazyResult:
        """Host-hashed contains with per-op rows and m (read-only)."""
        B = len(h1m)
        Bp = self._bucket(B)
        rows_p, m_p, h1_p, h2_p = self._hashed_block(
            Bp, (np.asarray(rows, np.int32).view(np.uint32), 0), (m_arr, 1),
            (h1m, 0), (h2m, 0))
        res = bloom_ops.bloom_contains(pool.state, rows_p, h1_p, h2_p, m=m_p,
                                       k=k, words_per_row=pool.row_units)
        return self._result_bits(res, B)

    @_locked
    def bloom_add_fast_st(self, pool, row: int, m: int, k: int, h1m, h2m) -> LazyResult:
        """Single-tenant fast add (``exact_add_semantics=False``): flags
        against the state before the batch (ops/fastpath.py); row and m
        travel as scalars."""
        B = len(h1m)
        Bp = self._bucket(B)
        h1_p, h2_p = self._hashed_block(Bp, (h1m, 0), (h2m, 0))
        res = fastpath.bloom_add_fast_st(
            pool.state, int(row), h1_p, h2_p, int(m), self._valid(Bp, B),
            k=k, words_per_row=pool.row_units,
        )
        return self._result_bits(res, B)

    @_locked
    def bloom_contains_st(self, pool, row: int, m: int, k: int, h1m, h2m) -> LazyResult:
        """Single-tenant contains; bit-exact, row and m as scalars."""
        B = len(h1m)
        Bp = self._bucket(B)
        h1_p, h2_p = self._hashed_block(Bp, (h1m, 0), (h2m, 0))
        res = fastpath.bloom_contains_st(pool.state, int(row), h1_p, h2_p,
                                         int(m), k=k, words_per_row=pool.row_units)
        return self._result_bits(res, B)

    @_locked
    def bloom_mixed_keys(self, pool, rows, m_arr, k: int, blocks, lengths, is_add) -> LazyResult:
        """Combined add+contains from raw codec lanes with per-op rows, m
        and flags: device hash + the exact sequential mixed op."""
        B = blocks.shape[0]
        Bp = self._bucket(B)
        blocks, L = _trim_lanes(blocks)
        Lt = blocks.shape[1]
        Wb = Bp >> 5
        total = 3 * Bp + Wb + Bp * Lt
        buf, host = self._staging(total)
        o = _fill_words(buf, 0, Bp, np.asarray(rows, np.int32), np.int32)
        o = _fill_words(buf, o, Bp, np.asarray(lengths, np.uint32), np.uint32)
        o = _fill_words(buf, o, Bp, np.asarray(m_arr, np.uint32), np.uint32, 1)
        o = _fill_bits(buf, o, Bp, is_add)
        _fill_blocks(buf, o, Bp, blocks)
        packed = self._ship(host)
        o = 3 * Bp
        res = fastpath.bloom_mixed_keys(
            pool.state, packed[:Bp], packed[o + Wb :].view(Bp, Lt),
            packed[Bp : 2 * Bp], packed[2 * Bp : o],
            bitops.unpack_bool_u32_dev(packed[o : o + Wb], Bp),
            self._valid(Bp, B),
            k=k, words_per_row=pool.row_units, target_lanes=L,
        )
        return self._result_bits(res, B)

    @_locked
    def bloom_mixed_keys_runs(self, pool, k: int, blocks, lengths, run_rows, run_m, run_flags, run_starts) -> LazyResult:
        """Coalesced mixed path with run-length metadata: rows, m and the
        add flag are constant within each submitted chunk, so they ship
        once per run (C entries + C+1 cumulative starts) and expand to
        per-op tensors on the device with ``searchsorted``.  ``lengths``:
        a uint32 scalar when every op shares one key length, else per op.
        ``run_starts[C]`` is the number of real ops; the rest is padding.

        Runs are padded to ``Cp`` entries (row 0, m 1, contains) as in the
        JAX package: padded ops take run ``Cp - 1``, so the scratch word
        ends up with the same bits in both."""
        B = int(run_starts[-1])
        Bp = self._bucket(B)
        blocks, L = _trim_lanes(blocks)
        Lt = blocks.shape[1]
        C = len(run_rows)
        Cp = max(1024, _pow2ceil(C))
        Wc = Cp >> 5
        const_len = np.ndim(lengths) == 0
        total = 1 + (Cp + 1) + 2 * Cp + Wc + (0 if const_len else Bp) + Bp * Lt
        buf, host = self._staging(total)
        buf[0] = np.uint32(lengths) if const_len else 0
        sview = buf[1 : Cp + 2].view(np.int32)
        sview[: C + 1] = run_starts
        sview[C + 1 :] = B
        o = _fill_words(buf, Cp + 2, Cp, np.asarray(run_rows, np.int32), np.int32)
        o = _fill_words(buf, o, Cp, np.asarray(run_m, np.uint32), np.uint32, 1)
        o = _fill_bits(buf, o, Cp, run_flags)
        if not const_len:
            o = _fill_words(buf, o, Bp, np.asarray(lengths, np.uint32), np.uint32)
        _fill_blocks(buf, o, Bp, blocks)
        packed = self._ship(host)
        ends = packed[2 : Cp + 2].to(torch.int64)
        o = Cp + 2
        rr = packed[o : o + Cp]
        rm = packed[o + Cp : o + 2 * Cp]
        o += 2 * Cp
        rf = bitops.unpack_bool_u32_dev(packed[o : o + Wc], Cp)
        o += Wc
        if const_len:
            lens = packed[0]
        else:
            lens = packed[o : o + Bp]
            o += Bp
        iota = torch.arange(Bp, dtype=torch.int64, device=self.device)
        # Run of op i = number of run ends <= i, clipped to the last run.
        seg = torch.clamp(torch.searchsorted(ends, iota, right=True), max=Cp - 1)
        res = fastpath.bloom_mixed_keys(
            pool.state, rr[seg], packed[o:].view(Bp, Lt), lens, rm[seg],
            rf[seg], iota < B,
            k=k, words_per_row=pool.row_units, target_lanes=L,
        )
        return self._result_bits(res, B)

    def _keys_block(self, blocks, lengths):
        """Ship [B, Lt] key lanes + per-op lengths in one H2D."""
        B = blocks.shape[0]
        blocks, L = _trim_lanes(blocks)
        Lt = blocks.shape[1]
        buf, host = self._staging(B + B * Lt)
        _fill_words(buf, 0, B, np.asarray(lengths, np.uint32), np.uint32)
        _fill_blocks(buf, B, B, blocks)
        packed = self._ship(host)
        return packed[B:].view(B, Lt), packed[:B], L

    @_locked
    def bloom_contains_keys_st(self, pool, row: int, m: int, k: int, blocks, lengths) -> LazyResult:
        """Single-tenant contains from raw codec lanes, in passes of
        ``_SCAN_CHUNK`` ops."""
        B = blocks.shape[0]
        dblocks, dlens, L = self._keys_block(blocks, lengths)
        res = torch.cat([
            fastpath.bloom_contains_keys_st(
                pool.state, row, dblocks[i : i + _SCAN_CHUNK],
                dlens[i : i + _SCAN_CHUNK], m,
                k=k, words_per_row=pool.row_units, target_lanes=L,
            )
            for i in range(0, B, _SCAN_CHUNK)
        ] or [torch.zeros(0, dtype=torch.bool, device=self.device)])
        return self._result_bits(self._pad_bits(res, B), B)

    @_locked
    def bloom_add_keys_st(self, pool, row: int, m: int, k: int, blocks, lengths) -> LazyResult:
        """Single-tenant bulk add (``exact_add_semantics=False``): flags
        against the state before each pass of ``_SCAN_CHUNK`` ops, so a
        duplicate in a later pass sees the earlier pass's bits."""
        B = blocks.shape[0]
        dblocks, dlens, L = self._keys_block(blocks, lengths)
        parts = []
        for i in range(0, B, _SCAN_CHUNK):
            bl = dblocks[i : i + _SCAN_CHUNK]
            parts.append(fastpath.bloom_add_keys_st(
                pool.state, row, bl, dlens[i : i + _SCAN_CHUNK], m,
                torch.ones(bl.shape[0], dtype=torch.bool, device=self.device),
                k=k, words_per_row=pool.row_units, target_lanes=L,
            ))
        res = torch.cat(parts or [torch.zeros(0, dtype=torch.bool, device=self.device)])
        return self._result_bits(self._pad_bits(res, B), B)

    @_locked
    def bloom_count(self, pool, row: int, m: int, k: int) -> LazyResult:
        """RBloomFilter#count: the row's popcount on the device, inverted
        on the host."""
        x = bloom_ops.bloom_cardinality(pool.state, row, words_per_row=pool.row_units)
        return LazyResult(x, transform=lambda xv: bloom_count_from_bitcount(xv, m, k))

    def _valid(self, Bp: int, n) -> torch.Tensor:
        """bool[Bp]: the first ``n`` ops are real, the rest padding."""
        return torch.arange(Bp, device=self.device) < n

    def _pad_bits(self, res: torch.Tensor, B: int) -> torch.Tensor:
        pad = (-B) % 32
        if pad == 0:
            return res
        return torch.cat([res, torch.zeros(pad, dtype=torch.bool, device=self.device)])

    # -- cms -----------------------------------------------------------------

    def _op_cols(self, Bp: int, *cols, device=None):
        """Pack int32/uint32 op columns (zero-padded to Bp) into one H2D
        (to ``device``, the executor's by default).  Padded CMS ops carry
        row 0 and weight 0, the scatter-add identity; the other callers
        mask padded ops with ``_valid``."""
        buf, host = self._staging(len(cols) * Bp)
        o = 0
        for c in cols:
            o = _fill_words(buf, o, Bp, np.asarray(c).astype(np.uint32, copy=False), np.uint32)
        packed = self._ship(host, device)
        return [packed[i * Bp : (i + 1) * Bp] for i in range(len(cols))]

    @_locked
    def cms_update_estimate(self, pool, rows, h1w, h2w, weights, d: int, w: int) -> LazyResult:
        """Coalesced CMS path: updates and estimates share one launch
        (estimates ride with weight 0); estimates are batch-final."""
        B = h1w.shape[0]
        r, a, b, wt = self._op_cols(self._bucket(B), rows, h1w, h2w, weights)
        est = cms_ops.cms_update_and_estimate(
            pool.state, r, a, b, wt, d=d, w=w, cells_per_row=pool.row_units
        )
        return LazyResult(est, B, transform=_as_u32)

    @_locked
    def cms_estimate(self, pool, rows, h1w, h2w, d: int, w: int) -> LazyResult:
        B = h1w.shape[0]
        r, a, b = self._op_cols(self._bucket(B), rows, h1w, h2w)
        est = cms_ops.cms_estimate(
            pool.state, r, a, b, d=d, w=w, cells_per_row=pool.row_units
        )
        return LazyResult(est, B, transform=_as_u32)

    @_locked
    def cms_update_estimate_seq(self, pool, row: int, h1w, h2w, weights, d: int, w: int) -> LazyResult:
        """Streaming update+estimate (kernel K1, ops/cms_seq.py) on one
        tenant.  The JAX executor slices the tenant row out, runs the
        kernel and concatenates the row back; here K1 updates the pool
        IN PLACE through a view at offset ``row*row_units``.  No padding:
        the kernel takes any op count."""
        B = h1w.shape[0]
        a, b, wt = self._op_cols(B, h1w, h2w, weights)
        table = pool.state[row * pool.row_units : row * pool.row_units + d * w]
        if self.device.type == "cuda" and not _build.loaded("cms_seq"):
            _note_first_launch(("k1.build", str(self.device)))
        est = cms_seq.cms_update_estimate_seq(table, a, b, wt, d=d, w=w)
        return LazyResult(est, transform=_as_u32)

    @_locked
    def cms_merge(self, pool, dst_row: int, src_rows) -> LazyResult:
        """CMS.MERGE: dst row += the source rows, mod 2**32, on the device."""
        cms_ops.cms_merge(pool.state, dst_row, self._rows_tensor(src_rows),
                          cells_per_row=pool.row_units)
        return LazyResult(None)

    # -- hll -----------------------------------------------------------------

    @_locked
    def hll_add_keys_single(self, pool, row: int, blocks, lengths,
                            chunk: int = _SCAN_CHUNK) -> LazyResult:
        """Direct PFADD from raw codec lanes (device hash), in passes of
        ``chunk`` ops, as the JAX package scans them: each pass sees the
        registers the one before left, and "changed" is the any over
        passes."""
        B = blocks.shape[0]
        if B == 0:
            return LazyResult(False)
        dblocks, dlens, L = self._keys_block(blocks, lengths)
        changed = torch.zeros((), dtype=torch.bool, device=self.device)
        for i in range(0, B, chunk):
            changed |= fastpath.hll_add_keys_single(
                pool.state, row, dblocks[i : i + chunk], dlens[i : i + chunk],
                target_lanes=L,
            )
        return LazyResult(changed, transform=bool)

    @_locked
    def hll_add(self, pool, rows, c0, c1, c2) -> LazyResult:
        B = len(c0)
        Bp = self._bucket(B)
        cols = self._op_cols(Bp, rows, c0, c1, c2)
        hll_ops.hll_add(pool.state, *cols, valid=self._valid(Bp, B))
        return LazyResult(True)

    @_locked
    def hll_add_changed(self, pool, rows, c0, c1, c2) -> LazyResult:
        """Multi-tenant PFADD with exact per-op "changed" flags (the
        coalesced path): one packed H2D of ``[n, rows, c0, c1, c2]``, the
        JAX executor's layout."""
        B = len(c0)
        Bp = self._bucket(B)
        buf, host = self._staging(1 + 4 * Bp)
        buf[0] = B
        o = 1
        for col in (rows, c0, c1, c2):
            o = _fill_words(buf, o, Bp, np.asarray(col).astype(np.uint32, copy=False),
                            np.uint32)
        packed = self._ship(host)
        cols = [packed[1 + i * Bp : 1 + (i + 1) * Bp] for i in range(4)]
        changed = hll_ops.hll_add_changed(
            pool.state, *cols, valid=self._valid(Bp, packed[0])
        )
        return self._result_bits(changed, B)

    @_locked
    def hll_add_single(self, pool, row: int, c0, c1, c2) -> LazyResult:
        """Single-tenant PFADD returning the "changed" boolean."""
        B = len(c0)
        Bp = self._bucket(B)
        cols = self._op_cols(Bp, c0, c1, c2)
        changed = hll_ops.hll_add_single(pool.state, row, *cols,
                                         valid=self._valid(Bp, B))
        return LazyResult(changed, transform=bool)

    @_locked
    def hll_count(self, pool, row: int) -> LazyResult:
        """PFCOUNT: the device histogram, finalized on the host with the
        float64 Ertl estimator (the golden model's count)."""
        return LazyResult(
            hll_ops.hll_histogram(pool.state, row),
            transform=lambda h: int(round(golden.ertl_estimate(h))),
        )

    @_locked
    def hll_merge(self, pool, dst_row: int, src_rows) -> LazyResult:
        hll_ops.hll_merge(pool.state, dst_row, self._rows_tensor(src_rows))
        return LazyResult(None)

    def _rows_tensor(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows, np.int64), device=self.device)

    # -- bitset ----------------------------------------------------------------

    @_locked
    def bitset_mixed_runs(self, pool, idx, run_rows, run_ops, run_starts) -> LazyResult:
        """bitset_mixed with run-length metadata: row and opcode are
        constant within each submitted chunk, so they ship once per run
        and expand on the device with ``searchsorted`` (the scheme of
        bloom_mixed_keys_runs).  Packed as the JAX executor packs it:
        ``[n, idx (Bp), starts (Cp + 1), rows (Cp), opcodes (Cp)]``; padded
        runs carry OP_GET, so padded ops (routed to the scratch word) are
        reads and the pool bytes match."""
        B = int(run_starts[-1])
        Bp = self._bucket(B)
        C = len(run_rows)
        Cp = max(1024, _pow2ceil(C))
        buf, host = self._staging(1 + Bp + (Cp + 1) + 2 * Cp)
        buf[0] = B
        o = _fill_words(buf, 1, Bp, np.asarray(idx, np.uint32), np.uint32)
        sview = buf[o : o + Cp + 1].view(np.int32)
        sview[: C + 1] = run_starts
        sview[C + 1 :] = B
        o += Cp + 1
        o = _fill_words(buf, o, Cp, np.asarray(run_rows, np.int32), np.int32)
        _fill_words(buf, o, Cp, np.asarray(run_ops, np.uint32), np.uint32,
                    bitset_ops.OP_GET)
        packed = self._ship(host)
        o = 1 + Bp
        ends = packed[o + 1 : o + Cp + 1].to(torch.int64)
        rr = packed[o + Cp + 1 : o + 2 * Cp + 1]
        ro = packed[o + 2 * Cp + 1 :]
        iota = torch.arange(Bp, dtype=torch.int64, device=self.device)
        # Run of op i = number of run ends <= i, clipped to the last run.
        seg = torch.clamp(torch.searchsorted(ends, iota, right=True), max=Cp - 1)
        obs = bitset_ops.bitset_mixed(
            pool.state, rr[seg], packed[1 : 1 + Bp], ro[seg],
            words_per_row=pool.row_units, valid=iota < packed[0],
        )
        return self._result_bits(obs, B)

    @_locked
    def bitset_mixed(self, pool, rows, idx, opcodes) -> LazyResult:
        """Unified set/clear/flip/get batch with per-op arrays: one packed
        H2D of ``[n, rows, idx, opcodes]``; padded ops carry OP_GET."""
        B = len(idx)
        Bp = self._bucket(B)
        buf, host = self._staging(1 + 3 * Bp)
        buf[0] = B
        o = _fill_words(buf, 1, Bp, np.asarray(rows, np.int32), np.int32)
        o = _fill_words(buf, o, Bp, np.asarray(idx, np.uint32), np.uint32)
        _fill_words(buf, o, Bp, np.asarray(opcodes, np.uint32), np.uint32,
                    bitset_ops.OP_GET)
        packed = self._ship(host)
        r, i, op = (packed[1 + k * Bp : 1 + (k + 1) * Bp] for k in range(3))
        obs = bitset_ops.bitset_mixed(
            pool.state, r, i, op, words_per_row=pool.row_units,
            valid=self._valid(Bp, packed[0]),
        )
        return self._result_bits(obs, B)

    def _bitset_rw(self, kernel, pool, rows, idx) -> LazyResult:
        B = len(idx)
        Bp = self._bucket(B)
        r, i = self._op_cols(Bp, rows, idx)
        prev = kernel(pool.state, r, i, words_per_row=pool.row_units,
                      valid=self._valid(Bp, B))
        return self._result_bits(prev, B)

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
        B = len(idx)
        r, i = self._op_cols(self._bucket(B), rows, idx)
        got = bitset_ops.bitset_get(pool.state, r, i, words_per_row=pool.row_units)
        return self._result_bits(got, B)

    @_locked
    def bitset_set_range(self, pool, row: int, from_bit: int, to_bit: int,
                         value: bool) -> LazyResult:
        bitset_ops.bitset_set_range(pool.state, row, from_bit, to_bit,
                                    words_per_row=pool.row_units, value=value)
        return LazyResult(None)

    @_locked
    def bitset_cardinality(self, pool, row: int) -> LazyResult:
        return LazyResult(bitset_ops.bitset_cardinality(
            pool.state, row, words_per_row=pool.row_units), transform=int)

    @_locked
    def bitset_length(self, pool, row: int) -> LazyResult:
        return LazyResult(bitset_ops.bitset_length(
            pool.state, row, words_per_row=pool.row_units), transform=int)

    @_locked
    def bitset_bitpos(self, pool, row: int, target_bit: int) -> LazyResult:
        return LazyResult(bitset_ops.bitset_bitpos(
            pool.state, row, words_per_row=pool.row_units, target_bit=target_bit),
            transform=int)

    @_locked
    def bitset_bitop(self, pool, dst_row: int, src_rows, op: str,
                     limit_bits=None) -> LazyResult:
        """BITOP; ``limit_bits`` (NOT only) masks the result to the
        source's logical length."""
        bitset_ops.bitset_bitop_rows(
            pool.state, dst_row, self._rows_tensor(src_rows),
            words_per_row=pool.row_units, op=op, limit_bits=limit_bits,
        )
        return LazyResult(None)

    @_locked
    def bitset_get_row(self, pool, row: int) -> LazyResult:
        return LazyResult(bitset_ops.bitset_get_row(
            pool.state, row, words_per_row=pool.row_units), transform=_as_u32)
