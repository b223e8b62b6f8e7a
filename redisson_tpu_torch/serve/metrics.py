"""Metrics & batch tracing (SURVEY.md §5: the reference's OSS core has
none; monitoring is a Redisson PRO feature, so this is an upgrade): ops/sec,
batch occupancy and p99 flush latency, measured from inside the framework,
plus a ``torch.profiler`` trace around a workload window.

The port's copy of ``redisson_tpu/serve/metrics.py``: ``Metrics`` is the
JAX package's, ``Profiler`` captures with ``torch.profiler`` on the
engine's device.
"""

from __future__ import annotations

import os
import threading
import time

from redisson_tpu_torch.analysis import witness as _witness


class _Reservoir:
    """Bounded latency reservoir for percentile estimates."""

    def __init__(self, cap: int = 4096):
        self.cap = cap
        self.values: list[float] = []
        self.n = 0

    def add(self, v: float) -> None:
        self.n += 1
        if len(self.values) < self.cap:
            self.values.append(v)
        else:
            # Sliding ring: keeps the most recent ``cap`` samples (NOT a
            # uniform sample of the whole run — steady-state windows are
            # what the percentiles describe).
            self.values[self.n % self.cap] = v

    def percentiles(self, ps) -> list:
        """Nearest-rank percentiles from ONE sort (int(p/100*n) overshot
        by a rank: p50 of [1,2,3,4] must be 2, not 3)."""
        import math

        if not self.values:
            return [0.0 for _ in ps]
        vals = sorted(self.values)
        n = len(vals)
        return [
            vals[min(n - 1, max(0, math.ceil(p / 100.0 * n) - 1))]
            for p in ps
        ]

    def percentile(self, p: float) -> float:
        return self.percentiles([p])[0]


class Metrics:
    def __init__(self):
        self._lock = _witness.named(threading.Lock(), "serve.metrics")
        self.started = time.monotonic()
        self.ops_total = 0
        self.batches_total = 0
        self.wait = _Reservoir()
        self.flush = _Reservoir()

    def reset(self) -> None:
        """Zero counters/reservoirs — benches call this after warmup so
        first-compile latencies don't pollute steady-state percentiles."""
        with self._lock:
            self.started = time.monotonic()
            self.ops_total = 0
            self.batches_total = 0
            self.wait = _Reservoir()
            self.flush = _Reservoir()

    def record_batch(self, *, nops: int, wait_s: float, flush_s: float) -> None:
        with self._lock:
            self.ops_total += nops
            self.batches_total += 1
            self.wait.add(wait_s)
            self.flush.add(flush_s)

    def record_dispatch(self, *, nops: int, enqueue_s: float) -> None:
        """Direct-dispatch recording (no coalescer in front): counts ops
        and the host-side enqueue latency.  The wait reservoir stays
        untouched — nothing queued, so there is no queueing delay to
        report (zeros would fake a perfect p99)."""
        with self._lock:
            self.ops_total += nops
            self.batches_total += 1
            self.flush.add(enqueue_s)

    def snapshot(self) -> dict:
        # Copy under the lock (it contends with the hot flush path), sort
        # OUTSIDE it — and only once per reservoir for both percentiles.
        with self._lock:
            elapsed = max(time.monotonic() - self.started, 1e-9)
            batches = max(self.batches_total, 1)
            ops_total = self.ops_total
            batches_total = self.batches_total
            wait = _Reservoir()
            wait.values = list(self.wait.values)
            flush = _Reservoir()
            flush.values = list(self.flush.values)
        w50, w99 = wait.percentiles([50, 99])
        f50, f99 = flush.percentiles([50, 99])
        return {
            "ops_total": ops_total,
            "batches_total": batches_total,
            "ops_per_sec": ops_total / elapsed,
            "mean_batch_occupancy": ops_total / batches,
            "p50_wait_ms": w50 * 1e3,
            "p99_wait_ms": w99 * 1e3,
            "p50_flush_ms": f50 * 1e3,
            "p99_flush_ms": f99 * 1e3,
        }

    # Monotonic snapshot keys: exported as Prometheus counters (they
    # already carry the required ``_total`` suffix).  Everything else in
    # the snapshot is a point-in-time/derived value -> gauge.  rate()
    # over a counter mis-typed as gauge silently yields garbage, so the
    # split is semantic, not cosmetic.
    _COUNTER_KEYS = ("ops_total", "batches_total")

    def render_prometheus(self) -> str:
        """Plain Prometheus text exposition (SURVEY.md §5 metrics row)."""
        s = self.snapshot()
        lines = []
        for k, v in s.items():
            kind = "counter" if k in self._COUNTER_KEYS else "gauge"
            lines.append(f"# TYPE redisson_tpu_{k} {kind}")
            lines.append(f"redisson_tpu_{k} {v}")
        return "\n".join(lines) + "\n"


class Profiler:
    """``torch.profiler`` integration (SURVEY.md §5 tracing row): captures
    a host + device trace (Chrome / Perfetto JSON) around a workload
    window, alongside the per-batch wait/flush reservoirs above.

    Usage::

        prof = client.get_profiler()
        prof.start("/tmp/rtpu-trace")
        ... workload ...
        path = prof.stop()   # the Chrome trace written into the dir

    Or as a context manager: ``with client.get_profiler().trace(dir): ...``

    The trace records the CPU and, on a CUDA device, the card's kernels
    and copies.  A CUDA profiler without CUDA activity would hand back a
    trace silently empty of device work, so ``start`` refuses instead.
    """

    def __init__(self, device="cpu", devices=None):
        import torch

        self.device = torch.device(device)
        # The mesh's devices (one per shard; shards may share one).
        self.devices = [torch.device(d) for d in devices] if devices else []
        self._active = False
        self._plock = _witness.named(threading.Lock(), "serve.profiler")
        self._prof = None
        self._log_dir = None
        self.last_trace = None  # path of the newest exported trace

    def _activities(self) -> list:
        from torch.profiler import ProfilerActivity, supported_activities

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            if ProfilerActivity.CUDA not in supported_activities():
                raise RuntimeError(
                    "torch.profiler has no CUDA activity here: a trace of "
                    f"{self.device} would hold no device events"
                )
            acts.append(ProfilerActivity.CUDA)
        return acts

    def start(self, log_dir: str) -> None:
        import torch

        with self._plock:
            if self._active:
                raise RuntimeError("a profiler trace is already active")
            self._active = True
        try:
            os.makedirs(log_dir, exist_ok=True)
            prof = torch.profiler.profile(activities=self._activities())
            prof.__enter__()
        except BaseException:
            with self._plock:
                self._active = False
            raise
        self._prof, self._log_dir = prof, log_dir

    def stop(self) -> str:
        """End the trace and write it into the ``start`` directory;
        returns the trace file's path."""
        import torch

        with self._plock:
            if not self._active:
                # Calling stop on an inactive profiler is a caller bug
                # (e.g. a FRESH instance where the active one is lost) —
                # silently no-opping would leave the trace running forever.
                raise RuntimeError("no active profiler trace to stop")
            self._active = False
            prof, self._prof = self._prof, None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # queued kernels land
        prof.__exit__(None, None, None)
        path = os.path.join(
            self._log_dir, f"rtpu-trace-{os.getpid()}-{time.time_ns()}.json"
        )
        prof.export_chrome_trace(path)
        self.last_trace = path
        return path

    def trace(self, log_dir: str):
        from contextlib import contextmanager

        @contextmanager
        def _ctx():
            self.start(log_dir)
            try:
                yield self
            finally:
                self.stop()

        return _ctx()

    @staticmethod
    def annotate(name: str):
        """Named region inside a trace (→ torch.profiler.record_function)."""
        import torch

        return torch.profiler.record_function(name)

    def device_memory(self) -> dict:
        """Current memory stats (bytes) for every distinct device of the
        engine's mesh (the profiler's ``devices``; every CUDA device of
        the machine when none were given), keyed by ``platform:id`` (the
        Node.address form).  A CUDA device reports the caching
        allocator's bytes in use and peak (``memory_stats``) and the
        card's free and total bytes (``mem_get_info``); the CPU reports
        an empty dict under its key, as a JAX CPU device does."""
        import torch

        if self.device.type != "cuda":
            return {"cpu:0": {}}
        if self.devices:
            indices = sorted({d.index or 0 for d in self.devices})
        else:
            indices = range(torch.cuda.device_count())
        out: dict = {}
        for i in indices:
            stats = torch.cuda.memory_stats(i)
            free, total = torch.cuda.mem_get_info(i)
            out[f"gpu:{i}"] = {
                "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
                "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
                "bytes_free": free,
                "bytes_limit": total,
            }
        return out
