"""The traced slice: ``torch.profiler`` over a few steady seconds of the
window, reduced to device busy time, kernel time, the top device
operations and the longest idle gaps.

Busy time is the union of the kernel, memcpy and memset intervals the
profiler recorded on each card, as ``profile_port.py`` takes it (the
union is copied here); with several cards it is averaged over them.
The profiler's clock is tied to ``time.perf_counter`` by a marker
recorded at a known instant, so the gaps can be labelled with what the
host and the benchmark's client threads were doing at the time.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

_MARK = "portbench.clock"
# CUDA runtime calls and the profiler's own buffers: a blocking copy spans
# every gap it waits through, so it would label them all.
_RUNTIME = ("cuda", "Activity Buffer")


def merge(spans):
    """Sorted, disjoint union of ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy_us(spans) -> float:
    return float(sum(e - s for s, e in merge(spans)))


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


class Slice:
    """Start it, let the clients run, stop it, then ``reduce``."""

    def __init__(self, devices):
        self.devices = list(devices)
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.mark_t = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.mark_t = time.perf_counter()
        with torch.profiler.record_function(_MARK):
            pass
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self.t1 = time.perf_counter()
        for d in self.devices:
            torch.cuda.synchronize(d)
        self.prof.__exit__(None, None, None)

    def reduce(self, activity=None, top: int = 10) -> dict:
        """``busy_s`` (mean over cards), ``window_s``, ``kernel_s`` (summed
        over cards), ``device_ops`` and ``idle_gaps`` (at most ``top``
        each, seconds)."""
        events = list(self.prof.events())
        mark = [e for e in events if e.name == _MARK]
        # perf_counter seconds = profiler microseconds * 1e-6 + shift
        shift = self.mark_t - (mark[0].time_range.start * 1e-6 if mark else 0.0)
        lo = (self.t0 - shift) * 1e6
        hi = (self.t1 - shift) * 1e6
        per_dev = defaultdict(list)
        by_name = defaultdict(float)
        kernel_us = 0.0
        cpu = []
        for e in events:
            s, t = e.time_range.start, e.time_range.end
            if _is_device(e):
                s, t = max(s, lo), min(t, hi)
                if t <= s:
                    continue
                per_dev[e.device_index].append((s, t))
                by_name[e.name[:96]] += t - s
                if _is_kernel(e.name):
                    kernel_us += t - s
            elif e.name != _MARK and not e.name.startswith(_RUNTIME):
                cpu.append((s, t, e.name))
        window_us = hi - lo
        ndev = max(1, len(self.devices))
        busy = sum(busy_us(v) for v in per_dev.values()) / ndev
        gaps = []
        for dev, spans in per_dev.items():
            cur = lo
            for s, e in merge(spans) + [[hi, hi]]:
                if s > cur:
                    gaps.append((s - cur, cur, s, dev))
                cur = max(cur, e)
        if not per_dev:
            gaps.append((window_us, lo, hi, None))
        gaps.sort(reverse=True)
        labelled = [[_label(g, cpu, activity, shift), g[0] * 1e-6] for g in gaps[:top]]
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return {
            "busy_s": busy * 1e-6,
            "window_s": window_us * 1e-6,
            "kernel_s": kernel_us * 1e-6,
            "device_events": sum(len(v) for v in per_dev.values()),
            "device_ops": [[n, us * 1e-6] for n, us in ops],
            "idle_gaps": labelled,
            "t0": self.t0,
            "t1": self.t1,
        }


def _label(gap, cpu, activity, shift) -> str:
    """The host operation that overlaps the gap most, the card, and how
    many client threads were issuing or waiting meanwhile."""
    _, g0, g1, dev = gap
    best, best_ov = "python, no torch op", 0.0
    if cpu:
        s = np.fromiter((c[0] for c in cpu), np.float64, len(cpu))
        e = np.fromiter((c[1] for c in cpu), np.float64, len(cpu))
        ov = np.minimum(e, g1) - np.maximum(s, g0)
        i = int(np.argmax(ov))
        if ov[i] > 0:
            best, best_ov = cpu[i][2], ov[i]
    where = "" if dev is None else f"cuda:{dev} "
    label = f"{where}{best[:60]}"
    if activity is not None:
        t0, t1 = g0 * 1e-6 + shift, g1 * 1e-6 + shift
        with activity.lock:
            spans = list(activity.spans)
        issuing = sum(1 for a, b, w in spans if w.startswith("issue") and a < t1 and b > t0)
        waiting = sum(1 for a, b, w in spans if w == "wait" and a < t1 and b > t0)
        label += f" | calls issuing {issuing}, waited on {waiting}"
    return label
