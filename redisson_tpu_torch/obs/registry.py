"""Labeled metrics registry: counters, gauges and log2-bucket histograms.

Counterpart of ``redisson_tpu/obs/registry.py``, unchanged in behaviour:
lock-cheap labeled families with bounded label cardinality
(``max_children``; past the cap new label sets collapse into one
``"_overflow"`` child), render-time gauge callbacks, and typed Prometheus
text exposition (monotonic series are counters with a ``_total``
suffix, distributions real histograms, point-in-time values gauges).
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Optional, Sequence

# Log2 bucket boundaries in MICROSECONDS: 1us .. 2^25us (~33.5s), +Inf.
# Time histograms observe seconds; values are converted once at observe.
N_TIME_BUCKETS = 26


def bucket_index_us(v_us: float) -> int:
    """Index of the first bucket with upper bound >= v_us.

    Boundaries are ``le = 2**i`` microseconds: v=1 -> 0, v=2 -> 1,
    v=3 -> 2, v=4 -> 2, ...; values >= 2^25us land in the +Inf bucket.
    """
    n = int(math.ceil(v_us))
    if n <= 1:
        return 0
    idx = (n - 1).bit_length()
    return min(idx, N_TIME_BUCKETS)


def bucket_upper_bound_us(idx: int) -> float:
    return float("inf") if idx >= N_TIME_BUCKETS else float(1 << idx)


class _Child:
    """One label set's state.  ``kind`` decides which fields are live."""

    __slots__ = ("lock", "value", "buckets", "sum", "count")

    def __init__(self, kind: str):
        self.lock = threading.Lock()
        self.value = 0.0
        if kind == "histogram":
            self.buckets = [0] * (N_TIME_BUCKETS + 1)
            self.sum = 0.0
            self.count = 0


class Family:
    """One named metric family: children keyed by a label-value tuple."""

    OVERFLOW = "_overflow"

    def __init__(self, name: str, help: str, kind: str,
                 labelnames: Sequence[str] = (), max_children: int = 512):
        self.name = name
        self.help = help
        self.kind = kind  # "counter" | "gauge" | "histogram"
        self.labelnames = tuple(labelnames)
        self.max_children = max_children
        self._children: dict[tuple, _Child] = {}
        self._lock = threading.Lock()

    def child(self, labelvalues: tuple = ()) -> _Child:
        c = self._children.get(labelvalues)
        if c is None:
            with self._lock:
                c = self._children.get(labelvalues)
                if c is None:
                    if len(self._children) >= self.max_children:
                        # Bounded cardinality: spill into one sentinel
                        # child rather than growing per-tenant forever.
                        labelvalues = (self.OVERFLOW,) * len(self.labelnames)
                        c = self._children.get(labelvalues)
                        if c is not None:
                            return c
                    c = _Child(self.kind)
                    self._children[labelvalues] = c
        return c

    # -- hot-path updates --------------------------------------------------

    def inc(self, labelvalues: tuple = (), n: float = 1) -> None:
        c = self.child(labelvalues)
        with c.lock:
            c.value += n

    def set(self, labelvalues: tuple = (), v: float = 0.0) -> None:
        c = self.child(labelvalues)
        with c.lock:
            c.value = v

    def observe(self, labelvalues: tuple, seconds: float) -> None:
        c = self.child(labelvalues)
        idx = bucket_index_us(seconds * 1e6)
        with c.lock:
            c.buckets[idx] += 1
            c.sum += seconds
            c.count += 1

    # -- reads -------------------------------------------------------------

    def get(self, labelvalues: tuple = ()) -> float:
        c = self._children.get(labelvalues)
        return 0.0 if c is None else c.value

    def items(self):
        with self._lock:
            return list(self._children.items())

    def reset(self) -> None:
        with self._lock:
            self._children.clear()

    def percentiles(self, labelvalues: tuple, ps: Sequence[float]) -> list:
        """Percentile estimates (seconds) from the log2 buckets: the
        answer is the UPPER BOUND of the bucket holding the target rank
        (a ≤2x overestimate by construction — honest for SLO checks,
        no per-sample state).  n=1 and all-equal streams degenerate to
        that one bucket's bound for every p."""
        c = self._children.get(labelvalues)
        if c is None or c.count == 0:
            return [0.0 for _ in ps]
        with c.lock:
            buckets = list(c.buckets)
            n = c.count
        out = []
        for p in ps:
            rank = max(1, int(math.ceil(p / 100.0 * n)))
            acc = 0
            val = bucket_upper_bound_us(N_TIME_BUCKETS)
            for i, b in enumerate(buckets):
                acc += b
                if acc >= rank:
                    val = bucket_upper_bound_us(i)
                    break
            out.append(val / 1e6)
        return out


class MetricsRegistry:
    """Family registry + Prometheus text exposition.

    ``gauge_callback`` families are evaluated at render/snapshot time
    from a callable (point-in-time health: queue depth, device memory)
    so the hot path never pushes them.
    """

    def __init__(self):
        self._families: dict[str, Family] = {}
        self._callbacks: list[tuple[str, str, tuple, Callable]] = []
        self._lock = threading.Lock()

    def _register(self, name: str, help: str, kind: str, labelnames,
                  max_children: int) -> Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = Family(name, help, kind, labelnames, max_children)
                self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", labelnames=(),
                max_children: int = 512) -> Family:
        # Prometheus counter naming contract: monotonic series end in
        # ``_total``.
        if not name.endswith("_total"):
            name += "_total"
        return self._register(name, help, "counter", labelnames, max_children)

    def gauge(self, name: str, help: str = "", labelnames=(),
              max_children: int = 512) -> Family:
        return self._register(name, help, "gauge", labelnames, max_children)

    def histogram(self, name: str, help: str = "", labelnames=(),
                  max_children: int = 512) -> Family:
        return self._register(name, help, "histogram", labelnames, max_children)

    def gauge_callback(self, name: str, help: str, fn: Callable,
                       labelnames=()) -> None:
        """Register a render-time gauge: ``fn`` returns a scalar (no
        labels) or a dict {labelvalues_tuple: scalar}."""
        with self._lock:
            self._callbacks.append((name, help, tuple(labelnames), fn))

    def family(self, name: str) -> Optional[Family]:
        return self._families.get(name)

    # -- exposition --------------------------------------------------------

    @staticmethod
    def _fmt(v) -> str:
        """Integral values print as integers (counters are conceptually
        ints; '1.0' in the exposition is legal but noisy)."""
        if isinstance(v, float) and v.is_integer():
            return str(int(v))
        return str(v)

    @staticmethod
    def _labels(names: tuple, values: tuple) -> str:
        if not names:
            return ""
        pairs = ",".join(
            '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
            for k, v in zip(names, values)
        )
        return "{" + pairs + "}"

    def render_prometheus(self) -> str:
        lines: list[str] = []
        with self._lock:
            families = sorted(self._families.items())
            callbacks = list(self._callbacks)
        for name, fam in families:
            items = fam.items()
            if not items:
                continue
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for labelvalues, c in sorted(items):
                lab = self._labels(fam.labelnames, labelvalues)
                if fam.kind == "histogram":
                    with c.lock:
                        buckets = list(c.buckets)
                        total, ssum = c.count, c.sum
                    acc = 0
                    for i, b in enumerate(buckets):
                        acc += b
                        le = bucket_upper_bound_us(i)
                        le_s = "+Inf" if le == float("inf") else repr(le / 1e6)
                        blab = self._labels(
                            fam.labelnames + ("le",), labelvalues + (le_s,)
                        )
                        lines.append(f"{name}_bucket{blab} {acc}")
                    lines.append(f"{name}_sum{lab} {ssum}")
                    lines.append(f"{name}_count{lab} {total}")
                else:
                    lines.append(f"{name}{lab} {self._fmt(c.value)}")
        for name, help, labelnames, fn in callbacks:
            try:
                v = fn()
            except Exception:
                continue  # a dead backend must not break exposition
            if help:
                lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} gauge")
            if isinstance(v, dict):
                for labelvalues, scalar in sorted(v.items()):
                    if scalar is None:
                        continue
                    lab = self._labels(labelnames, tuple(labelvalues))
                    lines.append(f"{name}{lab} {self._fmt(scalar)}")
            elif v is not None:
                lines.append(f"{name} {self._fmt(v)}")
        return "\n".join(lines) + "\n"
