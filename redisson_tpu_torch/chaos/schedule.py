"""Reproducible fault schedules: ``ChaosSchedule(seed, rate, points)``.

Counterpart of ``redisson_tpu/chaos/schedule.py``, roll for roll: for one
seed, rate and point, both packages fire on the same call indexes, so
one schedule drives either.

A schedule compiles to one :class:`FaultRule` per fault point.  Each rule
owns a private ``random.Random`` seeded from ``(schedule seed, point)``
and a per-point call counter, so the fire/skip decision sequence at a
point is a pure function of (seed, rate, call index) — two runs that hit
a point the same number of times inject the same faults, regardless of
how OTHER points interleave across threads.
"""

from __future__ import annotations

import random
import threading
import zlib
from typing import Iterable, Sequence


class FaultRule:
    """One (point, kind, rate) injection rule with a deterministic roll."""

    __slots__ = ("point", "kind", "rate", "seed", "latency_s",
                 "calls", "fired", "_rng", "_lock")

    def __init__(self, point: str, *, kind: str = "error", rate: float = 1.0,
                 seed: int = 0, latency_s: float = 0.001):
        self.point = point
        self.kind = kind
        self.rate = float(rate)
        self.seed = int(seed)
        self.latency_s = float(latency_s)
        self.calls = 0
        self.fired = 0
        # Seed folds the point name in, so multi-point schedules don't
        # fire in lockstep across points.
        self._rng = random.Random(
            (self.seed << 32) ^ zlib.crc32(point.encode("utf-8"))
        )
        self._lock = threading.Lock()

    def roll(self) -> bool:
        """Advance the point's deterministic sequence; True = inject."""
        with self._lock:
            self.calls += 1
            hit = self.rate >= 1.0 or self._rng.random() < self.rate
            if hit:
                self.fired += 1
            return hit


class ChaosSchedule:
    """A reproducible fault plan over a set of points.

    ``points`` entries are either bare point names (inheriting the
    schedule-wide ``kind``/``rate``) or ``(point, kind, rate)`` tuples for
    per-point overrides.  ``seed`` fixes every rule's roll sequence.
    """

    def __init__(self, seed: int = 0, rate: float = 0.05,
                 points: Sequence = ("dispatch",), *, kind: str = "error",
                 latency_s: float = 0.001):
        self.seed = int(seed)
        self.rate = float(rate)
        self.kind = kind
        self.latency_s = float(latency_s)
        self.points = tuple(points)

    def rules(self) -> Iterable[FaultRule]:
        out = []
        for p in self.points:
            if isinstance(p, tuple):
                point, kind, rate = p
            else:
                point, kind, rate = p, self.kind, self.rate
            out.append(FaultRule(
                point, kind=kind, rate=rate, seed=self.seed,
                latency_s=self.latency_s,
            ))
        return out

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return (
            f"ChaosSchedule(seed={self.seed}, rate={self.rate}, "
            f"points={self.points!r}, kind={self.kind!r})"
        )
