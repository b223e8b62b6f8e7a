"""Chaos engine — deterministic, seeded fault injection.

Counterpart of ``redisson_tpu/chaos/__init__.py``: named fault points at
every device boundary of the port, and a reproducible schedule that
raises a chosen exception, injects latency, or corrupts-and-detects at
each one.  Rules roll exactly as the JAX package's do, so one schedule
drives both packages alike.

Fault-point catalog:

======================  ====================================================
point                   where it fires
======================  ====================================================
``dispatch.<method>``   inside the executor's dispatch wrapper (``_locked``
                        in torch_executor.py), under the dispatch lock,
                        before the method body: ``dispatch.bloom_mixed_
                        keys_runs``, ``dispatch.read_row``, ...  A rule
                        installed under the bare prefix ``dispatch``
                        matches every method.
``fetch``               the D2H copy of a device result (LazyResult.result)
``h2d.staging``         the pinned staging block, before its H2D copy
``snapshot.save``       snapshot()/dump() I/O
``snapshot.load``       restore_snapshot()/restore() I/O
``snapshot.rename``     between the snapshot tmp-file fsync and its rename
``storage.spill``       a residency spill, after the blob is framed and
                        before it is written (storage/residency.py)
``storage.load``        a residency load, before the blob is read
``prewarm``             each pre-warm task, before its warm launch
                        (executor/prewarm.py)
``overload.pressure``   read through :func:`bias` by the coalescer's
                        admission estimate (kind ``pressure``)
======================  ====================================================

Zero overhead when disabled: every call site is guarded by the
module-level ``if chaos.ENABLED:`` check — one module-attribute read and
a branch.  ``fire()`` is only entered while a rule is installed.

Determinism: each rule owns a ``random.Random`` seeded from
``(schedule seed, point)`` and a call counter, both advanced under the
rule's lock — the fire/skip sequence per point is a pure function of
(seed, rate, per-point call index), independent of how threads
interleave across points.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Optional

import numpy as np

from redisson_tpu_torch.chaos.schedule import ChaosSchedule, FaultRule

# Module-level no-op guard: hot paths check this BEFORE calling fire().
ENABLED = False

_lock = threading.Lock()
_rules: dict[str, FaultRule] = {}
_counts: dict[tuple, int] = {}  # (point, kind) -> faults actually injected
_observer = None  # callable(point, kind): the engine's obs counter

KINDS = ("error", "latency", "corrupt", "pressure")


class FaultInjected(RuntimeError):
    """A rule fired with kind='error': a deliberate, retryable
    dispatch-surface failure (the transient-device stand-in)."""

    def __init__(self, point: str):
        super().__init__(f"chaos: injected fault at {point!r}")
        self.point = point


class CorruptionDetected(RuntimeError):
    """A rule fired with kind='corrupt': a bit was flipped in a shadow
    copy of the payload, the checksum caught it, and the detection
    surfaces — the torn-transfer stand-in."""

    def __init__(self, point: str):
        super().__init__(f"chaos: corruption detected at {point!r}")
        self.point = point


# -- schedule management -----------------------------------------------------


def install(schedule: ChaosSchedule) -> None:
    """Replace the active rule set with ``schedule`` and arm the guard."""
    global ENABLED
    with _lock:
        _rules.clear()
        for rule in schedule.rules():
            _rules[rule.point] = rule
        ENABLED = bool(_rules)


def inject(point: str, kind: str = "error", rate: float = 1.0,
           seed: int = 0, latency_s: float = 0.001) -> None:
    """Add or replace ONE rule.  ``point`` may be a catalog name, a
    ``dispatch.<method>`` refinement, or ``*``."""
    global ENABLED
    if kind not in KINDS:
        raise ValueError(f"unknown fault kind {kind!r} (want one of {KINDS})")
    with _lock:
        _rules[point] = FaultRule(
            point, kind=kind, rate=float(rate), seed=int(seed),
            latency_s=float(latency_s),
        )
        ENABLED = True


def clear(point: Optional[str] = None) -> None:
    """Remove one rule, or every rule.  Disarms the guard when nothing
    remains."""
    global ENABLED
    with _lock:
        if point is None:
            _rules.clear()
        else:
            _rules.pop(point, None)
        ENABLED = bool(_rules)


def active() -> dict:
    """{point: (kind, rate, seed)} of the installed rules."""
    with _lock:
        return {p: (r.kind, r.rate, r.seed) for p, r in _rules.items()}


def counts() -> dict:
    """{(point, kind): injected} — faults that actually fired."""
    with _lock:
        return dict(_counts)


def reset_counts() -> None:
    with _lock:
        _counts.clear()


def set_observer(fn) -> None:
    """``fn(point, kind)`` runs per injected fault (the engine points it
    at its ``rtpu_faults_injected`` counter)."""
    global _observer
    _observer = fn


def unset_observer(fn) -> None:
    """Unhook ``fn`` if it is still the observer (engine shutdown: a later
    engine's observer stays, and a dead engine is not pinned here)."""
    global _observer
    if _observer is fn:
        _observer = None


# -- the fault point ---------------------------------------------------------


def _match(point: str) -> Optional[FaultRule]:
    rule = _rules.get(point)
    if rule is None and "." in point:
        rule = _rules.get(point.split(".", 1)[0])
    if rule is None:
        rule = _rules.get("*")
    return rule


def _roll_and_record(point: str) -> Optional[FaultRule]:
    """The matched rule when its roll says inject (counted and reported
    to the observer), else None."""
    rule = _match(point)
    if rule is None or not rule.roll():
        return None
    key = (point, rule.kind)
    with _lock:
        _counts[key] = _counts.get(key, 0) + 1
    obs = _observer
    if obs is not None:
        try:
            obs(point, rule.kind)
        except Exception:
            pass  # accounting must never turn into a second fault
    return rule


def fire(point: str, data=None) -> None:
    """Evaluate the schedule at a fault point.  Only reached when
    ``ENABLED`` (call sites guard); a no-op when no rule matches or the
    roll says pass."""
    rule = _roll_and_record(point)
    if rule is None:
        return
    if rule.kind == "pressure":
        # Pressure acts only through bias(); at an ordinary point it is
        # inert (the roll above still advanced the sequence).
        return
    if rule.kind == "latency":
        time.sleep(rule.latency_s)
        return
    if rule.kind == "corrupt":
        # Corrupt AND detect: flip one bit in a shadow copy and prove the
        # checksum catches it.  The live payload is never touched.
        if data is not None:
            buf = np.asarray(data).tobytes()
            if buf:
                shadow = bytearray(buf)
                shadow[rule.calls % len(shadow)] ^= 0x40
                if zlib.crc32(bytes(shadow)) == zlib.crc32(buf):  # pragma: no cover
                    raise AssertionError("crc32 missed a one-bit flip")
        raise CorruptionDetected(point)
    raise FaultInjected(point)


def bias(point: str) -> float:
    """Deterministic wait-estimate inflation for the overload control
    plane: the matched rule's ``latency_s`` as extra seconds when its
    roll says inject, else 0.0 — no sleep, no exception, so only the
    admission decision is perturbed, never the op."""
    if not ENABLED:
        return 0.0
    rule = _roll_and_record(point)
    return rule.latency_s if rule is not None else 0.0


__all__ = [
    "ChaosSchedule",
    "CorruptionDetected",
    "ENABLED",
    "FaultInjected",
    "FaultRule",
    "KINDS",
    "active",
    "bias",
    "clear",
    "counts",
    "fire",
    "inject",
    "install",
    "reset_counts",
    "set_observer",
    "unset_observer",
]
