"""LATENCY subsystem (parity surface) — redis-server's
latency monitor (latency.c): named latency events sampled into bounded
per-event histories once they meet ``latency-monitor-threshold``.

Event sources in this codebase:

- ``command``       — any RESP command whose execution time meets the
                      threshold (serve/resp.py _safe_dispatch);
- ``slow-launch``   — a coalesced engine launch whose end-to-end span
                      met the threshold (obs/spans.py);
- ``fsync-stall``   — a journal group-commit fsync that met the
                      threshold (durability/journal.py);
- ``breaker-open``  — a circuit breaker opening (executor/health.py;
                      the recorded latency is the open window, i.e. how
                      long dispatches will fail fast);
- ``migration``     — one key's MIGRATE dump→RESTORE→delete critical
                      section (cluster/door.py);
- ``reconcile``     — a degraded-kind mirror write-back at breaker
                      close (objects/engines.py);
- ``election``      — one failover election attempt, start to win/loss
                      (cluster/failover.py);
- ``rebalance-wave``— one executed rebalance wave, plan to last move
                      (cluster/rebalancer.py);
- ``full-resync``   — a replica-side full resynchronization, snapshot
                      load included (durability/replica.py).

Semantics follow Redis: threshold 0 disables monitoring entirely (the
hot-path guard is one attribute read + compare); each event keeps the
last ``MAX_SAMPLES`` (ts, ms) pairs plus an all-time max; ``LATENCY
LATEST|HISTORY|RESET|DOCTOR`` serve the data over RESP and ``CONFIG SET
latency-monitor-threshold`` arms it live.  The event-name space is
additionally capped (``MAX_EVENTS``) so a buggy caller can never grow
the dict without bound (the RT006 discipline).
"""

from __future__ import annotations

import threading
import time
from collections import deque

MAX_SAMPLES = 160  # per-event history bound (redis-server keeps 160)
MAX_EVENTS = 64    # event-name cardinality bound


class LatencyMonitor:
    def __init__(self, threshold_ms: int = 0, counter=None):
        # threshold_ms is read UNLOCKED on hot paths (single attribute,
        # GIL-atomic): 0 = disabled, the redis default.
        self.threshold_ms = int(threshold_ms)
        self._lock = threading.Lock()
        self._events: dict[str, deque] = {}  # name -> deque[(ts, ms)]
        self._max: dict[str, int] = {}       # name -> all-time max ms
        self._counter = counter  # optional rtpu_latency_events family

    # -- hot path ----------------------------------------------------------

    def record(self, event: str, ms: float) -> bool:
        """Sample ``event`` at ``ms`` when monitoring is armed and the
        value meets the threshold.  Cheap when disarmed: one compare."""
        thr = self.threshold_ms
        if thr <= 0 or ms < thr:
            return False
        ms_i = int(ms)
        with self._lock:
            ring = self._events.get(event)
            if ring is None:
                if len(self._events) >= MAX_EVENTS:
                    return False  # bounded event-name space
                ring = deque(maxlen=MAX_SAMPLES)
                self._events[event] = ring
            ring.append((int(time.time()), ms_i))
            if ms_i > self._max.get(event, 0):
                self._max[event] = ms_i
        if self._counter is not None:
            self._counter.inc((event,))
        return True

    # -- LATENCY command surface -------------------------------------------

    def latest(self) -> list:
        """[(event, last_ts, last_ms, max_ms)] — LATENCY LATEST."""
        with self._lock:
            out = []
            for name, ring in self._events.items():
                if not ring:
                    continue
                ts, ms = ring[-1]
                out.append((name, ts, ms, self._max.get(name, ms)))
        out.sort()
        return out

    def history(self, event: str) -> list:
        """[(ts, ms)] oldest first — LATENCY HISTORY <event>."""
        with self._lock:
            ring = self._events.get(event)
            return list(ring) if ring else []

    def reset(self, *events: str) -> int:
        """Clear the named events (all when none given); returns the
        number of event histories dropped — LATENCY RESET."""
        with self._lock:
            if not events:
                n = len(self._events)
                self._events.clear()
                self._max.clear()
                return n
            n = 0
            for e in events:
                if self._events.pop(e, None) is not None:
                    n += 1
                self._max.pop(e, None)
            return n

    def doctor(self) -> str:
        """LATENCY DOCTOR: a human diagnosis of the armed monitor."""
        if self.threshold_ms <= 0:
            return (
                "I'm sorry, Dave, I can't do that.  Latency monitoring "
                "is disabled in this instance.  Enable it with CONFIG "
                "SET latency-monitor-threshold <milliseconds>."
            )
        latest = self.latest()
        if not latest:
            return (
                f"Dave, I have observed the system, no worthy latency "
                f"event registered so far (threshold "
                f"{self.threshold_ms} ms), keep it up!"
            )
        lines = [
            f"Dave, I have a few latency spikes to report "
            f"(threshold {self.threshold_ms} ms):"
        ]
        advice = {
            "fsync-stall": "consider appendfsync everysec, a faster "
                           "disk, or a larger group-commit window",
            "slow-launch": "check rtpu_op_phase_seconds for the slow "
                           "phase (coalesce_wait, host_stage, slot_wait, "
                           "enqueue or d2h_fetch), "
                           "rtpu_launch_device_seconds for the device's "
                           "own time, and the link-phase gauges",
            "breaker-open": "a device dispatch path is failing; see "
                            "rtpu_breaker_state and INFO stats "
                            "(degraded/breakers_open)",
            "command": "see SLOWLOG GET and INFO latencystats for the "
                       "offending commands",
            "migration": "per-key MIGRATE holds the move guard across "
                         "a network round trip; shrink keys or expect "
                         "this during resharding",
            "reconcile": "mirror write-back volume tracks the degraded "
                         "window length; close breakers sooner",
            "election": "slow elections lengthen the unavailability "
                        "window; check peer timeouts and EVENTS GET "
                        "failover. for the vote timeline",
            "rebalance-wave": "long waves hold slot move guards; lower "
                              "rebalance-max-moves or raise the "
                              "interval",
            "full-resync": "a replica fell off the backlog; grow "
                           "repl-backlog-size or check EVENTS GET "
                           "repl.link.down for flapping links",
        }
        for name, ts, ms, mx in latest:
            lines.append(
                f"- {name}: latest {ms} ms, all-time max {mx} ms"
            )
            if name in advice:
                lines.append(f"  advice: {advice[name]}")
        return "\n".join(lines)

    def stats(self) -> dict:
        with self._lock:
            return {
                "threshold_ms": self.threshold_ms,
                "events": len(self._events),
                "samples": sum(len(r) for r in self._events.values()),
            }

    # -- CONFIG SET hook ---------------------------------------------------

    def set_threshold_ms(self, ms: int) -> None:
        ms = int(ms)
        if ms < 0:
            raise ValueError(
                f"latency-monitor-threshold must be >= 0, got {ms}"
            )
        self.threshold_ms = ms


__all__ = ["LatencyMonitor", "MAX_EVENTS", "MAX_SAMPLES"]
