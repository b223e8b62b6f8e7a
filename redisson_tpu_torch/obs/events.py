"""Fleet flight recorder — a bounded,
lock-cheap structured event ring per process recording what the control
planes DECIDED and why: elections, takeovers, resyncs, rebalance waves,
breaker flips, tier transitions, worker deaths, config changes, doctor
findings.

Metrics say "how much", traces say "how slow" (PAPERS.md §2 Dapper);
the flight recorder says "what happened, in what order" — the causal
record an operator replays after a 3 a.m. failover.  Slicer (PAPERS.md
§3) ships its assigner with continuous self-checking; this ring is
where those checks (obs/doctor.py) and every other control plane write
their black-box log.

Event shape (one dict per event, JSON-safe by construction):

- ``node``      — emitting node's id (stamped by the owning server;
                  empty until a door claims the ring);
- ``seq``       — per-node monotonic sequence number.  Gaps in a
                  node's seq stream mean ring evictions, and
                  ``ClusterClient.fleet_events()`` reports them as
                  exactly that instead of pretending the record is
                  complete;
- ``wall``      — wall-clock seconds (time.time; the cross-node merge
                  key, ordered as (wall, node, seq));
- ``mono``      — monotonic stamp for intra-node interval math;
- ``kind``      — a literal from :data:`KINDS` (bounded cardinality —
                  the RT005 discipline applied to event kinds; rtpulint
                  RT015 enforces literal registered kinds at every call
                  site);
- ``severity``  — ``info`` | ``warn`` | ``error``;
- ``fields``    — small structured payload (slot, epoch, offsets, …);
- ``trace_id``  — present when a trace scope was ambient at emit time,
                  so a traced request's control-plane consequences join
                  its trace.

Cost discipline: emit points live on CONTROL-plane paths (ticks,
elections, breaker flips), never per-op hot paths, so the ring takes a
plain lock around a deque append — no sampling, no module guard.  The
ring is HARD-BOUNDED (``max_events``): recording can never become a
memory leak, only a recency window; evictions are counted and visible
as seq gaps.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from redisson_tpu_torch.obs import trace as _trace

# The event-kind catalog: every kind the fleet can ever emit, with the
# control plane it belongs to.  BOUNDED ON PURPOSE — kinds are a metric
# label dimension (rtpu_events_emitted) and the doctor's finding keys,
# so unbounded kinds would defeat the registry cardinality cap.  Adding
# an emit point means adding its kind HERE first (rtpulint RT015 fails
# any call site whose kind literal is not in this table, and
# tests/test_rtpulint.py pins the linter's mirror to this dict).
KINDS = {
    # cluster/failover.py — detection, votes, elections, takeovers.
    "failover.detected": "peer marked failed by the timeout detector",
    "failover.vote": "FAILOVER.AUTH vote granted to a candidate",
    "failover.election.won": "this node won an election (quorum)",
    "failover.election.lost": "this node's election fell short of quorum",
    "failover.takeover.sent": "takeover broadcast sent (per-slot-range epoch)",
    "failover.takeover.applied": "takeover broadcast applied to the slotmap",
    # cluster/rebalancer.py — coordinator changes + wave outcomes.
    "rebalance.coordinator": "rebalance coordinator changed",
    "rebalance.wave.planned": "wave planned (moves + imbalance ratio)",
    "rebalance.wave.executed": "wave executed (moved/failed counts)",
    "rebalance.wave.skipped": "planned move vetoed at the last moment",
    # durability/replication.py + replica.py — resyncs, link, fences.
    "repl.full_resync": "full resynchronization served or performed",
    "repl.partial_resync": "partial resync (PSYNC CONTINUE) served or ridden",
    "repl.link.down": "replica link to the primary broke",
    "repl.stale_read": "staleness gate refused a read (-STALEREAD)",
    "repl.wait.timeout": "WAIT fence timed out below the asked replica count",
    # executor/health.py — breaker transitions and mirror reconcile.
    "health.breaker.open": "circuit breaker opened (kind degraded)",
    "health.breaker.close": "breaker closed and the kind reconciled",
    "health.reconcile.failed": "reconcile write-back failed; breaker re-opened",
    # storage/residency.py — tier transitions.
    "residency.promote": "sketch promoted back to a device row",
    "residency.demote": "sketch demoted to its host golden mirror",
    "residency.spill": "host mirror spilled to a disk blob",
    # serve/multicore.py — worker lifecycle + in-node handoff legs.
    "multicore.worker.spawn": "front-door worker came up (self-announce)",
    "multicore.worker.death": "front-door worker observed dead by a "
                              "sibling (its peer listener is gone)",
    "multicore.handoff.broken": "in-node handoff leg broke (-HANDOFFBROKEN)",
    # serve/resp.py — the CONFIG SET audit trail.
    "config.set": "live CONFIG SET applied (key + new value)",
    # obs/doctor.py — invariant findings and the black-box canary.
    "doctor.finding": "doctor sweep raised an invariant finding",
    "doctor.clear": "a previously active finding cleared",
    "doctor.canary": "black-box canary probe failed",
}

SEVERITIES = ("info", "warn", "error")


class EventRing:
    """The per-process flight-recorder ring.

    One instance per :class:`~redisson_tpu_torch.obs.Observability` bundle;
    the RESP door stamps ``node`` once the cluster identity is known
    (empty node = standalone process).  ``emit`` is thread-safe and
    cheap: one lock, one deque append, one counter bump."""

    def __init__(self, max_events: int = 1024, counter=None,
                 evicted_counter=None):
        self.max_events = int(max_events)
        self.node = ""
        self._lock = threading.Lock()
        self._ring: deque = deque()
        self._seq = 0
        self.evicted = 0
        self._counter = counter            # rtpu_events_emitted (kind)
        self._evicted_counter = evicted_counter  # rtpu_events_evicted

    # -- emit (control-plane paths only) -----------------------------------

    def emit(self, kind: str, /, severity: str = "info", **fields) -> dict:
        """Record one structured event; returns the event dict.

        ``kind`` must be a literal registered in :data:`KINDS` — an
        unknown kind raises (a programming error, caught by rtpulint
        RT015 before it ever runs).  ``fields`` must be JSON-safe
        scalars/lists (the EVENTS GET surface serializes them as-is).
        """
        if kind not in KINDS:
            raise ValueError(f"unregistered event kind {kind!r}")
        if severity not in SEVERITIES:
            raise ValueError(f"unknown severity {severity!r}")
        trace_id = None
        ctx = _trace.current()
        if ctx is not None:
            if isinstance(ctx, tuple):
                ctx = ctx[0]
            trace_id = getattr(ctx, "trace_id", None)
        ev = {
            "node": self.node,
            "wall": time.time(),
            "mono": time.monotonic(),
            "kind": kind,
            "severity": severity,
            "fields": fields,
        }
        if trace_id is not None:
            ev["trace_id"] = trace_id
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            if len(self._ring) >= self.max_events:
                self._ring.popleft()
                self.evicted += 1
                if self._evicted_counter is not None:
                    self._evicted_counter.inc((), 1)
            self._ring.append(ev)
        if self._counter is not None:
            self._counter.inc((kind,))
        return ev

    # -- read surface (EVENTS GET|LEN, INFO events, the doctor) ------------

    def snapshot(self, count: int = 0, kind: str = "") -> list:
        """Newest-last list of event dicts (copies); ``count`` > 0
        limits to the newest N, ``kind`` filters by exact kind (or a
        ``prefix.`` when it ends with a dot — ``doctor.`` selects the
        doctor's whole plane)."""
        with self._lock:
            evs = list(self._ring)
        if kind:
            if kind.endswith("."):
                evs = [e for e in evs if e["kind"].startswith(kind)]
            else:
                evs = [e for e in evs if e["kind"] == kind]
        if count > 0:
            evs = evs[-count:]
        return [dict(e) for e in evs]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def stats(self) -> dict:
        with self._lock:
            return {
                "events": len(self._ring),
                "seq": self._seq,
                "evicted": self.evicted,
                "max_events": self.max_events,
            }

    def reset(self) -> int:
        """EVENTS RESET: drop the ring (seq keeps counting — a reset
        must read as an eviction gap downstream, never as silence that
        looks like nothing happened)."""
        with self._lock:
            n = len(self._ring)
            self.evicted += n
            if n and self._evicted_counter is not None:
                self._evicted_counter.inc((), n)
            self._ring.clear()
            return n


def merge_timelines(per_node: dict) -> tuple[list, dict]:
    """Merge per-node event lists into ONE causally-ordered fleet
    timeline: ``(events, gaps)`` where events sort by
    ``(wall, node, seq)`` — wall clocks order across nodes (the best a
    multi-node merge can do without true causality tokens), per-node
    seq breaks ties and proves intra-node order — and ``gaps`` maps
    node -> evicted-event count inferred from seq discontinuities, so
    a reader knows where the record is incomplete instead of assuming
    the ring saw everything.  Node-disjoint merge, the fleet_loadmap
    discipline: a dead member contributes nothing, it never raises."""
    merged: list = []
    gaps: dict = {}
    for node, evs in per_node.items():
        prev_seq = None
        for ev in sorted(evs, key=lambda e: e.get("seq", 0)):
            seq = int(ev.get("seq", 0))
            if prev_seq is not None and seq > prev_seq + 1:
                gaps[node] = gaps.get(node, 0) + (seq - prev_seq - 1)
            prev_seq = seq
            merged.append(ev)
    merged.sort(
        key=lambda e: (e.get("wall", 0.0), e.get("node", ""),
                       e.get("seq", 0))
    )
    return merged, gaps


__all__ = ["EventRing", "KINDS", "SEVERITIES", "merge_timelines"]
