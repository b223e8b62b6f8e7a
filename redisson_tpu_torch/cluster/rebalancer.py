"""Autonomous rebalancer: close the loop from the load-attribution
plane to slot assignment.

This is the assigner half of Slicer (PAPERS.md §3): the loadmap makes
skew *visible* (per-slot ops/device_us/keys in ``CLUSTER LOADMAP``,
fed by the dispatch records of the card's launches), ``migrate_slot``
makes slots *movable* under traffic (zero acked-write loss; a slot's
device rows travel as DUMP → RESTORE onto the target's card), and the
failover plane makes ownership *survivable* (epoch-gated takeover) —
this module connects them.

Split along the same testability seam as cluster/failover.py:

- :class:`RebalancePlanner` is PURE planning state — no sockets, no
  threads, no wall clock (every time-dependent method takes an
  explicit ``now``).  The netsim rebalancer model and the planner unit
  tests drive THIS class, so the damping/eligibility rules proved
  there are the ones production runs.
- :func:`run_wave` is the stateless executor: it walks a planned wave,
  re-checks each move against the LIVE slot map at the last possible
  moment (:func:`blocked_reason`), and drives the proven
  ``supervisor.migrate_slot`` pump serially with pacing.  The netsim
  model executes real waves over simulated sockets through this exact
  function.
- :class:`RebalanceAgent` is the I/O shell: a daemon thread that
  scrapes every primary's ``CLUSTER LOADMAP``, feeds the planner, and
  (on the coordinator only) executes waves.

Load model + damping (the Memcache-at-Facebook lesson — churn that
chases noise costs more than the skew it fixes):

- Slot heat is **ops + device_us weighted**, never key count: a slot
  holding one hot sketch outweighs a slot holding a thousand idle
  keys.
- Heat is an EWMA over scrape deltas; a transient spike decays instead
  of triggering a move, and the planner refuses to act at all until
  ``warmup_ticks`` scrapes have landed.
- A moved (or failed-to-move) slot enters a per-slot **cooldown**, so
  the loop can never ping-pong one slot between two nodes.
- Moves happen only while the fleet imbalance ratio (max node load /
  mean) exceeds ``threshold``, and planning stops early once the
  hypothetical ratio falls inside the dead band — classic hysteresis.
- At most ``max_moves`` migrations per wave, executed serially
  (migration concurrency cap of one) with ``pace_s`` between pumps, so
  serving p99 stays bounded during a wave.

Coordination: every armed node scrapes and keeps a warm planner (so a
takeover inherits smoothed heat, not a cold start), but only the
**coordinator** — the lowest-id alive primary — executes.  A node that
is unreachable or marked failed by the failover plane is excluded from
both roles, and :func:`blocked_reason` keeps the planner's hands off
any slot with live migration state, any slot whose owner changed after
planning (takeover or organic resharding), and any move touching an
excluded node.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from collections import namedtuple
from typing import Optional

from redisson_tpu_torch.analysis import witness as _witness
from redisson_tpu_torch.cluster import supervisor as _supervisor
from redisson_tpu_torch.serve.wireutil import ReplyError, exchange

# A planned migration: move `slot` from primary `src` to primary `dst`;
# `heat` is the planner's smoothed score at planning time (kept on the
# record for STATUS/trace attribution).
Move = namedtuple("Move", ("slot", "src", "dst", "heat"))

# device_us is folded into the ops-equivalent heat score at this rate:
# 100us of device time weighs like one op, so a slot whose keys run
# heavy fused kernels outranks an equal-op-count slot of cheap GETs.
# The load map's device_us is each launch's time on its stream, from
# timing events that bracket it (obs/spans.py LaunchTimer): its kernels
# and copies, and the gaps between them in which the card waits for the
# host to issue the next, but not the host's queueing, staging and fetch.
# On an H100 that read 1.7-2.3x the profiler's busy time per launch in a
# 2**20-key bulk contains, and 4.9-15.5x for small launches (PERF.md).
DEVICE_US_PER_OP = 100.0


# -- last-moment eligibility (the netsim mutation-guard seams) -------------

def slot_in_migration(slotmap, slot: int) -> bool:
    """True while the slot carries IMPORTING/MIGRATING state — an
    organic ``migrate_slot`` (or a previous wave) is mid-pump, and a
    second driver racing it could finalize the slot to a DIFFERENT
    destination than the one actively receiving keys.  Reverting this
    check is netsim mutation guard #1 (divergent owners)."""
    d = slotmap.lookup(slot)
    return d.importing_from is not None or d.migrating_to is not None


def owner_matches(slotmap, move: Move) -> bool:
    """True while the slot's CURRENT owner is still the plan's source.
    Plans go stale: between planning and execution a failover takeover
    or an organic reshard may have already moved the slot, and running
    the stale move would pump from a node that no longer owns the keys.
    Reverting this check is netsim mutation guard #2 (stranded
    keys)."""
    return slotmap.lookup(move.slot).owner == move.src


def blocked_reason(slotmap, move: Move, excluded=()) -> Optional[str]:
    """Why `move` must NOT execute right now, or None if it may.

    Checked at the last possible moment before the pump starts (and
    composed from the two module-level predicates above so the netsim
    mutation guards can revert each protection independently)."""
    if slot_in_migration(slotmap, move.slot):
        return "busy"
    if not owner_matches(slotmap, move):
        return "stale"
    if move.src in excluded or move.dst in excluded:
        return "failover"
    return None


# -- pure planner ----------------------------------------------------------

class RebalancePlanner:
    """Heat-smoothing + wave planning, no I/O and no wall clock.

    ``observe`` ingests cumulative per-(node, slot) counters (the
    LOADMAP payload is lifetime totals); deltas between scrapes become
    the per-tick heat signal, smoothed into a per-slot EWMA.  A
    (node, slot) pair seen for the first time contributes NOTHING that
    tick — its counter baseline is only being established — which is
    also exactly what makes ownership handoff safe: the new owner's
    restarted counter never reads as a spike.

    Single-writer by design: one agent tick (or the netsim model)
    drives it at a time; ``status`` readers take benign racy reads of
    scalar fields."""

    def __init__(self, alpha: float = 0.3, threshold: float = 1.3,
                 max_moves: int = 8, cooldown_s: float = 15.0,
                 min_heat: float = 1.0, warmup_ticks: int = 3):
        self.alpha = float(alpha)
        self.threshold = float(threshold)
        self.max_moves = int(max_moves)
        self.cooldown_s = float(cooldown_s)
        # Fleet-total heat floor per tick: below it the cluster is idle
        # and NO imbalance ratio justifies touching anything.
        self.min_heat = float(min_heat)
        self.warmup_ticks = int(warmup_ticks)
        self.heat: dict = {}       # slot -> EWMA ops-equivalents/tick
        self.slot_keys: dict = {}  # slot -> last-seen key count (sum)
        self._prev: dict = {}      # (node, slot) -> (ops, device_us)
        self._cool: dict = {}      # slot -> no-move-before `now`
        self.ticks = 0
        self.draining: set = set()
        self.last_ratio = 1.0
        self.last_loads: dict = {}

    # -- ingestion ---------------------------------------------------------

    def observe(self, per_node: dict, now: float) -> None:
        """Fold one scrape into the EWMA.  ``per_node`` maps node id ->
        {slot -> (ops_cum, device_us_cum, keys)} with CUMULATIVE
        counters (the LOADMAP wire shape, already field-plucked)."""
        delta: dict = {}
        keys: dict = {}
        for node, slots in per_node.items():
            for slot, (ops, dev_us, nkeys) in slots.items():
                keys[slot] = keys.get(slot, 0) + int(nkeys)
                prev = self._prev.get((node, slot))
                self._prev[(node, slot)] = (ops, dev_us)
                if prev is None:
                    continue  # baseline tick — no delta yet
                d_ops = max(0.0, ops - prev[0])
                d_dev = max(0.0, dev_us - prev[1])
                score = d_ops + d_dev / DEVICE_US_PER_OP
                if score:
                    delta[slot] = delta.get(slot, 0.0) + score
        a = self.alpha
        for slot, d in delta.items():
            self.heat[slot] = a * d + (1.0 - a) * self.heat.get(slot, 0.0)
        # Quiet slots decay toward zero instead of pinning their last
        # spike forever (and eventually drop out of the map entirely).
        for slot in [s for s in self.heat if s not in delta]:
            cooled = self.heat[slot] * (1.0 - a)
            if cooled < 1e-9:
                del self.heat[slot]
            else:
                self.heat[slot] = cooled
        for slot, n in keys.items():
            if n:
                self.slot_keys[slot] = n
            else:
                self.slot_keys.pop(slot, None)
        self.ticks += 1

    def forget_node(self, node_id: str) -> None:
        """Drop counter baselines for a node that restarted (its
        counters reset, and a stale high baseline would eat its first
        real deltas)."""
        for key in [k for k in self._prev if k[0] == node_id]:
            del self._prev[key]

    def note_moved(self, slot: int, now: float) -> None:
        """Cooldown after a move OR a failed attempt — either way the
        loop must not immediately retouch the slot."""
        self._cool[slot] = now + self.cooldown_s

    def cooling(self, slot: int, now: float) -> bool:
        t = self._cool.get(slot)
        if t is None:
            return False
        if now >= t:
            del self._cool[slot]
            return False
        return True

    # -- drain surface -----------------------------------------------------

    def drain(self, node_id: str) -> None:
        self.draining.add(node_id)

    def undrain(self, node_id: str) -> None:
        self.draining.discard(node_id)

    # -- planning ----------------------------------------------------------

    def node_loads(self, owners: dict, nodes) -> dict:
        """Smoothed load per node: sum of owned slots' EWMA heat."""
        loads = {n: 0.0 for n in nodes}
        for slot, owner in owners.items():
            if owner in loads:
                loads[owner] += self.heat.get(slot, 0.0)
        return loads

    def plan(self, owners: dict, nodes, excluded=(), now: float = 0.0):
        """One wave of moves, most-urgent first.

        ``owners`` maps every assigned slot -> primary id; ``nodes``
        lists candidate primaries; ``excluded`` (unreachable or
        failover-failed) nodes are never a source or destination.
        Phases: (1) drain requested nodes, (2) shed hot slots while the
        imbalance ratio exceeds the threshold, (3) once balanced, pack
        observed-idle keyed slots onto the least-loaded node so tiered
        residency can spill them."""
        eligible = [n for n in nodes if n not in excluded]
        dst_ok = sorted(n for n in eligible if n not in self.draining)
        loads = self.node_loads(owners, eligible)
        self.last_loads = dict(loads)
        moves: list = []
        by_node: dict = {}
        for slot, owner in owners.items():
            by_node.setdefault(owner, []).append(slot)

        # Phase 1 — drain: explicit operator intent, so it ignores both
        # warmup and cooldown; hottest slots leave first (they buy the
        # most headroom on the doomed node earliest).
        for node in sorted(self.draining):
            targets = [n for n in dst_ok if n != node]
            if not targets:
                continue
            for slot in sorted(by_node.get(node, ()),
                               key=lambda s: -self.heat.get(s, 0.0)):
                if len(moves) >= self.max_moves:
                    return moves
                dst = min(targets, key=lambda n: (loads.get(n, 0.0), n))
                h = self.heat.get(slot, 0.0)
                moves.append(Move(slot, node, dst, h))
                loads[dst] = loads.get(dst, 0.0) + h
                loads[node] = loads.get(node, 0.0) - h

        if self.ticks < self.warmup_ticks or len(dst_ok) < 2:
            return moves

        total = sum(loads.get(n, 0.0) for n in dst_ok)
        mean = total / len(dst_ok)
        self.last_ratio = (
            max(loads.get(n, 0.0) for n in dst_ok) / mean
            if mean > 0 else 1.0
        )
        if total < self.min_heat:
            return moves

        # Phase 2 — hot shed with hysteresis: start a wave only past
        # `threshold`, but once started keep going down to the
        # half-band, so the loop doesn't oscillate around the trigger
        # line chasing EWMA noise.
        stop_ratio = 1.0 + (self.threshold - 1.0) / 2.0
        shed = 0
        while len(moves) < self.max_moves:
            src = max(dst_ok, key=lambda n: (loads.get(n, 0.0), n))
            dst = min(dst_ok, key=lambda n: (loads.get(n, 0.0), n))
            if src == dst:
                break
            ratio = loads.get(src, 0.0) / mean if mean > 0 else 1.0
            if ratio <= (self.threshold if shed == 0 else stop_ratio):
                break
            gap = loads[src] - loads[dst]
            picked = None
            for slot in sorted(by_node.get(src, ()),
                               key=lambda s: -self.heat.get(s, 0.0)):
                h = self.heat.get(slot, 0.0)
                if h <= 0.0:
                    break
                if self.cooling(slot, now):
                    continue
                if any(m.slot == slot for m in moves):
                    continue
                # Never overshoot: moving more heat than half the gap
                # just flips which node is hot (one indivisible mega
                # slot therefore never bounces — it stays put).
                if h <= gap / 2.0:
                    picked = (slot, h)
                    break
            if picked is None:
                break
            slot, h = picked
            moves.append(Move(slot, src, dst, h))
            shed += 1
            loads[src] -= h
            loads[dst] += h
            by_node[src].remove(slot)
            by_node.setdefault(dst, []).append(slot)

        # Phase 3 — cold pack, only while balanced: keyed slots with NO
        # observed heat consolidate onto the least-loaded node, letting
        # tiered residency spill them off the busy nodes' budgets.
        if not moves and self.last_ratio <= self.threshold:
            packer = min(dst_ok, key=lambda n: (loads.get(n, 0.0), n))
            budget = max(1, self.max_moves // 2)
            for slot in sorted(self.slot_keys):
                if len(moves) >= budget:
                    break
                owner = owners.get(slot)
                if (owner is None or owner == packer
                        or owner not in dst_ok
                        or slot in self.heat
                        or self.cooling(slot, now)):
                    continue
                moves.append(Move(slot, owner, packer, 0.0))
        return moves


# -- wave executor ---------------------------------------------------------

def run_wave(slotmap, moves, excluded=(), batch: int = 64,
             pace_s: float = 0.0, stop_evt=None,
             timeout_s: float = 10.0) -> list:
    """Execute one planned wave serially against the live cluster.

    Every move re-checks :func:`blocked_reason` against the CURRENT
    slot map immediately before its pump starts — the plan may be
    seconds old and the fleet keeps moving underneath it.  Returns one
    record dict per move: ``{"move", "outcome", "keys", "seconds"}``
    (+ ``"error"`` on failure), where outcome is ``moved`` /
    ``skip_busy`` / ``skip_stale`` / ``skip_failover`` / ``failed``.

    Serial on purpose: one in-flight migration is the concurrency cap
    that keeps serving p99 bounded during a wave (the pump already
    batches; parallel pumps would stack device + socket pressure), and
    ``pace_s`` inserts a breather between consecutive pumps."""
    records = []
    for mv in moves:
        if stop_evt is not None and stop_evt.is_set():
            break
        reason = blocked_reason(slotmap, mv, excluded)
        if reason is not None:
            records.append(
                {"move": mv, "outcome": "skip_" + reason,
                 "keys": 0, "seconds": 0.0}
            )
            continue
        src_addr = slotmap.addr(mv.src)
        dst_addr = slotmap.addr(mv.dst)
        if src_addr is None or dst_addr is None:
            records.append(
                {"move": mv, "outcome": "skip_stale",
                 "keys": 0, "seconds": 0.0}
            )
            continue
        notify = tuple(
            a for a in (
                slotmap.addr(n) for n in slotmap.node_ids()
                if n != mv.src and n != mv.dst
            ) if a is not None
        )
        t0 = time.monotonic()
        try:
            keys = _supervisor.migrate_slot(
                mv.slot, tuple(src_addr), tuple(dst_addr),
                notify=notify, batch=batch, timeout_s=timeout_s,
            )
        except Exception as exc:
            records.append(
                {"move": mv, "outcome": "failed", "keys": 0,
                 "seconds": time.monotonic() - t0, "error": str(exc)}
            )
            continue
        records.append(
            {"move": mv, "outcome": "moved", "keys": int(keys),
             "seconds": time.monotonic() - t0}
        )
        if pace_s > 0:
            if stop_evt is not None:
                stop_evt.wait(pace_s)
            else:
                time.sleep(pace_s)
    return records


# -- I/O shell -------------------------------------------------------------

class RebalanceAgent(threading.Thread):
    """Daemon control loop: scrape LOADMAPs -> plan -> execute wave.

    Armed per-node via ``--rebalance`` (config ``rebalance_enabled``);
    every armed node observes (warm planner for takeover), only the
    coordinator — lowest-id alive primary — executes.  ``CLUSTER
    REBALANCE`` drives :meth:`pause`/:meth:`resume`/:meth:`status`/
    :meth:`tick` over RESP."""

    def __init__(self, server, interval_s: float = 1.0,
                 threshold: float = 1.3, max_moves: int = 8,
                 pace_s: float = 0.05, cooldown_s: float = 15.0,
                 min_heat: float = 1.0, batch: int = 64):
        super().__init__(name="rtpu-rebalance", daemon=True)
        if server.cluster is None:
            raise ValueError("rebalance agent requires cluster mode")
        self.server = server
        self.myid = server.cluster.myid
        self.slotmap = server.cluster.slotmap
        self.obs = server.obs
        self.planner = RebalancePlanner(
            threshold=threshold, max_moves=max_moves,
            cooldown_s=cooldown_s, min_heat=min_heat,
        )
        self.interval_s = float(interval_s)
        self.pace_s = float(pace_s)
        self.batch = int(batch)
        self.paused = False
        self.waves = 0
        self.slots_moved = 0
        self.keys_moved = 0
        self.failures = 0
        self.last_error = ""
        self.last_down: set = set()
        # Serializes ticks: the run loop skips a beat while a RESP
        # `CLUSTER REBALANCE NOW` holds it (NOW runs synchronously in
        # the connection thread so callers observe the wave's result).
        self._tick_lock = _witness.named(
            threading.Lock(), "rebalance.tick"
        )
        self._kick = threading.Event()
        self._stop_evt = threading.Event()
        self._last_coord: Optional[str] = None
        if self.obs is not None:
            self.obs.rebalancer_imbalance_source = (
                lambda: self.planner.last_ratio
            )
        server.rebalancer = self

    def stop(self, join_timeout_s: float = 5.0) -> None:
        self._stop_evt.set()
        self._kick.set()
        if self.is_alive():
            self.join(timeout=join_timeout_s)

    # -- control surface ---------------------------------------------------

    def pause(self) -> None:
        self.paused = True

    def resume(self) -> None:
        self.paused = False

    def status(self) -> dict:
        excluded = self.last_down | self._failover_failed()
        coord = self._coordinator(excluded)
        return {
            "enabled": True,
            "paused": self.paused,
            "coordinator": coord,
            "is_coordinator": coord == self.myid,
            "interval_ms": int(self.interval_s * 1000),
            "threshold": self.planner.threshold,
            "max_moves": self.planner.max_moves,
            "pace_ms": int(self.pace_s * 1000),
            "cooldown_ms": int(self.planner.cooldown_s * 1000),
            "imbalance_ratio": round(self.planner.last_ratio, 4),
            "loads": {
                n: round(v, 2)
                for n, v in sorted(self.planner.last_loads.items())
            },
            "ticks": self.planner.ticks,
            "waves": self.waves,
            "slots_moved": self.slots_moved,
            "keys_moved": self.keys_moved,
            "failures": self.failures,
            "draining": sorted(self.planner.draining),
            "down": sorted(self.last_down),
            "last_error": self.last_error,
        }

    # -- bus I/O -----------------------------------------------------------

    def _call(self, node_id: str, *cmd):
        """One request on a short-lived connection; None on any network
        failure (a down node degrades the scrape, it never raises)."""
        addr = self.slotmap.addr(node_id)
        if addr is None:
            return None
        try:
            sock = socket.create_connection(addr, timeout=1.0)
        except OSError:
            return None
        try:
            sock.settimeout(2.0)
            (reply,) = exchange(sock, [cmd])
            return reply
        except OSError:
            return None
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _scrape(self):
        """Every primary's LOADMAP -> (per_node heat rows, down set).
        An unreachable member is reported, not raised — one dead node
        must not blind the assigner."""
        per_node: dict = {}
        down: set = set()
        for nid in self.slotmap.primary_ids():
            reply = self._call(nid, "CLUSTER", "LOADMAP")
            if reply is None or isinstance(reply, ReplyError):
                down.add(nid)
                continue
            try:
                snap = json.loads(reply)
                fields = snap["fields"]
                i_ops = fields.index("ops")
                i_dev = fields.index("device_us")
                i_keys = fields.index("keys")
                per_node[nid] = {
                    int(s): (
                        float(vec[i_ops]), float(vec[i_dev]),
                        int(vec[i_keys]),
                    )
                    for s, vec in snap.get("slots", {}).items()
                }
            except (ValueError, KeyError, TypeError):
                down.add(nid)
        return per_node, down

    def _failover_failed(self) -> set:
        fo = getattr(self.server, "failover", None)
        if fo is None:
            return set()
        return set(fo.state.failed)

    def _coordinator(self, excluded) -> Optional[str]:
        alive = [
            p for p in self.slotmap.primary_ids() if p not in excluded
        ]
        return min(alive) if alive else None

    # -- the loop ----------------------------------------------------------

    def run(self) -> None:
        while not self._stop_evt.is_set():
            self._kick.wait(self.interval_s)
            self._kick.clear()
            if self._stop_evt.is_set():
                break
            try:
                self.tick()
            except Exception:  # pragma: no cover — the loop must not die
                pass

    def tick(self, force: bool = False) -> int:
        """One observe/plan/execute cycle; returns migrations executed.
        ``force`` (CLUSTER REBALANCE NOW) runs even while paused and
        even off-coordinator — an explicit operator override."""
        if self.paused and not force:
            return 0
        with self._tick_lock:
            return self._tick_locked(force)

    def _tick_locked(self, force: bool) -> int:
        now = time.monotonic()
        per_node, down = self._scrape()
        self.last_down = down
        excluded = down | self._failover_failed()
        self.planner.observe(per_node, now)
        coord = self._coordinator(excluded)
        if coord != self._last_coord:
            events = self._events()
            if events is not None:
                events.emit("rebalance.coordinator",
                            coordinator=coord or "",
                            previous=self._last_coord or "")
            self._last_coord = coord
        if not force and coord != self.myid:
            return 0  # observer only — planner stays warm for takeover
        owners: dict = {}
        primaries = self.slotmap.primary_ids()
        for nid in primaries:
            for start, end in self.slotmap.ranges(nid):
                for s in range(start, end + 1):
                    owners[s] = nid
        moves = self.planner.plan(owners, primaries, excluded, now)
        self._bump_counter("rebalancer_decisions", "planned", len(moves))
        if not moves:
            return 0
        events = self._events()
        if events is not None:
            events.emit("rebalance.wave.planned", moves=len(moves),
                        imbalance=round(self.planner.last_ratio, 4))
        tracer = getattr(self.obs, "trace", None) if self.obs else None
        if tracer is not None:
            with tracer.span_scope("rebalance.wave") as span:
                records = self._execute(moves, excluded, now)
                if span is not None:
                    span.annotate("moves", len(moves))
                    span.annotate("moved", sum(
                        1 for r in records if r["outcome"] == "moved"
                    ))
        else:
            records = self._execute(moves, excluded, now)
        return sum(1 for r in records if r["outcome"] == "moved")

    def _execute(self, moves, excluded, now: float) -> list:
        self.waves += 1
        wave_t0 = time.monotonic()
        records = run_wave(
            self.slotmap, moves, excluded=excluded, batch=self.batch,
            pace_s=self.pace_s, stop_evt=self._stop_evt,
        )
        events = self._events()
        for rec in records:
            outcome = rec["outcome"]
            self._bump_counter("rebalancer_decisions", outcome, 1)
            if events is not None and outcome.startswith("skip_"):
                events.emit("rebalance.wave.skipped",
                            slot=rec["move"].slot,
                            reason=outcome[len("skip_"):])
            if outcome == "moved":
                self.slots_moved += 1
                self.keys_moved += rec["keys"]
                self.planner.note_moved(rec["move"].slot, now)
                if self.obs is not None:
                    try:
                        self.obs.rebalancer_keys_moved.inc(
                            (), rec["keys"]
                        )
                        self.obs.rebalancer_migration_seconds.observe(
                            (), rec["seconds"]
                        )
                    except AttributeError:
                        pass
            elif outcome == "failed":
                self.failures += 1
                self.last_error = rec.get("error", "")
                # Failed attempts cool down too: whatever broke the
                # pump (unmigratable key, flapping peer) won't be fixed
                # by an immediate retry storm.
                self.planner.note_moved(rec["move"].slot, now)
        wave_ms = (time.monotonic() - wave_t0) * 1e3
        if events is not None:
            events.emit(
                "rebalance.wave.executed",
                moved=sum(1 for r in records if r["outcome"] == "moved"),
                failed=sum(1 for r in records
                           if r["outcome"] == "failed"),
                skipped=sum(1 for r in records
                            if r["outcome"].startswith("skip_")),
                ms=round(wave_ms, 3),
            )
        if self.obs is not None:
            try:
                self.obs.latency.record("rebalance-wave", wave_ms)
            except AttributeError:
                pass
        return records

    def _bump_counter(self, family: str, kind: str, n: int) -> None:
        if self.obs is None or not n:
            return
        try:
            getattr(self.obs, family).inc((kind,), n)
        except AttributeError:
            pass

    def _events(self):
        return getattr(self.obs, "events", None)
