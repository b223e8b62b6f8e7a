"""Continuous invariant doctor: the netsim
models' offline invariants — no dual primary, offsets converge, no
stuck migration, epochs only grow — re-run continuously against the
LIVE fleet, Slicer-style (PAPERS.md §3 ships its assigner with exactly
this kind of production-time self-checking).

One :class:`FleetDoctor` daemon thread per armed node (``--doctor``),
coordinator-elected like the rebalancer (lowest-id alive primary) so
exactly one node audits at a time while every armed node stays warm
for takeover.  Each sweep:

- **liveness** — probe every node (``RTPU.CLUSTERPING``, one retry);
  a dead PRIMARY still owning slots is the ``dead-primary`` finding
  (the unavailability window the failover exists to close);
- **slot ownership** — every slot owned by exactly one alive primary
  in this node's map (``unassigned-slots``), and every reachable
  peer's ``CLUSTER SHARDS`` agrees with the coordinator's view
  (``topology-divergence``);
- **replication** — per-node offsets from the ping replies must be
  monotone sweep-over-sweep (``offset-regression``: acked history
  vanished) and replica lag within ``lag_bound_ops`` (``repl-lag``);
- **epochs** — a node reporting a SMALLER epoch than its last sweep
  lost coordination state (``epoch-regression``);
- **migrations** — a slot stuck MIGRATING/IMPORTING longer than
  ``stuck_slot_s`` (``stuck-migration``: an operator or pump died
  mid-reshard, the slot is serving redirects forever);
- **canary** — a black-box WAIT-fenced write-then-read probe per
  primary through the real client path, on a reserved hash-tag
  keyspace (``{__rtpu-doctor-N}``): true availability and acked-write
  durability measured from OUTSIDE the process (``canary``).

Findings are STATE, not edges: each sweep recomputes the active set,
newly-raised ones emit ``doctor.finding`` (+ the
``rtpu_doctor_findings`` counter by kind), resolved ones emit
``doctor.clear`` — so a chaos window reads as raise → (failover fixes
the fleet) → clear, and a clean fleet stays at zero findings (the
zero-false-positive bar in tests/test_torch_doctor.py).

``CLUSTER DOCTOR`` serves the human-readable report (the LATENCY
DOCTOR analog for the cluster plane); ``CLUSTER DOCTOR STATUS`` the
JSON; PAUSE/RESUME/NOW mirror the rebalancer's verbs.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Optional

from redisson_tpu_torch.analysis import witness as _witness
from redisson_tpu_torch.serve.wireutil import ReplyError, exchange

# Finding kinds (bounded: the rtpu_doctor_findings label dimension).
FINDING_KINDS = (
    "dead-primary",
    "unassigned-slots",
    "topology-divergence",
    "offset-regression",
    "repl-lag",
    "epoch-regression",
    "stuck-migration",
    "canary",
)

_SEVERITY = {
    "dead-primary": "error",
    "unassigned-slots": "error",
    "topology-divergence": "warn",
    "offset-regression": "error",
    "repl-lag": "warn",
    "epoch-regression": "error",
    "stuck-migration": "warn",
    "canary": "error",
}


def canary_key(node_id: str, slotmap, limit: int = 4096) -> Optional[str]:
    """A key in the reserved ``{__rtpu-doctor-N}`` hash-tag keyspace
    whose slot is owned by ``node_id`` — the per-node canary target.
    Deterministic scan so every doctor agrees on the key; None when the
    node owns no slots (nothing to probe)."""
    from redisson_tpu_torch.cluster.slots import key_slot

    for i in range(limit):
        tag = f"__rtpu-doctor-{i}"
        if slotmap.owner(key_slot(tag.encode())) == node_id:
            return "{%s}:canary" % tag
    return None


class FleetDoctor(threading.Thread):
    """The sweep loop + finding ledger.  Construction registers the
    agent as ``server.doctor`` (the CLUSTER DOCTOR / INFO doctor
    surface); ``start()`` arms the loop."""

    def __init__(self, server, interval_s: float = 1.0,
                 stuck_slot_s: float = 30.0,
                 lag_bound_ops: int = 10_000,
                 canary: bool = True,
                 canary_timeout_ms: int = 500):
        super().__init__(name="rtpu-doctor", daemon=True)
        if server.cluster is None:
            raise ValueError("fleet doctor requires cluster mode")
        self.server = server
        self.myid = server.cluster.myid
        self.slotmap = server.cluster.slotmap
        self.obs = server.obs
        self.interval_s = float(interval_s)
        self.stuck_slot_s = float(stuck_slot_s)
        self.lag_bound_ops = int(lag_bound_ops)
        self.canary_enabled = bool(canary)
        self.canary_timeout_ms = int(canary_timeout_ms)
        self.paused = False
        self.sweeps = 0
        self.findings_total = 0
        self.canary_failures = 0
        self.last_sweep_ms = 0.0
        self.last_down: set = set()
        # finding key ("kind:subject") -> {"kind", "severity",
        # "subject", "detail", "since" (wall)} — the active ledger.
        self.active: dict = {}
        # Sweep-over-sweep memory for the monotonicity checks.
        self._last_seen: dict = {}  # node -> {"epoch","offset","role"}
        self._mig_first_seen: dict = {}  # (node, slot, state) -> mono
        self._canary_seq = 0
        self._tick_lock = _witness.named(threading.Lock(), "doctor.tick")
        self._kick = threading.Event()
        self._stop_evt = threading.Event()
        server.doctor = self

    def stop(self, join_timeout_s: float = 5.0) -> None:
        self._stop_evt.set()
        self._kick.set()
        if self.is_alive():
            self.join(timeout=join_timeout_s)

    # -- control surface (CLUSTER DOCTOR) ----------------------------------

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
            "stuck_slot_ms": int(self.stuck_slot_s * 1000),
            "lag_bound_ops": self.lag_bound_ops,
            "canary_enabled": self.canary_enabled,
            "sweeps": self.sweeps,
            "findings_total": self.findings_total,
            "canary_failures": self.canary_failures,
            "last_sweep_ms": round(self.last_sweep_ms, 3),
            "down": sorted(self.last_down),
            "active_findings": [
                dict(f) for _, f in sorted(self.active.items())
            ],
        }

    def report(self, last_events: int = 12) -> str:
        """CLUSTER DOCTOR: the human diagnosis (the LATENCY DOCTOR
        analog) — fleet state, active findings, recent control-plane
        events from this node's flight recorder."""
        st = self.status()
        lines = [
            f"Fleet doctor on {self.myid} "
            f"(coordinator: {st['coordinator'] or 'none'}"
            f"{', me' if st['is_coordinator'] else ''}; "
            f"sweeps {st['sweeps']}, interval {st['interval_ms']} ms"
            f"{', PAUSED' if st['paused'] else ''}):"
        ]
        for nid in self.slotmap.node_ids():
            role = self.slotmap.role(nid)
            owned = sum(
                b - a + 1 for a, b in self.slotmap.ranges(nid)
            )
            state = "DOWN" if nid in self.last_down else "up"
            lines.append(
                f"- node {nid}: {role}, {owned} slots, {state}"
            )
        if not st["active_findings"]:
            lines.append(
                "No active findings. Every invariant I watch holds; "
                "keep it up!"
            )
        else:
            lines.append(
                f"{len(st['active_findings'])} ACTIVE finding(s):"
            )
            for f in st["active_findings"]:
                age = int(time.time() - f["since"])
                lines.append(
                    f"- [{f['severity']}] {f['kind']} ({f['subject']}): "
                    f"{f['detail']} — active {age}s"
                )
        events = getattr(self.obs, "events", None)
        if events is not None and last_events > 0:
            lines.append(f"Last {last_events} control-plane events:")
            for ev in events.snapshot(count=last_events):
                fields = ",".join(
                    f"{k}={v}" for k, v in sorted(ev["fields"].items())
                )
                lines.append(
                    f"- seq {ev['seq']} [{ev['severity']}] "
                    f"{ev['kind']} {fields}"
                )
        return "\n".join(lines)

    # -- bus I/O (the rebalancer's short-lived-connection idiom) -----------

    def _call(self, node_id: str, *cmds, timeout_s: float = 2.0):
        """Pipeline ``cmds`` (tuples) on a short-lived connection;
        None on any network failure — the sweep degrades, it never
        raises."""
        addr = self.slotmap.addr(node_id)
        if addr is None:
            return None
        try:
            sock = socket.create_connection(addr, timeout=1.0)
        except OSError:
            return None
        try:
            sock.settimeout(timeout_s)
            return exchange(sock, list(cmds))
        except (OSError, ValueError):
            return None
        finally:
            try:
                sock.close()
            except OSError:
                pass

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
        """One sweep; returns the active-finding count.  ``force``
        (CLUSTER DOCTOR NOW) sweeps even while paused and even
        off-coordinator — an explicit operator override."""
        if self.paused and not force:
            return len(self.active)
        with self._tick_lock:
            return self._sweep(force)

    def _sweep(self, force: bool) -> int:
        t0 = time.monotonic()
        # 1. Probe every node: liveness + (epoch, offset, role).
        probes: dict = {}
        down: set = set()
        for nid in self.slotmap.node_ids():
            if nid == self.myid:
                probes[nid] = self._self_probe()
                continue
            got = self._probe(nid)
            if got is None:
                down.add(nid)
            else:
                probes[nid] = got
        self.last_down = down
        excluded = down | self._failover_failed()
        coord = self._coordinator(excluded)
        if not force and coord != self.myid:
            # Observer: keep the monotonicity memory warm so a takeover
            # audits from history, but raise/clear nothing.
            for nid, p in probes.items():
                self._last_seen[nid] = p
            self.last_sweep_ms = (time.monotonic() - t0) * 1e3
            return len(self.active)
        findings: dict = {}

        def raise_finding(kind: str, subject: str, detail: str) -> None:
            findings[f"{kind}:{subject}"] = {
                "kind": kind,
                "severity": _SEVERITY[kind],
                "subject": subject,
                "detail": detail,
                "since": time.time(),
            }

        # 2. Dead primaries still owning slots + slot coverage.
        for nid in down:
            if (self.slotmap.role(nid) == "master"
                    and self.slotmap.ranges(nid)):
                raise_finding(
                    "dead-primary", nid,
                    f"primary unreachable but still owns "
                    f"{sum(b - a + 1 for a, b in self.slotmap.ranges(nid))}"
                    f" slots",
                )
        unassigned = 16384 - self.slotmap.assigned_count()
        if unassigned:
            raise_finding(
                "unassigned-slots", "fleet",
                f"{unassigned} slots have no owner",
            )
        # 3. Cross-node CLUSTER SHARDS compare against my view.
        my_view = self._owner_view(self.slotmap)
        for nid in self.slotmap.node_ids():
            if nid == self.myid or nid in down:
                continue
            peer_view = self._peer_owner_view(nid)
            if peer_view is not None and peer_view != my_view:
                raise_finding(
                    "topology-divergence", nid,
                    "peer's CLUSTER SHARDS disagrees with the "
                    "coordinator's slot map",
                )
        # 4. Offset/epoch monotonicity + replica lag.
        for nid, p in probes.items():
            prev = self._last_seen.get(nid)
            if prev is not None:
                if p["epoch"] < prev["epoch"]:
                    raise_finding(
                        "epoch-regression", nid,
                        f"epoch {p['epoch']} < last seen "
                        f"{prev['epoch']}",
                    )
                if p["role"] == prev["role"] and (
                        p["offset"] < prev["offset"]):
                    raise_finding(
                        "offset-regression", nid,
                        f"offset {p['offset']} < last seen "
                        f"{prev['offset']} (role unchanged: acked "
                        f"history vanished)",
                    )
            primary = self.slotmap.replica_of(nid)
            if primary is not None and primary in probes:
                lag = probes[primary]["offset"] - p["offset"]
                if lag > self.lag_bound_ops:
                    raise_finding(
                        "repl-lag", nid,
                        f"replica {lag} ops behind {primary} "
                        f"(bound {self.lag_bound_ops})",
                    )
        for nid, p in probes.items():
            self._last_seen[nid] = p
        # 5. Stuck MIGRATING/IMPORTING slots (age tracked here: first
        # sweep that SAW the state starts its clock).
        now = time.monotonic()
        live_states: set = set()
        for nid in self.slotmap.node_ids():
            if nid in down:
                continue
            migs = self._peer_migrations(nid)
            if migs is None:
                continue
            for state in ("importing", "migrating"):
                for slot in migs.get(state, {}):
                    k = (nid, int(slot), state)
                    live_states.add(k)
                    first = self._mig_first_seen.setdefault(k, now)
                    if now - first > self.stuck_slot_s:
                        raise_finding(
                            "stuck-migration",
                            f"{nid}/{slot}",
                            f"slot {slot} {state.upper()} on {nid} "
                            f"for {int(now - first)}s "
                            f"(threshold {int(self.stuck_slot_s)}s)",
                        )
        for k in list(self._mig_first_seen):
            if k not in live_states:
                del self._mig_first_seen[k]
        # 6. Black-box canary per alive primary.
        if self.canary_enabled:
            for nid in self.slotmap.primary_ids():
                if nid in down or not self.slotmap.ranges(nid):
                    continue
                err = self._canary_probe(nid)
                if err is not None:
                    self.canary_failures += 1
                    raise_finding("canary", nid, err)
        self._apply_findings(findings)
        self.sweeps += 1
        if self.obs is not None:
            try:
                self.obs.doctor_sweeps.inc((), 1)
            except AttributeError:
                pass
        self.last_sweep_ms = (time.monotonic() - t0) * 1e3
        return len(self.active)

    # -- probes ------------------------------------------------------------

    def _self_probe(self) -> dict:
        fo = getattr(self.server, "failover", None)
        epoch = fo.state.current_epoch if fo is not None else 0
        return {
            "epoch": int(epoch),
            "offset": int(self.server._repl_offset()),
            "role": ("slave" if self.server.replica_link is not None
                     else "master"),
        }

    def _probe(self, nid: str) -> Optional[dict]:
        """CLUSTERPING with ONE retry — a single timed-out connect must
        not read as a dead node (the zero-false-positive bar)."""
        for attempt in (0, 1):
            got = self._call(
                nid, ("RTPU.CLUSTERPING", self.myid, "0")
            )
            if got is not None and not isinstance(got[0], ReplyError):
                reply = got[0]
                if isinstance(reply, list) and len(reply) >= 5:
                    try:
                        return {
                            "epoch": int(reply[2]),
                            "offset": int(reply[3]),
                            "role": bytes(reply[4]).decode(),
                        }
                    except (TypeError, ValueError):
                        return None
            if attempt == 0 and not self._stop_evt.wait(0.1):
                continue
            break
        return None

    @staticmethod
    def _owner_view(slotmap) -> dict:
        """node -> tuple-of-ranges for every PRIMARY (the comparable
        ownership digest)."""
        return {
            nid: tuple(tuple(r) for r in slotmap.ranges(nid))
            for nid in slotmap.primary_ids()
        }

    def _peer_owner_view(self, nid: str) -> Optional[dict]:
        got = self._call(nid, ("CLUSTER", "SHARDS"))
        if got is None or isinstance(got[0], ReplyError):
            return None
        view: dict = {}
        try:
            for shard in got[0]:
                fields = {
                    bytes(shard[i]).decode(): shard[i + 1]
                    for i in range(0, len(shard), 2)
                }
                flat = [int(v) for v in fields["slots"]]
                node = fields["nodes"][0]
                nf = {
                    bytes(node[i]).decode(): node[i + 1]
                    for i in range(0, len(node), 2)
                }
                if bytes(nf["role"]).decode() != "master":
                    continue
                pid = bytes(nf["id"]).decode()
                view[pid] = tuple(
                    (flat[i], flat[i + 1])
                    for i in range(0, len(flat), 2)
                )
        except (TypeError, ValueError, KeyError, IndexError):
            return None
        return view

    def _peer_migrations(self, nid: str) -> Optional[dict]:
        if nid == self.myid:
            with self.slotmap._lock:
                return {
                    "importing": dict(self.slotmap.importing),
                    "migrating": dict(self.slotmap.migrating),
                }
        got = self._call(nid, ("CLUSTER", "MIGRATIONS"))
        if got is None or isinstance(got[0], ReplyError):
            return None
        import json

        try:
            return json.loads(bytes(got[0]))
        except (TypeError, ValueError):
            return None

    def _canary_probe(self, nid: str) -> Optional[str]:
        """WAIT-fenced write-then-read through the real client path;
        None on success, an error string on failure."""
        key = canary_key(nid, self.slotmap)
        if key is None:
            return None  # owns no slots: nothing to probe
        self._canary_seq += 1
        val = f"{self.myid}:{self._canary_seq}"
        t0 = time.monotonic()
        got = self._call(
            nid,
            ("SET", key, val),
            ("WAIT", "0", str(self.canary_timeout_ms)),
            ("GET", key),
            timeout_s=max(2.0, self.canary_timeout_ms / 1000.0 + 2.0),
        )
        rtt_s = time.monotonic() - t0
        if got is None:
            return "canary probe connection failed"
        set_r, _wait_r, get_r = got
        if isinstance(set_r, ReplyError):
            return f"canary SET refused: {set_r}"
        if isinstance(get_r, ReplyError):
            return f"canary GET refused: {get_r}"
        if bytes(get_r or b"") != val.encode():
            return (
                f"canary read-your-write failed: wrote {val!r}, "
                f"read {get_r!r}"
            )
        if self.obs is not None:
            try:
                self.obs.doctor_canary_rtt_us.observe((), rtt_s)
            except AttributeError:
                pass
        return None

    # -- the finding ledger ------------------------------------------------

    def _apply_findings(self, findings: dict) -> None:
        """Diff the freshly-computed set against the active ledger:
        raises emit doctor.finding (+ the kind counter), resolutions
        emit doctor.clear; persisting findings keep their original
        ``since`` stamp."""
        events = getattr(self.obs, "events", None)
        for key, f in findings.items():
            old = self.active.get(key)
            if old is not None:
                f["since"] = old["since"]  # keep the raise time
                continue
            self.findings_total += 1
            if self.obs is not None:
                try:
                    self.obs.doctor_findings.inc((f["kind"],))
                except AttributeError:
                    pass
            if events is not None:
                events.emit("doctor.finding", severity=f["severity"],
                            kind=f["kind"], subject=f["subject"],
                            detail=f["detail"])
                if f["kind"] == "canary":
                    events.emit("doctor.canary", severity="error",
                                node=f["subject"], detail=f["detail"])
        for key in list(self.active):
            if key not in findings:
                f = self.active[key]
                if events is not None:
                    events.emit("doctor.clear", kind=f["kind"],
                                subject=f["subject"],
                                active_s=round(
                                    time.time() - f["since"], 3))
        self.active = findings


__all__ = ["FleetDoctor", "FINDING_KINDS", "canary_key"]
