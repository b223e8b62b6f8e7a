"""Self-healing dispatch: circuit breakers and executor health.

Counterpart of ``redisson_tpu/executor/health.py``, state for state.  The
coalescer's retry loop handles TRANSIENT dispatch failures; a device (or
op path) that fails persistently needs a different discipline — stop
hammering it, keep serving, and probe for recovery:

- :class:`CircuitBreaker` / :class:`BreakerBoard` — per-(shard, opcode)
  breakers with the classic CLOSED -> OPEN -> HALF_OPEN machine:
  ``failure_threshold`` consecutive failures open the circuit; after
  ``open_s`` the breaker admits ONE probe dispatch (HALF_OPEN); probe
  success closes it, probe failure re-opens the clock.
- :class:`DispatchHealth` — the per-executor health state machine the
  engine and coalescer share: it maps opcode labels to sketch kinds,
  tracks which kinds are DEGRADED (serving from the host golden mirror,
  see objects/degraded.py), runs a lazy monitor thread that issues probe
  dispatches while any breaker is open, and calls the engine's
  reconcile callback when a breaker closes.

One card is one shard: failures attribute to shard 0 unless the
exception carries a ``.shard`` attribute.

Everything is cheap while healthy: no thread runs, and the fast-path
checks are one attribute read until the first failure.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from redisson_tpu_torch.analysis import witness as _witness


CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_STATE_CODE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


class CircuitOpenError(RuntimeError):
    """Dispatch refused fast: the (shard, opcode) circuit is OPEN."""

    def __init__(self, shard, opcode: str):
        super().__init__(
            f"circuit open for shard={shard} opcode={opcode!r} — "
            f"dispatch refused without touching the device"
        )
        self.shard = shard
        self.opcode = opcode


class CircuitBreaker:
    """State for one (shard, opcode) circuit; mutated under the board lock."""

    __slots__ = ("shard", "opcode", "state", "failures", "opened_at",
                 "probe_at", "opens", "last_error")

    def __init__(self, shard, opcode: str):
        self.shard = shard
        self.opcode = opcode
        self.state = CLOSED
        self.failures = 0
        self.opened_at = 0.0
        self.probe_at = None  # monotonic stamp of the in-flight probe
        self.opens = 0  # lifetime OPEN transitions (introspection)
        self.last_error: Optional[str] = None


class BreakerBoard:
    """Registry of per-(shard, opcode) breakers with transition callbacks.

    ``on_open(shard, opcode)`` / ``on_close(shard, opcode)`` fire OUTSIDE
    the board lock (they call back into engine machinery)."""

    def __init__(self, *, failure_threshold: int = 5, open_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = max(1, int(failure_threshold))
        self.open_s = float(open_s)
        self._clock = clock
        self._lock = _witness.named(threading.Lock(), "health.breakers")
        self._breakers: dict[tuple, CircuitBreaker] = {}
        self.on_open: Optional[Callable] = None
        self.on_close: Optional[Callable] = None

    def _get_locked(self, shard, opcode: str) -> CircuitBreaker:
        key = (shard, opcode)
        b = self._breakers.get(key)
        if b is None:
            b = self._breakers[key] = CircuitBreaker(shard, opcode)
        return b

    def allow(self, shard, opcode: str) -> bool:
        """May a dispatch for this circuit proceed right now?  In
        HALF_OPEN exactly one caller is admitted as the probe; a probe
        that never reports back frees the slot after another ``open_s``
        (defensive — record_* normally clears it)."""
        if not self._breakers:  # fast path: nothing ever failed
            return True
        with self._lock:
            b = self._breakers.get((shard, opcode))
            if b is None or b.state == CLOSED:
                return True
            now = self._clock()
            if b.state == OPEN:
                if now - b.opened_at < self.open_s:
                    return False
                b.state = HALF_OPEN
                b.probe_at = now
                return True  # this caller IS the probe
            # HALF_OPEN: one probe at a time.
            if b.probe_at is not None and now - b.probe_at < self.open_s:
                return False
            b.probe_at = now
            return True

    def record_failure(self, shard, opcode: str, exc=None) -> None:
        cb = None
        with self._lock:
            b = self._get_locked(shard, opcode)
            b.last_error = repr(exc) if exc is not None else None
            if b.state == HALF_OPEN:
                # Probe failed: back to OPEN, clock restarts.
                b.state = OPEN
                b.opened_at = self._clock()
                b.probe_at = None
                b.opens += 1
            elif b.state == CLOSED:
                b.failures += 1
                if b.failures >= self.failure_threshold:
                    b.state = OPEN
                    b.opened_at = self._clock()
                    b.opens += 1
                    cb = self.on_open
        if cb is not None:
            cb(shard, opcode)

    def record_success(self, shard, opcode: str) -> None:
        if not self._breakers:
            return
        cb = None
        with self._lock:
            b = self._breakers.get((shard, opcode))
            if b is None:
                return
            if b.state == HALF_OPEN:
                b.state = CLOSED
                b.failures = 0
                b.probe_at = None
                cb = self.on_close
            elif b.state == CLOSED:
                b.failures = 0
        if cb is not None:
            cb(shard, opcode)

    def force_open(self, shard, opcode: str) -> None:
        """Re-open without a dispatch failure (reconcile-on-close failed:
        the device accepted the probe but rejected the state write)."""
        with self._lock:
            b = self._get_locked(shard, opcode)
            b.state = OPEN
            b.opened_at = self._clock()
            b.probe_at = None
            b.opens += 1

    # -- introspection -----------------------------------------------------

    def states(self) -> dict:
        with self._lock:
            return {k: b.state for k, b in self._breakers.items()}

    def state_codes(self) -> dict:
        """{(shard, opcode): 0|1|2} for the rtpu_breaker_state gauge."""
        with self._lock:
            return {
                (str(k[0]), k[1]): _STATE_CODE[b.state]
                for k, b in self._breakers.items()
            }

    def open_count(self) -> int:
        with self._lock:
            return sum(
                1 for b in self._breakers.values() if b.state != CLOSED
            )

    def not_closed(self) -> list:
        with self._lock:
            return [
                (k[0], k[1], b.state)
                for k, b in self._breakers.items()
                if b.state != CLOSED
            ]


def kind_of_op(op_label: str) -> Optional[str]:
    """Sketch kind an opcode label belongs to (segment keys and executor
    method names share these prefixes)."""
    for prefix, kind in (
        ("bloom", "bloom"),
        ("bs_", "bitset"),
        ("bitset", "bitset"),
        ("hll", "hll"),
        ("cms", "cms"),
    ):
        if op_label.startswith(prefix):
            return kind
    return None


class DispatchHealth:
    """Per-executor health state machine + degradation coordinator.

    Coalescer side: ``allow_dispatch`` / ``record_failure`` /
    ``record_success`` drive the breakers per flush.  Engine side:
    ``any_degraded`` + ``degraded_kind`` gate the golden-mirror failover,
    ``ensure_probe`` registers a harmless device dispatch per kind, and
    ``reconcile_cb`` (set by the engine) is invoked when the last breaker
    of a kind closes so mirrored state writes back to the device.
    """

    def __init__(self, *, failure_threshold: int = 5, open_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic,
                 monitor_interval_s: Optional[float] = None):
        self.board = BreakerBoard(
            failure_threshold=failure_threshold, open_s=open_s, clock=clock
        )
        self.board.on_open = self._on_open
        self.board.on_close = self._on_close
        self._clock = clock
        self._interval = (
            monitor_interval_s
            if monitor_interval_s is not None
            else max(0.005, open_s / 4.0)
        )
        self._lock = _witness.named(threading.Lock(), "health.state")
        self._probes: dict[str, Callable] = {}  # kind -> probe dispatch
        self._degraded: set[str] = set()
        self.any_degraded = False  # lock-free fast-path flag
        self.reconcile_cb: Optional[Callable[[str], bool]] = None
        self._monitor: Optional[threading.Thread] = None
        self._monitor_wake = threading.Event()
        self._closed = False
        self.degrade_events = 0  # lifetime kind-degradations (introspection)
        self.recoveries = 0
        # Observability bundle (set by the engine): breaker-open LATENCY
        # samples and the health.* flight-recorder events.
        self.obs = None
        self._open_ms = open_s * 1e3

    # -- coalescer/executor surface ---------------------------------------

    def allow_dispatch(self, opcode: str, shard=0) -> bool:
        return self.board.allow(shard, opcode)

    def record_failure(self, opcode: str, exc=None, shard=0) -> None:
        shard = getattr(exc, "shard", shard)
        self.board.record_failure(shard, opcode, exc)

    def record_success(self, opcode: str, shard=0) -> None:
        self.board.record_success(shard, opcode)

    # -- degradation bookkeeping -------------------------------------------

    def degraded_kind(self, kind: Optional[str]) -> bool:
        return kind is not None and kind in self._degraded

    def ensure_probe(self, kind: str, fn: Callable) -> None:
        """Register the recovery probe for a kind (idempotent; the first
        mirrored entry of a kind supplies it — typically a ``read_row``
        against the degraded pool, which exercises the REAL dispatch
        path including the chaos fault points)."""
        with self._lock:
            self._probes.setdefault(kind, fn)

    def clear_degraded(self, kind: str) -> None:
        """Drop a kind from the degraded set.  Called by the engine's
        reconcile WHILE IT STILL HOLDS THE MIRROR LOCK, so the flag
        clears atomically with the mirror removal — a serving thread
        checking ``_degraded()`` either sees (mirror present, flag set)
        and uses the mirror, or (mirror gone, flag cleared) and uses the
        device; the in-between state that re-seeded an orphan mirror
        after reconcile cannot be observed."""
        with self._lock:
            self._degraded.discard(kind)
            self.any_degraded = bool(self._degraded)

    def _on_open(self, shard, opcode: str) -> None:
        obs = self.obs
        if obs is not None and obs.latency.threshold_ms > 0:
            obs.latency.record("breaker-open", self._open_ms)
        kind = kind_of_op(opcode)
        events = getattr(obs, "events", None)
        if events is not None:
            events.emit("health.breaker.open", severity="warn",
                        shard=str(shard), opcode=opcode,
                        kind=kind or "", open_ms=self._open_ms)
        with self._lock:
            if kind is not None and kind not in self._degraded:
                self._degraded.add(kind)
                self.degrade_events += 1
            self.any_degraded = bool(self._degraded)
            self._start_monitor_locked()
        self._monitor_wake.set()

    def _on_close(self, shard, opcode: str) -> None:
        """Last breaker of a kind closed → reconcile mirrors back to the
        device.  Deferred to a dedicated thread: record_success fires
        from the coalescer's COMPLETER thread, and reconciling inline
        there (mirror lock → write_row) can close a circular wait with a
        mirror-seeding thread whose drain barrier needs the flush thread,
        whose launch slot needs this completer.  The mirror stays
        authoritative (ops keep routing to it) until the reconcile
        thread finishes under the mirror lock, so the window loses no
        writes.  A failed reconcile re-opens the breaker (the device is
        not actually ready) and keeps the kind degraded."""
        kind = kind_of_op(opcode)
        if kind is None:
            return
        threading.Thread(
            target=self._finish_close, args=(shard, opcode, kind),
            name="rtpu-health-reconcile", daemon=True,
        ).start()

    def _finish_close(self, shard, opcode: str, kind: str) -> None:
        still_open = any(
            kind_of_op(op) == kind for _, op, _ in self.board.not_closed()
        )
        if still_open:
            return
        cb = self.reconcile_cb
        ok = True
        if cb is not None and kind in self._degraded:
            # A successful cb clears the degraded flag ITSELF, under the
            # engine's mirror lock (see clear_degraded) — clearing it
            # here, after the mirrors were dropped, left a window where
            # a serving thread re-seeded an orphan mirror that no future
            # reconcile would ever drain.
            try:
                ok = bool(cb(kind))
            except Exception:
                ok = False
        events = getattr(self.obs, "events", None)
        if ok:
            with self._lock:
                self._degraded.discard(kind)  # idempotent (cb-less path)
                self.any_degraded = bool(self._degraded)
                self.recoveries += 1
            if events is not None:
                events.emit("health.breaker.close", shard=str(shard),
                            opcode=opcode, kind=kind)
        else:
            if events is not None:
                events.emit("health.reconcile.failed", severity="error",
                            shard=str(shard), opcode=opcode, kind=kind)
            self.board.force_open(shard, opcode)
            with self._lock:
                # The monitor may have exited in the closed window —
                # restart it so the re-opened breaker keeps probing.
                self._start_monitor_locked()
            self._monitor_wake.set()

    # -- recovery monitor --------------------------------------------------

    def _start_monitor_locked(self) -> None:
        if self._monitor is not None and self._monitor.is_alive():
            return
        self._monitor_wake.clear()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="rtpu-health-monitor", daemon=True
        )
        self._monitor.start()

    def _monitor_loop(self) -> None:
        """Runs only while some breaker is not CLOSED: waits out open
        windows, then issues the kind's probe dispatch.  Each probe goes
        through the real executor path, so its success/failure is an
        honest device sample (and chaos can hit it too)."""
        while not self._closed:
            open_now = self.board.not_closed()
            if not open_now:
                return  # all healthy — die; a future open restarts us
            for shard, opcode, _state in open_now:
                if self._closed:
                    return
                kind = kind_of_op(opcode)
                probe = self._probes.get(kind) if kind else None
                if probe is None:
                    # No probe registered (no mirror yet / standalone
                    # coalescer): leave the circuit alone — the next
                    # REAL dispatch admitted by allow() after the open
                    # window is the probe.  Checked before allow() so
                    # the monitor never claims the probe slot it cannot
                    # use.
                    continue
                if not self.board.allow(shard, opcode):
                    continue  # window not elapsed / probe already out
                try:
                    probe()
                except Exception as e:
                    self.board.record_failure(shard, opcode, e)
                else:
                    self.board.record_success(shard, opcode)
            self._monitor_wake.wait(timeout=self._interval)
            self._monitor_wake.clear()

    # -- introspection / lifecycle -----------------------------------------

    def state(self) -> str:
        """Coarse executor health: healthy | probing | degraded."""
        open_now = self.board.not_closed()
        if not open_now and not self._degraded:
            return "healthy"
        if any(s == HALF_OPEN for _, _, s in open_now):
            return "probing"
        return "degraded" if self._degraded else "probing"

    def summary(self) -> dict:
        return {
            "state": self.state(),
            "degraded_kinds": sorted(self._degraded),
            "breakers": {
                f"{s}:{op}": st for (s, op), st in self.board.states().items()
            },
            "degrade_events": self.degrade_events,
            "recoveries": self.recoveries,
        }

    def shutdown(self) -> None:
        self._closed = True
        self._monitor_wake.set()
        m = self._monitor
        if m is not None:
            m.join(timeout=2.0)
