"""Decayed access-heat tracking (counterpart of
``redisson_tpu/storage/heat.py``).

One ``HeatTracker`` per engine scores every named sketch by an
exponentially-decayed access counter: each touch adds 1 after decaying
the stored value by ``2^(-dt/half_life)``.  The score is the residency
ladder's ONLY ranking signal (coldest demote first, hottest promote
first).  (The JAX package also serves ``OBJECT FREQ`` / ``OBJECT
IDLETIME`` from it; the port has no RESP front door yet.)

Fed from the engine's entry-point lookups (``_lookup_kind`` /
``hll_ensure`` / ``bitset_ensure`` — the same choke points the
near-cache epoch hooks mark), so every read AND write of every op path
counts exactly once per API call.

The clock is injectable (tests drive a fake clock instead of real
waits), and the table is bounded: past
``max_entries`` the coldest half is folded away — a pruned name that
returns simply restarts from zero heat, which only delays its next
promotion by a touch or two.
"""

from __future__ import annotations

import math
import threading
import time

from redisson_tpu_torch.analysis import witness as _witness



class HeatTracker:
    def __init__(self, half_life_s: float = 10.0, *,
                 max_entries: int = 1 << 17, clock=time.monotonic):
        self.half_life_s = float(half_life_s)
        self.max_entries = int(max_entries)
        self._clock = clock
        self._lock = _witness.named(threading.Lock(), "storage.heat")
        # name -> (heat_at_stamp, stamp).  Decay is lazy: applied on
        # touch and on read, so an idle tracker costs nothing.
        self._heat: dict[str, tuple] = {}

    def _decayed(self, heat: float, stamp: float, now: float) -> float:
        dt = now - stamp
        if dt <= 0.0:
            return heat
        hl = self.half_life_s
        if hl <= 0.0 or dt > 64.0 * hl:
            return 0.0
        return heat * math.pow(2.0, -dt / hl)

    def touch(self, name: str, n: int = 1) -> None:
        """Lock-free on purpose: this runs on EVERY engine op's entry
        point, ladder armed or not (it feeds OBJECT FREQ/IDLETIME).
        Individual dict probes/stores are GIL-atomic; a concurrent
        touch of the same name can lose one bump and a racing prune's
        table swap can drop one — both benign for an advisory ranking
        signal (heat ±1 never flips a tier decision that the next
        touch wouldn't flip back).  Structural ops (prune / drop /
        rename / snapshot / reads) still serialize on the lock."""
        d = self._heat
        now = self._clock()
        ent = d.get(name)
        if ent is None:
            d[name] = (float(n), now)
            if len(d) > self.max_entries:
                with self._lock:
                    if len(self._heat) > self.max_entries:
                        self._prune_locked(now)
            return
        heat, stamp = ent
        d[name] = (self._decayed(heat, stamp, now) + n, now)

    def heat(self, name: str) -> float:
        """Current decayed heat (0.0 for never-touched names)."""
        now = self._clock()
        with self._lock:
            ent = self._heat.get(name)
            if ent is None:
                return 0.0
            return self._decayed(ent[0], ent[1], now)

    def idle_s(self, name: str) -> float:
        """Seconds since the last touch (0.0 for never-touched names —
        a fresh object has by definition just been created)."""
        with self._lock:
            ent = self._heat.get(name)
            if ent is None:
                return 0.0
            return max(0.0, self._clock() - ent[1])

    def snapshot(self) -> dict:
        """{name: decayed_heat} — ONE lock hold, used by the residency
        thread's ranking pass."""
        now = self._clock()
        with self._lock:
            # list() is one C-level call (atomic under the GIL) — the
            # per-item Python work below must not iterate the live
            # dict, which lock-free touches keep mutating.
            items = list(self._heat.items())
        return {n: self._decayed(h, s, now) for n, (h, s) in items}

    def drop(self, name: str) -> None:
        with self._lock:
            self._heat.pop(name, None)

    def rename(self, old: str, new: str) -> None:
        with self._lock:
            ent = self._heat.pop(old, None)
            if ent is not None:
                self._heat[new] = ent

    def _prune_locked(self, now: float) -> None:
        """Fold away the coldest half — bounds the table for name-churn
        workloads (the nearcache `_epochs` discipline; see module doc
        for why losing a cold name's heat is benign)."""
        scored = sorted(
            list(self._heat.items()),  # atomic copy vs lock-free touch
            key=lambda kv: self._decayed(kv[1][0], kv[1][1], now),
            reverse=True,
        )
        self._heat = dict(scored[: self.max_entries // 2])

    def __len__(self) -> int:
        with self._lock:
            return len(self._heat)
