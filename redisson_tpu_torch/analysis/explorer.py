"""Deterministic schedule explorer.

The engine's hardest bugs (the ``_rc_install`` epoch race, the
reconcile/mirror split-brain, the stranded tenant in-flight charges)
were thread-interleaving bugs: rtpulint's per-function AST rules and
the opt-in runtime witness only catch them *after* the bad schedule
happens to run.  This module makes the schedules ENUMERABLE — CHESS-
style systematic concurrency testing (Musuvathi et al., OSDI'08) on
stdlib primitives:

- ``explore(fn)`` runs ``fn`` under a cooperative scheduler that
  monkeypatches ``threading.Lock/RLock/Condition/Event/Thread``,
  ``time.sleep/monotonic`` and the ``queue`` module's clock for the
  duration of each run.  Every thread the body spawns becomes a
  *simulated* thread: exactly one runs at any instant (execution is
  serialized onto a single carrier at a time, token-passing between
  real OS threads gated on private events), and control returns to the
  scheduler at every synchronization point (lock acquire/release,
  condition wait/notify, event ops, sleep, thread start/join, and
  explicit :func:`checkpoint` calls).  Code between sync points runs
  atomically — the CHESS granularity.
- Time is VIRTUAL: ``time.monotonic`` reads the scheduler's clock,
  which advances only when every simulated thread is blocked (to the
  earliest timed-wait deadline).  A 30 s backoff costs microseconds of
  wall clock, and timed waits are deterministic.
- Interleavings are explored BOUNDED-EXHAUSTIVELY by DFS over the
  scheduler's decision points (lexicographic prefix enumeration, no
  tree kept in memory) up to ``max_schedules``; if the tree is larger,
  the remaining budget is spent on seeded-random schedules.  A
  ``preemption_bound`` caps how many times a schedule may switch away
  from a thread that could have continued (CHESS's key result: most
  real races need <= 2 preemptions), which collapses the search space
  without losing the bugs.
- All simulated threads being blocked with no timed wait pending is a
  DEADLOCK: the run fails with every thread's blocking reason and held
  locks.  An assertion/exception in any simulated thread fails the
  run.
- Every failing schedule prints a REPLAY TOKEN (the decision string);
  ``RTPU_SCHEDULE_REPLAY=x:0.1.2`` re-runs exactly that schedule, so a
  CI failure reproduces deterministically on any machine.

``@schedule_test`` wraps a pytest test body in ``explore`` and tags it
with the ``explorer`` marker (see tests/test_torch_explorer.py).

Scope and honesty notes: objects must be CREATED inside the explored
body (a lock created before ``explore`` patched ``threading`` is a
real lock the scheduler cannot see — a thread blocking on one hangs
the run and is reported by the watchdog).  Non-simulated threads that
touch patched primitives fall back to real-lock behavior; the two
worlds share no blocking state.  ``threading.local`` is untouched
(simulated threads are real OS threads, so TLS works naturally).
"""

from __future__ import annotations

import _thread
import functools
import os
import queue as _queue_module
import random
import threading
import time as _time_module
import traceback
from typing import Callable, List, Optional

# Originals, captured at import time — before any run patches them.
_RealThread = threading.Thread
_RealLock = threading.Lock
_real_sleep = _time_module.sleep
_real_monotonic = _time_module.monotonic


class _MiniEvent:
    """Handoff primitive built directly on ``_thread.allocate_lock``.

    The scheduler cannot use ``threading.Event``/``Condition`` for its
    own token passing: those classes build their internals through the
    threading module's GLOBALS (``Condition(Lock())``), which are
    exactly what a run patches — the scheduler would recurse into its
    own cooperative primitives.  Raw interpreter locks are immune.

    ``set``/``take`` are one-shot handoff (take consumes); ``wait`` is
    a latch probe (leaves the event set) for completion flags."""

    __slots__ = ("_lock",)

    def __init__(self):
        self._lock = _thread.allocate_lock()
        self._lock.acquire()  # start "cleared"

    def set(self) -> None:
        try:
            self._lock.release()
        except RuntimeError:
            pass  # already set

    def take(self, timeout: Optional[float] = None) -> bool:
        if timeout is None:
            self._lock.acquire()
            return True
        return self._lock.acquire(True, timeout)

    def drain(self) -> None:
        self._lock.acquire(False)

    def wait(self, timeout: Optional[float] = None) -> bool:
        if timeout is None:
            self._lock.acquire()
            self._lock.release()
            return True
        if self._lock.acquire(True, timeout):
            self._lock.release()
            return True
        return False

REPLAY_ENV = "RTPU_SCHEDULE_REPLAY"

_tls = threading.local()

_active_guard = _RealLock()
_active: Optional["_Run"] = None


def _cur_sim() -> Optional["_SimThread"]:
    return getattr(_tls, "sim", None)


class _Killed(BaseException):
    """Raised inside a simulated thread at teardown (daemon reaping)."""


class DeadlockError(AssertionError):
    """Every simulated thread is blocked and no timed wait can fire."""


class ScheduleOverrun(AssertionError):
    """A schedule exceeded ``max_steps`` decisions (unbounded loop in
    the model — bound the body, or raise the limit)."""


class ExplorerHang(RuntimeError):
    """A simulated thread failed to reach a sync point within the real-
    time watchdog — almost always an uninstrumented blocking call (a
    lock created OUTSIDE the explored body, real socket I/O, ...)."""


class ScheduleFailure(AssertionError):
    """One explored schedule failed; ``token`` replays it."""

    def __init__(self, message: str, token: str):
        super().__init__(message)
        self.token = token


class ExploreResult:
    __slots__ = ("schedules", "complete", "replayed")

    def __init__(self, schedules: int, complete: bool, replayed: bool = False):
        self.schedules = schedules  # schedules actually run
        self.complete = complete    # True: the interleaving tree was exhausted
        self.replayed = replayed

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"ExploreResult(schedules={self.schedules}, "
                f"complete={self.complete})")


# -- schedule decisions -------------------------------------------------------


class _Decisions:
    """Decision source for ONE schedule.  Consumes ``prefix`` first
    (replay / DFS continuation), then extends with 0 (exhaustive DFS
    default branch) or seeded-random picks.  Records (chosen, nalts)
    so the driver can enumerate siblings and print replay tokens.
    Choice points with a single candidate are NOT recorded — decision
    strings stay short and stable."""

    __slots__ = ("prefix", "rng", "record")

    def __init__(self, prefix=(), rng: Optional[random.Random] = None):
        self.prefix = list(prefix)
        self.rng = rng
        self.record: List[tuple] = []

    def pick(self, nalts: int) -> int:
        i = len(self.record)
        if i < len(self.prefix):
            c = min(self.prefix[i], nalts - 1)  # clamp: replay robustness
        elif self.rng is not None:
            c = self.rng.randrange(nalts)
        else:
            c = 0
        self.record.append((c, nalts))
        return c

    @property
    def token(self) -> str:
        return "x:" + ".".join(str(c) for c, _ in self.record)


def _parse_token(token: str) -> list:
    tok = token.strip()
    if tok.startswith("x:"):
        tok = tok[2:]
    if not tok:
        return []
    try:
        return [int(p) for p in tok.split(".")]
    except ValueError:
        raise ValueError(f"malformed replay token {token!r} "
                         f"(expected x:0.1.2...)") from None


def _next_prefix(record) -> Optional[list]:
    """Lexicographic DFS: the next unexplored decision prefix after a
    run recorded ``record`` [(chosen, nalts)], or None when the tree
    is exhausted."""
    for i in range(len(record) - 1, -1, -1):
        c, n = record[i]
        if c + 1 < n:
            return [c0 for c0, _ in record[:i]] + [c + 1]
    return None


# -- simulated threads --------------------------------------------------------


class _SimThread:
    __slots__ = (
        "run", "tid", "name", "daemon", "target", "args", "kwargs",
        "state", "go", "finished", "blocked_on", "wake_at", "timed_out",
        "killed", "held", "joiners", "exc", "os_thread",
    )

    def __init__(self, run: "_Run", target, args, kwargs, name, daemon):
        self.run = run
        self.tid = len(run.threads)
        self.name = name or f"sim-{self.tid}"
        self.daemon = daemon
        self.target = target
        self.args = args
        self.kwargs = kwargs
        self.state = "new"  # new | runnable | running | blocked | done
        self.go = _MiniEvent()
        self.finished = _MiniEvent()
        self.blocked_on: Optional[str] = None
        self.wake_at: Optional[float] = None
        self.timed_out = False
        self.killed = False
        self.held: list = []     # ExpLocks currently held (deadlock report)
        self.joiners: list = []  # SimThreads blocked in join() on us
        self.exc = None
        self.os_thread = None

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<SimThread {self.name} {self.state}>"


# -- the scheduler ------------------------------------------------------------


class _Run:
    def __init__(self, decisions: _Decisions, *, preemption_bound=None,
                 max_steps: int = 50000, clock0: float = 1000.0,
                 watchdog_s: float = 30.0):
        self.decisions = decisions
        self.preemption_bound = preemption_bound
        self.preemptions = 0
        self.max_steps = max_steps
        self.clock = clock0
        self.threads: List[_SimThread] = []
        self.ctrl = _MiniEvent()
        self.current: Optional[_SimThread] = None
        self.teardown = False
        self.failures: list = []  # (SimThread | None, exception)
        self.steps = 0
        self.watchdog_s = watchdog_s

    # -- spawning ----------------------------------------------------------

    def spawn(self, target, name=None, daemon=False, args=(),
              kwargs=None) -> _SimThread:
        st = _SimThread(self, target, args, kwargs or {}, name, daemon)
        self.threads.append(st)
        st.state = "runnable"
        # Raw interpreter thread: threading.Thread would build its
        # internal started-Event through the PATCHED module globals.
        st.os_thread = _thread.start_new_thread(self._bootstrap, (st,))
        return st

    def _bootstrap(self, st: _SimThread) -> None:
        _tls.sim = st
        st.go.take()
        try:
            if not st.killed:
                st.state = "running"
                st.target(*st.args, **st.kwargs)
        except _Killed:
            pass
        except BaseException as e:  # noqa: BLE001 - the model's verdict
            st.exc = e
            self.failures.append((st, e))
        finally:
            st.state = "done"
            for j in st.joiners:
                if j.state == "blocked":
                    j.state = "runnable"
                    j.wake_at = None
            st.finished.set()
            self.ctrl.set()

    # -- called by simulated threads ---------------------------------------

    def yield_point(self, st: _SimThread, label: str) -> None:
        """A scheduling point: the thread stays runnable but hands the
        token back so any other runnable thread may be interleaved."""
        if st.killed:
            raise _Killed()
        if self.teardown:
            return
        st.state = "runnable"
        st.blocked_on = label
        self._back_to_controller(st)

    def block(self, st: _SimThread, label: str,
              wake_at: Optional[float] = None) -> None:
        """Block the thread until something wakes it (sets its state to
        runnable) or the virtual clock reaches ``wake_at``."""
        if st.killed:
            raise _Killed()
        if self.teardown:
            return
        st.state = "blocked"
        st.blocked_on = label
        st.wake_at = wake_at
        st.timed_out = False
        self._back_to_controller(st)

    def _back_to_controller(self, st: _SimThread) -> None:
        self.ctrl.set()
        st.go.take()
        if st.killed:
            raise _Killed()
        st.state = "running"
        st.blocked_on = None
        st.wake_at = None

    # -- the controller loop -----------------------------------------------

    def drive(self, fn: Callable) -> None:
        main = self.spawn(fn, name="main")
        while True:
            if self.failures:
                return  # fail fast: teardown reaps the rest
            runnable = [t for t in self.threads if t.state == "runnable"]
            runnable.sort(key=lambda t: t.tid)
            if not runnable:
                if all(t.state == "done" for t in self.threads):
                    return
                sleepers = [
                    t for t in self.threads
                    if t.state == "blocked" and t.wake_at is not None
                ]
                if not sleepers:
                    if main.state == "done":
                        return  # only perma-blocked daemons remain
                    raise DeadlockError(self._deadlock_report())
                t0 = min(s.wake_at for s in sleepers)
                self.clock = max(self.clock, t0)
                for s in sleepers:
                    if s.wake_at is not None and s.wake_at <= self.clock:
                        s.timed_out = True
                        s.state = "runnable"
                continue
            if main.state == "done":
                return  # the body returned: the run is over
            self.steps += 1
            if self.steps > self.max_steps:
                raise ScheduleOverrun(
                    f"schedule exceeded {self.max_steps} scheduling "
                    f"decisions — unbounded loop in the model?"
                )
            self._step(self._choose(runnable))

    def _choose(self, runnable: list) -> _SimThread:
        cur = self.current if self.current in runnable else None
        if cur is not None:
            cands = [cur] + [t for t in runnable if t is not cur]
            if (
                self.preemption_bound is not None
                and self.preemptions >= self.preemption_bound
            ):
                cands = [cur]
        else:
            cands = runnable
        if len(cands) == 1:
            return cands[0]
        chosen = cands[self.decisions.pick(len(cands))]
        if cur is not None and chosen is not cur:
            self.preemptions += 1
        return chosen

    def _step(self, t: _SimThread) -> None:
        self.current = t
        self.ctrl.drain()
        t.go.set()
        if not self.ctrl.take(timeout=self.watchdog_s):
            raise ExplorerHang(
                f"simulated thread {t.name!r} did not reach a sync point "
                f"within {self.watchdog_s:.0f}s of real time — an "
                f"uninstrumented blocking call (lock/socket created "
                f"outside the explored body)?\n" + self._deadlock_report()
            )

    def _deadlock_report(self) -> str:
        lines = ["thread states:"]
        for t in self.threads:
            held = ", ".join(
                getattr(lk, "_created_at", "?") for lk in t.held
            ) or "-"
            lines.append(
                f"  {t.name}: {t.state}"
                + (f" on [{t.blocked_on}]" if t.blocked_on else "")
                + (f" wake_at={t.wake_at:.3f}" if t.wake_at else "")
                + f" holding: {held}"
            )
        return "\n".join(lines)

    def reap(self) -> None:
        """Kill every simulated thread still alive (daemons, leftovers
        after the body returned or failed) and join the OS threads."""
        self.teardown = True
        for t in self.threads:
            if t.state != "done":
                t.killed = True
                t.go.set()
        deadline = _real_monotonic() + 10.0
        leaked = []
        for t in self.threads:
            if not t.finished.wait(
                timeout=max(0.01, deadline - _real_monotonic())
            ):
                leaked.append(t.name)
        if leaked:
            # A leaked OS thread would poison every later schedule.
            raise ExplorerHang(
                f"simulated threads leaked at teardown: {leaked} — "
                f"blocked in an uninstrumented call?"
            )


# -- patched primitives -------------------------------------------------------


def _describe_creation() -> str:
    # One frame above the constructor: where the model created the lock.
    try:
        f = traceback.extract_stack(limit=3)[0]
        return f"{os.path.basename(f.filename)}:{f.lineno}"
    except Exception:  # pragma: no cover - best-effort label
        return "?"


class ExpLock:
    """Cooperative Lock for simulated threads; real-lock fallback for
    everything else.  The two worlds share no blocking state."""

    _reentrant = False

    def __init__(self):
        self._real = _RealLock()
        self._owner: Optional[_SimThread] = None
        self._count = 0
        self._waiters: list = []
        self._created_at = _describe_creation()

    # -- teardown-mode fast paths (mutual exclusion is moot there) ---------

    def _teardown_acquire(self, st) -> bool:
        if self._owner is st:
            self._count += 1
        else:
            self._owner = st
            self._count = 1
        return True

    def acquire(self, blocking: bool = True, timeout: float = -1):
        st = _cur_sim()
        if st is None:
            if timeout is not None and timeout >= 0:
                return self._real.acquire(blocking, timeout)
            return self._real.acquire(blocking)
        run = st.run
        if st.killed or run.teardown:
            return self._teardown_acquire(st)
        run.yield_point(st, f"acquire {self._created_at}")
        if self._reentrant and self._owner is st:
            self._count += 1
            return True
        deadline = None
        if blocking and timeout is not None and timeout >= 0:
            deadline = run.clock + timeout
        while self._owner is not None:
            if self._reentrant and self._owner is st:
                break
            if not blocking:
                return False
            if deadline is not None and run.clock >= deadline:
                return False
            self._waiters.append(st)
            try:
                run.block(st, f"lock {self._created_at}", wake_at=deadline)
            finally:
                if st in self._waiters:
                    self._waiters.remove(st)
        if self._reentrant and self._owner is st:
            self._count += 1
            return True
        self._owner = st
        self._count = 1
        st.held.append(self)
        return True

    def release(self) -> None:
        st = _cur_sim()
        if st is None:
            return self._real.release()
        run = st.run
        if st.killed or run.teardown:
            if self._owner is st:
                self._count -= 1
                if self._count <= 0:
                    self._owner = None
                    if self in st.held:
                        st.held.remove(self)
                    # A killed thread unwinding its with-blocks must
                    # still hand the lock on, or every healthy waiter
                    # deadlocks on a lock nobody holds (the netsim
                    # crash-injection path kills mid-protocol).
                    self._wake_waiters()
            return
        run.yield_point(st, f"release {self._created_at}")
        if self._owner is not st:
            raise RuntimeError("release of un-acquired lock")
        self._count -= 1
        if self._count == 0:
            self._owner = None
            if self in st.held:
                st.held.remove(self)
            self._wake_waiters()

    def _wake_waiters(self) -> None:
        for w in self._waiters:
            if w.state == "blocked":
                w.state = "runnable"
                w.wake_at = None

    # -- misc protocol ------------------------------------------------------

    def locked(self) -> bool:
        return self._owner is not None or self._real.locked()

    def _is_owned(self) -> bool:
        st = _cur_sim()
        if st is not None:
            return self._owner is st
        return self._real.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<{type(self).__name__} {self._created_at}>"


class ExpRLock(ExpLock):
    _reentrant = True


def _unwrap_lock(lock):
    """Accept a witness proxy (analysis/witness.py) around an ExpLock:
    the Condition needs the cooperative internals."""
    inner = getattr(lock, "_lock", None)
    if inner is not None and hasattr(lock, "witness_name"):
        return inner
    return lock


class ExpCondition:
    def __init__(self, lock=None):
        self._lock = _unwrap_lock(lock) if lock is not None else ExpRLock()
        self._waiters: list = []

    # delegate the lock protocol
    def acquire(self, *a, **kw):
        return self._lock.acquire(*a, **kw)

    def release(self):
        return self._lock.release()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self._lock.release()
        return False

    def wait(self, timeout: Optional[float] = None) -> bool:
        st = _cur_sim()
        if st is None:
            raise RuntimeError(
                "ExpCondition.wait from a non-simulated thread"
            )
        run = st.run
        if st.killed:
            raise _Killed()
        if run.teardown:
            return False
        run.yield_point(st, "cond.wait")
        lock = self._lock
        if lock._owner is not st:
            raise RuntimeError("cannot wait on un-acquired lock")
        saved = lock._count
        lock._count = 0
        lock._owner = None
        if lock in st.held:
            st.held.remove(lock)
        lock._wake_waiters()
        self._waiters.append(st)
        wake_at = run.clock + timeout if timeout is not None else None
        notified = False
        try:
            run.block(st, f"cond-wait {lock._created_at}", wake_at=wake_at)
        finally:
            notified = st not in self._waiters
            if not notified:
                try:
                    self._waiters.remove(st)
                except ValueError:  # pragma: no cover - defensive
                    pass
            self._reacquire(st, run, lock, saved)
        return notified

    @staticmethod
    def _reacquire(st, run, lock, saved_count) -> None:
        if st.killed or run.teardown:
            lock._owner = st
            lock._count = saved_count
            return
        while lock._owner is not None and lock._owner is not st:
            lock._waiters.append(st)
            try:
                run.block(st, f"cond-reacquire {lock._created_at}")
            finally:
                if st in lock._waiters:
                    lock._waiters.remove(st)
        lock._owner = st
        lock._count = saved_count
        st.held.append(lock)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        st = _cur_sim()
        if st is None:
            # Same contract as wait(): cooperative conditions have no
            # real-thread blocking state to fall back on.
            raise RuntimeError(
                "ExpCondition.wait_for from a non-simulated thread"
            )
        run = st.run
        endtime = None
        result = predicate()
        while not result:
            if timeout is not None:
                if endtime is None:
                    endtime = run.clock + timeout
                waittime = endtime - run.clock
                if waittime <= 0:
                    break
                self.wait(waittime)
            else:
                self.wait(None)
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        st = _cur_sim()
        if st is not None and not (st.killed or st.run.teardown):
            st.run.yield_point(st, "notify")
            if self._lock._owner is not st:
                # Mirror threading.Condition's contract: a model that
                # notifies without the lock would crash under REAL
                # threading — passing it here would be a false proof.
                raise RuntimeError("cannot notify on un-acquired lock")
        woken, self._waiters = self._waiters[:n], self._waiters[n:]
        for w in woken:
            if w.state == "blocked":
                w.state = "runnable"
                w.wake_at = None

    def notify_all(self) -> None:
        self.notify(len(self._waiters) or 1)


class ExpEvent:
    def __init__(self):
        self._flag = False
        self._waiters: list = []

    def is_set(self) -> bool:
        return self._flag

    isSet = is_set

    def set(self) -> None:
        st = _cur_sim()
        if st is not None and not (st.killed or st.run.teardown):
            st.run.yield_point(st, "event.set")
        self._flag = True
        for w in self._waiters:
            if w.state == "blocked":
                w.state = "runnable"
                w.wake_at = None
        self._waiters = []

    def clear(self) -> None:
        st = _cur_sim()
        if st is not None and not (st.killed or st.run.teardown):
            st.run.yield_point(st, "event.clear")
        self._flag = False

    def wait(self, timeout: Optional[float] = None) -> bool:
        st = _cur_sim()
        if st is None:
            # Non-simulated caller: poll (no shared real event exists).
            end = _real_monotonic() + (timeout if timeout is not None
                                       else 3600.0)
            while not self._flag and _real_monotonic() < end:
                _real_sleep(0.001)
            return self._flag
        run = st.run
        if st.killed:
            raise _Killed()
        if run.teardown:
            return self._flag
        run.yield_point(st, "event.wait")
        if self._flag:
            return True
        wake_at = run.clock + timeout if timeout is not None else None
        self._waiters.append(st)
        try:
            run.block(st, "event.wait", wake_at=wake_at)
        finally:
            if st in self._waiters:
                self._waiters.remove(st)
        return self._flag


class ExpThread:
    """Patched ``threading.Thread``: simulated when started by a
    simulated thread, real otherwise."""

    def __init__(self, group=None, target=None, name=None, args=(),
                 kwargs=None, *, daemon=None):
        self._target = target
        self._args = args
        self._kwargs = kwargs or {}
        self.name = name or f"ExpThread-{id(self):x}"
        self._daemon = bool(daemon)
        self._sim: Optional[_SimThread] = None
        self._real: Optional[threading.Thread] = None

    @property
    def daemon(self) -> bool:
        return self._daemon

    @daemon.setter
    def daemon(self, v) -> None:
        self._daemon = bool(v)

    def run(self) -> None:
        if self._target is not None:
            self._target(*self._args, **self._kwargs)

    def start(self) -> None:
        st = _cur_sim()
        if st is None or _active is None:
            self._real = _RealThread(
                target=self.run, name=self.name, daemon=self._daemon
            )
            self._real.start()
            return
        run = st.run
        run.yield_point(st, f"spawn {self.name}")
        self._sim = run.spawn(self.run, name=self.name, daemon=self._daemon)

    def join(self, timeout: Optional[float] = None) -> None:
        if self._real is not None:
            return self._real.join(timeout)
        target = self._sim
        if target is None:
            raise RuntimeError("cannot join thread before it is started")
        st = _cur_sim()
        if st is None:
            target.finished.wait(timeout)
            return
        run = st.run
        if st.killed or run.teardown:
            return
        run.yield_point(st, f"join {target.name}")
        if target.state == "done":
            return
        wake_at = run.clock + timeout if timeout is not None else None
        target.joiners.append(st)
        try:
            run.block(st, f"join {target.name}", wake_at=wake_at)
        finally:
            if st in target.joiners:
                target.joiners.remove(st)

    def is_alive(self) -> bool:
        if self._real is not None:
            return self._real.is_alive()
        return self._sim is not None and self._sim.state != "done"


def _exp_sleep(secs) -> None:
    st = _cur_sim()
    if st is None:
        return _real_sleep(secs)
    if st.killed:
        raise _Killed()
    run = st.run
    if run.teardown:
        return
    run.yield_point(st, "sleep")
    if secs is not None and secs > 0:
        run.block(st, f"sleep({secs})", wake_at=run.clock + secs)


def _exp_monotonic() -> float:
    st = _cur_sim()
    if st is not None:
        return st.run.clock
    return _real_monotonic()


# -- patch management ---------------------------------------------------------

_PATCH_TARGETS = (
    (threading, "Lock", lambda: ExpLock),
    (threading, "RLock", lambda: ExpRLock),
    (threading, "Condition", lambda: ExpCondition),
    (threading, "Event", lambda: ExpEvent),
    (threading, "Thread", lambda: ExpThread),
    (_time_module, "sleep", lambda: _exp_sleep),
    (_time_module, "monotonic", lambda: _exp_monotonic),
)


def _install(run: "_Run") -> list:
    global _active
    with _active_guard:
        if _active is not None:
            raise RuntimeError("a schedule explorer run is already active")
        _active = run
    saved = []
    for mod, attr, repl in _PATCH_TARGETS:
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, repl())
    # queue.py binds ``from time import monotonic as time`` at import:
    # timed q.get(timeout=...) would mix real endtimes with virtual
    # Condition waits and livelock — point its clock at ours.
    if hasattr(_queue_module, "time"):
        saved.append((_queue_module, "time", _queue_module.time))
        _queue_module.time = _exp_monotonic
    return saved


def _uninstall(saved: list) -> None:
    global _active
    for mod, attr, old in reversed(saved):
        setattr(mod, attr, old)
    with _active_guard:
        _active = None


# -- public surface -----------------------------------------------------------


def checkpoint(label: str = "checkpoint") -> None:
    """Explicit scheduling point for model code: between two plain
    (lock-free) statements whose interleaving matters, a checkpoint
    lets the explorer preempt there.  No-op outside an explorer run,
    so models can share code with production paths."""
    st = _cur_sim()
    if st is not None and not st.killed and not st.run.teardown:
        st.run.yield_point(st, label)


def vclock() -> float:
    """The active run's virtual clock (tests/diagnostics)."""
    st = _cur_sim()
    if st is not None:
        return st.run.clock
    return _active.clock if _active is not None else _real_monotonic()


def decide(nalts: int, label: str = "choice") -> int:
    """A MODEL-level decision point: pick one of ``nalts`` branches
    from the schedule's decision source, so fault injection (drop this
    message?  crash here?  torn or clean kill?) is explored/replayed by
    the SAME DFS + replay-token machinery as thread interleavings — one
    ``RTPU_SCHEDULE_REPLAY`` token pins both.  Returns 0 outside an
    explorer run (models default to the fault-free branch), so model
    code can be exercised without the scheduler."""
    if nalts <= 1:
        return 0
    st = _cur_sim()
    if st is None:
        return 0
    return st.run.decisions.pick(nalts)


def kill(thread) -> bool:
    """Kill a simulated thread from model code — the netsim crash
    primitive (a node dying mid-protocol).  Accepts the patched
    ``threading.Thread`` wrapper or a raw ``_SimThread``.  The victim
    dies at its NEXT sync point (``_Killed`` unwinds its frames, so
    ``with`` blocks release their locks and wake waiters); a blocked
    victim is woken to die.  Returns False when the thread was not a
    live simulated thread."""
    sim = thread if isinstance(thread, _SimThread) else getattr(
        thread, "_sim", None
    )
    if sim is None or sim.state == "done":
        return False
    sim.killed = True
    if sim.state == "blocked":
        sim.state = "runnable"
        sim.wake_at = None
    return True


def _run_schedule(fn, decisions: _Decisions, *, preemption_bound,
                  max_steps) -> Optional[tuple]:
    """One schedule; returns the first failure (thread, exc) or None."""
    run = _Run(decisions, preemption_bound=preemption_bound,
               max_steps=max_steps)
    saved = _install(run)
    try:
        try:
            run.drive(fn)
        except (DeadlockError, ScheduleOverrun) as e:
            run.failures.insert(0, (None, e))
        finally:
            run.reap()  # ExplorerHang here propagates: process poisoned
    finally:
        _uninstall(saved)
    return run.failures[0] if run.failures else None


def _raise_failure(fail: tuple, decisions: _Decisions, index: int):
    st, exc = fail
    token = decisions.token
    who = f"thread {st.name!r}" if st is not None else "scheduler"
    raise ScheduleFailure(
        f"schedule #{index} failed in {who}: {exc!r}\n"
        f"deterministic replay: {REPLAY_ENV}={token} <pytest this test>",
        token,
    ) from exc


def explore(fn: Callable, *, max_schedules: int = 1000,
            random_schedules: int = 256, seed: int = 0,
            preemption_bound: Optional[int] = 2,
            max_steps: int = 50000,
            replay: Optional[str] = None) -> ExploreResult:
    """Systematically explore ``fn``'s thread interleavings.

    Bounded-exhaustive DFS up to ``max_schedules``; if the tree is
    larger, ``random_schedules`` additional seeded-random schedules run
    on top (``seed`` keys them).  ``preemption_bound`` caps forced
    switches away from a runnable thread per schedule (None =
    unbounded).  The first failing schedule raises
    :class:`ScheduleFailure` carrying a replay token; set
    ``RTPU_SCHEDULE_REPLAY`` (or pass ``replay=``) to run exactly that
    schedule."""
    replay = replay if replay is not None else (
        os.environ.get(REPLAY_ENV) or None
    )
    if replay:
        dec = _Decisions(_parse_token(replay))
        fail = _run_schedule(fn, dec, preemption_bound=preemption_bound,
                             max_steps=max_steps)
        if fail is not None:
            _raise_failure(fail, dec, 1)
        return ExploreResult(1, complete=False, replayed=True)

    prefix: list = []
    n = 0
    complete = False
    while n < max_schedules:
        dec = _Decisions(prefix)
        fail = _run_schedule(fn, dec, preemption_bound=preemption_bound,
                             max_steps=max_steps)
        n += 1
        if fail is not None:
            _raise_failure(fail, dec, n)
        nxt = _next_prefix(dec.record)
        if nxt is None:
            complete = True
            break
        prefix = nxt
    if not complete:
        for k in range(random_schedules):
            # int-mix the (seed, index) pair: tuple seeding is
            # deprecated since 3.9.
            dec = _Decisions((), rng=random.Random(seed * 1_000_003 + k))
            fail = _run_schedule(fn, dec, preemption_bound=preemption_bound,
                                 max_steps=max_steps)
            n += 1
            if fail is not None:
                _raise_failure(fail, dec, n)
    return ExploreResult(n, complete=complete)


def schedule_test(**opts):
    """Decorator: run a pytest test body under :func:`explore` and tag
    it with the ``explorer`` marker.  A failing schedule prints its
    replay token; re-run the test with ``RTPU_SCHEDULE_REPLAY=<token>``
    to replay exactly that interleaving."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            explore(lambda: fn(*a, **kw), **opts)  # raises on failure

        try:  # marker only when pytest is importable (harness use)
            import pytest

            wrapper.pytestmark = (
                list(getattr(fn, "pytestmark", [])) + [pytest.mark.explorer]
            )
        except Exception:  # pragma: no cover - non-pytest contexts
            pass
        return wrapper

    return deco


__all__ = [
    "DeadlockError",
    "ExploreResult",
    "ExplorerHang",
    "REPLAY_ENV",
    "ScheduleFailure",
    "ScheduleOverrun",
    "checkpoint",
    "decide",
    "explore",
    "kill",
    "schedule_test",
    "vclock",
]
