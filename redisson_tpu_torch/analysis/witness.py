"""Runtime lock-order witness.

The static rules (rtpulint RT001) catch LEXICAL blocking-under-lock;
they cannot see lock-ORDER hazards that only exist across call chains
and threads.  This module is the witness(4)-style runtime complement:

- A module names a lock by creating it through :func:`named` (the JAX
  package's lock names, at the counterpart sites), which returns the
  lock untouched when the witness is off (``RTPU_LOCK_WITNESS`` unset —
  zero overhead, the production default) and a recording proxy when it
  is on.
- Each proxy records, per thread, the stack of witness locks currently
  held.  Acquiring lock B while holding lock A adds the edge A->B to a
  global acquisition graph (nodes are lock NAMES, not instances — the
  witness(4) "lock class" model, so two connections' send locks share
  one node).  A new edge that closes a cycle is a POTENTIAL DEADLOCK:
  two threads that interleave the recorded orders can block forever,
  even if this run did not.  The violation carries both acquisition
  stacks.
- Installing the witness also hooks ``time.sleep`` and
  ``concurrent.futures.Future.result``: either called while a witness
  lock is held is a lock-held-across-blocking-call violation (the
  RT001 defect class, caught dynamically through any call depth).

Test wiring: a test file that runs under this witness drains
:func:`take_violations` after every test in an autouse fixture of its
own and fails the test with the offending stack pairs — run any such
suite under ``RTPU_LOCK_WITNESS=1``.  With ``RTPU_LOCK_WITNESS_EXPORT``
(or ``RTPU_TORCH_LOCK_WITNESS_EXPORT``, which wins: the JAX package's
witness reads the first name too, so a process that runs both writes
each graph to a file of its own) set to a path, the observed graph is
written there at exit for ``python -m redisson_tpu_torch.analysis
--runtime-edges``.

The witness deliberately does NOT wrap the executor dispatch lock:
that lock's entire purpose is serializing device work, so blocking
under it is its job, and wrapping it would bury real findings in
by-design reports.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Optional

_ENV = "RTPU_LOCK_WITNESS"

_forced = False
_state: Optional["_State"] = None
_state_guard = threading.Lock()

_orig_sleep = None
_orig_future_result = None


class WitnessViolation:
    """One finding: ``kind`` is ``"cycle"`` or ``"blocking"``."""

    __slots__ = ("kind", "message", "stacks")

    def __init__(self, kind: str, message: str, stacks: list):
        self.kind = kind
        self.message = message
        self.stacks = stacks  # list[(title, formatted_stack)]

    def format(self) -> str:
        parts = [f"[{self.kind}] {self.message}"]
        for title, stack in self.stacks:
            parts.append(f"--- {title} ---\n{stack}")
        return "\n".join(parts)

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"WitnessViolation({self.kind!r}, {self.message!r})"


class _State:
    def __init__(self):
        self.guard = threading.Lock()  # leaf lock: graph + violations
        self.graph: dict[str, set] = {}  # name -> {names acquired under it}
        self.edge_site: dict[tuple, str] = {}  # (a, b) -> stack of first obs
        self.violations: list[WitnessViolation] = []
        self.seen_cycles: set = set()
        self.seen_blocking: set = set()
        self.acquired: set = set()  # every name acquired at least once
        self.tls = threading.local()

    def held(self) -> list:
        h = getattr(self.tls, "held", None)
        if h is None:
            h = self.tls.held = []
        return h


def enabled() -> bool:
    """The opt-in switch: RTPU_LOCK_WITNESS=1 (or force(True) in
    tests)."""
    return _forced or os.environ.get(_ENV, "") not in ("", "0", "no", "off")


def active() -> bool:
    """True once at least one lock has been wrapped this process."""
    return _state is not None


def force(on: bool) -> None:
    """Test hook: arm/disarm the witness without the env var."""
    global _forced
    _forced = on


# The port's own name first: a test process arms the JAX package's
# witness too, and that one writes its graph to RTPU_LOCK_WITNESS_EXPORT.
_EXPORT_ENVS = ("RTPU_TORCH_LOCK_WITNESS_EXPORT", "RTPU_LOCK_WITNESS_EXPORT")


def _ensure_state() -> "_State":
    global _state
    with _state_guard:
        if _state is None:
            _state = _State()
            _install_probes()
            # Static/dynamic merge: with the env var set, the
            # observed acquisition graph is dumped at process exit so
            # the static lock-graph gate (analysis/lockgraph.py) can
            # fold runtime-only edges into its cycle check.
            path = next((os.environ[e] for e in _EXPORT_ENVS
                         if os.environ.get(e)), None)
            if path:
                import atexit

                atexit.register(export_to, path)
    return _state


def _stack(skip: int = 3) -> str:
    return "".join(traceback.format_stack()[:-skip][-8:])


def named(lock, name: str):
    """Wrap ``lock`` for witness recording under ``name``.  Identity
    function while the witness is off — the production path costs one
    call at lock CREATION and nothing per acquisition."""
    if not enabled():
        return lock
    _ensure_state()
    return _WitnessLock(lock, name)


class _WitnessLock:
    """Recording proxy.  Works as a context manager, under
    ``threading.Condition`` (which binds acquire/release and falls
    back to them for wait), and over RLocks (reentrant acquires are
    recorded and add no edge; self-edges are skipped)."""

    __slots__ = ("_lock", "_name")

    def __init__(self, lock, name: str):
        self._lock = lock
        self._name = name

    # -- lock protocol -----------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1):
        # Neither a try-lock nor the re-entry of an RLock this thread
        # already holds can wait, so neither adds an order edge (lockdep's
        # rule): the re-entry's order was taken at its first acquisition.
        ordered = blocking and not _owned(self._lock)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            _note_acquire(self._name, ordered)
        return ok

    def release(self) -> None:
        self._lock.release()
        _note_release(self._name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def locked(self) -> bool:
        return self._lock.locked()

    def _is_owned(self) -> bool:
        # threading.Condition probes this; delegate when the inner lock
        # (RLock) knows, else mirror Condition's own fallback.
        f = getattr(self._lock, "_is_owned", None)
        if f is not None:
            return f()
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True

    @property
    def witness_name(self) -> str:
        return self._name

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<WitnessLock {self._name!r} {self._lock!r}>"


def _owned(lock) -> bool:
    """True when ``lock`` is an RLock the calling thread holds."""
    f = getattr(lock, "_is_owned", None)
    return f is not None and f()


def _note_acquire(name: str, ordered: bool = True) -> None:
    st = _state
    if st is None:
        return
    held = st.held()
    prior = [p for p in held if p != name] if ordered else []
    held.append(name)
    if name not in st.acquired:
        with st.guard:  # readers copy the set under the guard
            st.acquired.add(name)
    if not prior:
        return
    site = None
    with st.guard:
        for p in set(prior):
            succ = st.graph.setdefault(p, set())
            if name in succ:
                continue
            succ.add(name)
            if site is None:
                site = _stack()
            st.edge_site[(p, name)] = site
            path = _find_path(st.graph, name, p)
            if path is not None:
                _record_cycle(st, p, name, path)


def _note_release(name: str) -> None:
    st = _state
    if st is None:
        return
    held = st.held()
    # Pop the most recent acquisition of this name (RLock reentrancy).
    for i in range(len(held) - 1, -1, -1):
        if held[i] == name:
            del held[i]
            return


def _find_path(graph: dict, src: str, dst: str) -> Optional[list]:
    """DFS path src ->* dst in the acquisition graph, or None."""
    stack = [(src, [src])]
    seen = set()
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        if node in seen:
            continue
        seen.add(node)
        for nxt in graph.get(node, ()):
            stack.append((nxt, path + [nxt]))
    return None


def _record_cycle(st: "_State", p: str, name: str, path: list) -> None:
    cycle = frozenset(path) | {p}
    if cycle in st.seen_cycles:
        return
    st.seen_cycles.add(cycle)
    chain = " -> ".join(path + [name])
    stacks = [(
        f"edge {p} -> {name} (this acquisition)",
        st.edge_site.get((p, name), ""),
    )]
    for a, b in zip(path, path[1:]):
        stacks.append((
            f"edge {a} -> {b} (recorded earlier)",
            st.edge_site.get((a, b), ""),
        ))
    st.violations.append(WitnessViolation(
        "cycle",
        f"lock-order cycle (potential deadlock): acquiring {name!r} "
        f"while holding {p!r}, but the order {chain} was also "
        f"observed — two threads interleaving these orders deadlock",
        stacks,
    ))


# -- blocking-call probes -----------------------------------------------------


def _install_probes() -> None:
    global _orig_sleep, _orig_future_result
    if _orig_sleep is not None:
        return
    import time as _time
    import concurrent.futures as _cf

    _orig_sleep = _time.sleep

    def _witness_sleep(secs):
        _note_blocking("time.sleep")
        return _orig_sleep(secs)

    _time.sleep = _witness_sleep

    _orig_future_result = _cf.Future.result

    def _witness_result(self, timeout=None):
        _note_blocking("Future.result")
        return _orig_future_result(self, timeout)

    _cf.Future.result = _witness_result


class allow_blocking:
    """Runtime analog of an inline ``# rtpulint: disable=RT001``
    suppression: marks a region where blocking under a witness lock is
    the documented design (e.g. change_topology's drain under the
    registry lock) — the reason is mandatory, like the static form."""

    __slots__ = ("_reason", "_prev")

    def __init__(self, reason: str):
        if not reason:
            raise ValueError("allow_blocking needs a reason")
        self._reason = reason
        self._prev = None

    def __enter__(self):
        st = _state
        if st is not None:
            self._prev = getattr(st.tls, "allow", None)
            st.tls.allow = self._reason
        return self

    def __exit__(self, *exc) -> bool:
        st = _state
        if st is not None:
            st.tls.allow = self._prev
        return False


def _note_blocking(what: str) -> None:
    st = _state
    if st is None:
        return
    if getattr(st.tls, "allow", None) is not None:
        return
    held = st.held()
    if not held:
        return
    with st.guard:
        key = (what, tuple(sorted(set(held))))
        if key in st.seen_blocking:
            return
        st.seen_blocking.add(key)
        st.violations.append(WitnessViolation(
            "blocking",
            f"{what} called while holding witness lock(s) "
            f"{sorted(set(held))} — blocking work must leave the "
            f"critical section (rtpulint RT001, caught at runtime)",
            [("call site", _stack())],
        ))


# -- reporting ----------------------------------------------------------------


def export_edges() -> list:
    """The observed name-level acquisition graph as sorted (a, b)
    pairs — the runtime half of the static/dynamic lock-graph merge
    (analysis/lockgraph.py merge_runtime_edges)."""
    st = _state
    if st is None:
        return []
    with st.guard:
        return sorted(
            (a, b) for a, succ in st.graph.items() for b in succ
        )


def acquired_names() -> frozenset:
    """Every witness-named lock acquired at least once since the last
    :func:`reset` — proof that a run went through the named locks at all
    (a lock acquired alone adds no edge to the graph)."""
    st = _state
    if st is None:
        return frozenset()
    with st.guard:
        return frozenset(st.acquired)


def export_to(path: str) -> None:
    """Dump the acquisition graph as the JSON shape
    ``lockgraph.load_runtime_edges`` reads."""
    import json

    edges = export_edges()
    try:
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"edges": [list(e) for e in edges]}, f, indent=0)
    except OSError:  # pragma: no cover — export is best-effort
        pass


def violations() -> list:
    st = _state
    if st is None:
        return []
    with st.guard:
        return list(st.violations)


def take_violations() -> list:
    """Drain (per-test check: each test reports only its own
    findings; the order GRAPH persists so cross-test interleavings
    still close cycles)."""
    st = _state
    if st is None:
        return []
    with st.guard:
        out = list(st.violations)
        st.violations.clear()
        return out


def assert_clean() -> None:
    vs = take_violations()
    if vs:
        raise AssertionError(
            "lock-order witness found %d violation(s):\n%s"
            % (len(vs), "\n\n".join(v.format() for v in vs))
        )


def reset() -> None:
    """Clear the graph, violations, and dedup sets (test isolation)."""
    st = _state
    if st is None:
        return
    with st.guard:
        st.graph.clear()
        st.edge_site.clear()
        st.violations.clear()
        st.seen_cycles.clear()
        st.seen_blocking.clear()
        st.acquired.clear()


__all__ = [
    "WitnessViolation",
    "acquired_names",
    "active",
    "allow_blocking",
    "assert_clean",
    "enabled",
    "export_edges",
    "export_to",
    "force",
    "named",
    "reset",
    "take_violations",
    "violations",
]
