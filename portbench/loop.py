"""Client threads and the record of every call they made.

How a client paces its calls is a loop, found by the name a mix gives in
its ``loop`` key: ``portbench/loops/<loop>.py``.  A loop module gives
``KEYS``, the mix keys it reads besides the generator's own, and
``client(plan, book, mix, first, stop_at, max_calls)``,
which runs on one thread per client and issues and answers its calls
through ``book``.  So a new way of pacing calls is a new file.

Every call is recorded (its number, op, target, elements sent, issue and
completion times on ``time.perf_counter``, and whether it failed); only
calls the plan marked for checking keep their answers.
"""

from __future__ import annotations

import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Record:
    client: int
    number: int
    op: str
    target: int
    n: int
    t_issue: float
    t_done: float = 0.0
    ok: bool = True
    phase: str = "window"
    answer: Optional[np.ndarray] = None


@dataclass
class Activity:
    """What each client thread was doing: ``(t0, t1, what)`` intervals on
    ``time.perf_counter``, kept only while a trace is taken."""

    spans: list = field(default_factory=list)
    lock: threading.Lock = field(default_factory=threading.Lock)

    def add(self, t0: float, t1: float, what: str) -> None:
        with self.lock:
            self.spans.append((t0, t1, what))


class Book:
    """Issues calls and records them: what every loop shares."""

    def __init__(self, issue, phase: str, activity: Optional[Activity]):
        self._issue, self.phase, self.activity = issue, phase, activity
        self.records: list = []
        self.errors: list = []

    def issue(self, call, t_issue: Optional[float] = None):
        """Issue ``call``; returns ``(record, future, check)``, or ``None``
        where the issue itself raised (the call is recorded as failed).
        ``t_issue`` is when the call was due, where a loop schedules its
        calls: its latency counts from then."""
        t0 = time.perf_counter()
        rec = Record(call.client, call.number, call.op, call.target, len(call.elements),
                     t0 if t_issue is None else t_issue, phase=self.phase)
        try:
            fut = self._issue(call)
        except Exception:
            rec.t_done = time.perf_counter()
            rec.ok = False
            self.errors.append(traceback.format_exc(limit=3))
            self.records.append(rec)
            return None
        if self.activity is not None:
            self.activity.add(t0, time.perf_counter(), "issue " + call.op)
        return rec, fut, call.check

    def finish(self, rec: Record, fut, check: bool) -> None:
        """Wait for a call's answer and record when it reached host memory."""
        t0 = time.perf_counter()
        try:
            ans = fut.result()
            rec.t_done = time.perf_counter()
            if check:
                rec.answer = np.asarray(ans, dtype=bool)
        except Exception:  # a call that raises: its elements failed
            rec.t_done = time.perf_counter()
            rec.ok = False
            self.errors.append(traceback.format_exc(limit=3))
        if self.activity is not None:
            self.activity.add(t0, rec.t_done, "wait")
        self.records.append(rec)


def ring(plan, depth: int) -> list:
    """Element buffers for ``depth`` calls, reused once their call has
    been answered: a loop that reuses them pays no allocation for a call
    of millions of elements."""
    return [plan.buffers() for _ in range(depth)]


def run_clients(loop, mix: dict, plans, issue, first: int, stop_at: float,
                max_calls: int, phase: str, activity: Optional[Activity] = None,
                during=None, join_timeout: float = 600.0):
    """Run ``loop.client`` on one thread per plan until ``stop_at`` or
    ``max_calls`` calls each; ``during()`` runs on the calling thread
    meanwhile.  Returns ``(records, error texts)`` once every call has
    ended."""
    book = Book(issue, phase, activity)
    threads = [
        threading.Thread(
            target=loop.client,
            args=(p, book, mix, first, stop_at, max_calls),
            name=f"portbench-client-{i}", daemon=True,
        )
        for i, p in enumerate(plans)
    ]
    for t in threads:
        t.start()
    if during is not None:
        during()
    deadline = time.perf_counter() + join_timeout
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.perf_counter()))
    if any(t.is_alive() for t in threads):
        raise RuntimeError("client threads did not finish: calls never came back")
    return book.records, book.errors
