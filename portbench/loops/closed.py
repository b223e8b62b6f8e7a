"""The closed loop: each client keeps ``inflight`` calls outstanding.

A client issues calls until it holds ``inflight`` of them, then waits for
the oldest and issues the next, made while the others were in flight, so
the generator's own time stays out of the loop's cycle.  Past the stop
time it issues nothing more and waits for what it holds.  A call's
latency runs from its issue to its answer in host memory.
"""

from __future__ import annotations

import time
from collections import deque

from portbench.loop import ring

KEYS = frozenset()


def client(plan, book, mix: dict, first: int, stop_at: float, max_calls: int) -> None:
    inflight = int(mix["inflight"])
    pending: deque = deque()
    # A call in flight, the one made ahead and one spare.
    bufs = ring(plan, inflight + 2)
    j, issued = first, 0
    try:
        nxt = plan.call(j, out=bufs[j % len(bufs)]) if max_calls > 0 else None
        while True:
            while len(pending) < inflight and issued < max_calls and time.perf_counter() < stop_at:
                held = book.issue(nxt)
                if held is not None:
                    pending.append(held)
                j += 1
                issued += 1
                nxt = plan.call(j, out=bufs[j % len(bufs)]) if issued < max_calls else None
            if not pending:
                break
            book.finish(*pending.popleft())
    finally:
        while pending:
            book.finish(*pending.popleft())
