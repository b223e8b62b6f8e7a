"""The open loop: calls arrive on a schedule, whether or not the earlier
ones have been answered.

``rate_per_s`` calls a second arrive over all clients, each client taking
its share.  ``arrivals`` spaces them: ``poisson`` (exponential gaps, the
default) or ``uniform`` (even gaps).  ``bursts``, where given, multiplies
the rate by ``factor`` for the first ``length_s`` seconds of every
``every_s``.  A client holds at most ``inflight`` calls outstanding: at
that cap it waits for its oldest before it issues the next, and the next
is late.  A call's latency runs from the time it was due, so lateness
counts.  The schedule is a pure function of ``(seed, client)``: the same
seed gives the same arrivals.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np

from portbench.loop import ring

KEYS = frozenset({"rate_per_s", "arrivals", "bursts"})
_CHUNK = 4096


def check(mix: dict) -> None:
    if float(mix["rate_per_s"]) <= 0:
        raise ValueError("rate_per_s must be positive")
    if mix.get("arrivals", "poisson") not in ("poisson", "uniform"):
        raise ValueError("arrivals must be poisson or uniform")
    b = mix.get("bursts")
    if b is not None and not (0 < float(b["length_s"]) <= float(b["every_s"])
                              and float(b["factor"]) > 0):
        raise ValueError("bursts needs 0 < length_s <= every_s and factor > 0")


def arrivals(mix: dict, seed: int, client: int, first: int):
    """Seconds from the loop's start at which the client's calls are due,
    in order, without end."""
    rate = float(mix["rate_per_s"]) / int(mix["clients"])
    poisson = mix.get("arrivals", "poisson") == "poisson"
    b = mix.get("bursts")
    every, length, factor = ((float(b["every_s"]), float(b["length_s"]), float(b["factor"]))
                             if b else (1.0, 0.0, 1.0))
    fast = rate * factor * length  # calls due in a period's burst
    period = fast + rate * (every - length)  # calls due in a whole period
    rng = np.random.default_rng([seed, client, 1 << 41, first])
    s = 0.0
    while True:
        gaps = rng.exponential(1.0, _CHUNK) if poisson else np.ones(_CHUNK)
        for g in gaps:
            # s counts the calls due so far; map it back onto the clock.
            s += g
            q, rem = divmod(s, period)
            t = rem / (rate * factor) if rem < fast else length + (rem - fast) / rate
            yield q * every + t


def client(plan, book, mix: dict, first: int, stop_at: float, max_calls: int) -> None:
    inflight = int(mix["inflight"])
    slots = threading.Semaphore(inflight)
    held: queue.Queue = queue.Queue()

    def wait():
        while True:
            item = held.get()
            if item is None:
                return
            book.finish(*item)
            slots.release()

    waiter = threading.Thread(target=wait, name=f"portbench-wait-{plan.client}", daemon=True)
    waiter.start()
    bufs = ring(plan, inflight + 2)
    due = arrivals(mix, plan.seed, plan.client, first)
    t0 = time.perf_counter()
    try:
        j = first
        nxt = plan.call(j, out=bufs[j % len(bufs)]) if max_calls > 0 else None
        for _ in range(max_calls):
            at = t0 + next(due)
            if at >= stop_at:
                break
            left = at - time.perf_counter()
            if left > 0:
                time.sleep(left)
            slots.acquire()
            item = book.issue(nxt, t_issue=at)
            if item is None:
                slots.release()
            else:
                held.put(item)
            j += 1
            nxt = plan.call(j, out=bufs[j % len(bufs)]) if j - first < max_calls else None
    finally:
        held.put(None)
        waiter.join()


