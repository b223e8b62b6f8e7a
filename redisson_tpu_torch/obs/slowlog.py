"""SLOWLOG-compatible slow-op ring buffer.

Semantics follow redis-server's slowlog.c: commands whose execution time
meets ``threshold_us`` are appended to a bounded ring (oldest evicted),
each entry carrying a monotonically increasing id, unix timestamp,
duration in microseconds, the (truncated) argument vector, and the
client's address/name.  ``threshold_us < 0`` disables logging;
``threshold_us == 0`` logs every command — both Redis behaviors.

Argument truncation mirrors Redis: at most 32 args (the last slot
replaced by a "... (N more arguments)" marker) and at most 128 bytes
per arg (suffixed with "... (N more bytes)").
"""

from __future__ import annotations

import threading
import time
from collections import deque

MAX_ARGS = 32
MAX_ARG_BYTES = 128


class SlowLogEntry:
    __slots__ = ("id", "unix_ts", "duration_us", "args", "client_addr",
                 "client_name", "trace_id")

    def __init__(self, id, unix_ts, duration_us, args, client_addr,
                 client_name, trace_id=""):
        self.id = id
        self.unix_ts = unix_ts
        self.duration_us = duration_us
        self.args = args
        self.client_addr = client_addr
        self.client_name = client_name
        # Slow-trace auto-capture: when the command was
        # sampled by the distributed tracer, its trace id rides the
        # slowlog entry so TRACE GET <id> answers "where did this slow
        # command's time go" directly from the SLOWLOG view.
        self.trace_id = trace_id


def _truncate_args(args) -> list[bytes]:
    out = []
    shown = args[: MAX_ARGS - 1] if len(args) > MAX_ARGS else args
    for a in shown:
        if not isinstance(a, bytes):
            a = str(a).encode()
        if len(a) > MAX_ARG_BYTES:
            a = a[:MAX_ARG_BYTES] + (
                b"... (%d more bytes)" % (len(a) - MAX_ARG_BYTES)
            )
        out.append(a)
    if len(args) > MAX_ARGS:
        out.append(b"... (%d more arguments)" % (len(args) - MAX_ARGS + 1))
    return out


class SlowLog:
    def __init__(self, max_len: int = 128, threshold_us: int = 10_000):
        self._lock = threading.Lock()
        self._ring: deque[SlowLogEntry] = deque(maxlen=max(1, max_len))
        self._next_id = 0
        self.threshold_us = threshold_us
        self.max_len = max(1, max_len)

    def maybe_add(self, duration_s: float, args, client_addr: str = "",
                  client_name: str = "", trace_id: str = "") -> bool:
        dur_us = int(duration_s * 1e6)
        if self.threshold_us < 0 or dur_us < self.threshold_us:
            return False
        entry_args = _truncate_args(args)
        with self._lock:
            e = SlowLogEntry(
                self._next_id, int(time.time()), dur_us, entry_args,
                client_addr, client_name or "", trace_id or "",
            )
            self._next_id += 1
            self._ring.append(e)
        return True

    def entries(self, count: int = -1) -> list[SlowLogEntry]:
        """Newest first, like SLOWLOG GET; count<0 = all."""
        with self._lock:
            out = list(self._ring)
        out.reverse()
        return out if count < 0 else out[:count]

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # CONFIG SET hooks ------------------------------------------------------

    def set_threshold_us(self, us: int) -> None:
        self.threshold_us = int(us)

    def set_max_len(self, n: int) -> None:
        n = max(1, int(n))
        with self._lock:
            self.max_len = n
            self._ring = deque(self._ring, maxlen=n)
