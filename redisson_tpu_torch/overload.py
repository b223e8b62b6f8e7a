"""Ambient op-deadline propagation (counterpart of
``redisson_tpu/overload.py``).

One absolute deadline, attached where an op enters the system, rides the
whole dispatch path: the engine reads it at submit (the coalescer's
admission control and queue shedding; the executor's check at the
dispatch lock on the direct path) and the returned future honors the
residual budget at ``.result()``.  Direct-API callers attach it with
:func:`deadline_scope`, surfaced as ``client.op_deadline(ms)``.

The deadline is a thread-local STACK of absolute ``time.monotonic()``
instants: scopes nest (the innermost wins), and pushing ``None``
explicitly disables any outer deadline.  No scope means no deadline —
the blocking, wait-forever behavior stays the default.

Deadlines are shedding hints, not transactions: an op shed at any stage
was never dispatched (no acked write is shed), while an op that only
missed its fetch wait may still complete on the device — it was just
not acked (see ``DeadlineExceededError.stage``).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from redisson_tpu_torch.executor.failures import DeadlineExceededError  # noqa: F401
# (re-exported: deadline consumers want the scope and the error together)

_ctl = threading.local()


def current_deadline() -> Optional[float]:
    """The innermost ambient deadline (absolute ``time.monotonic()``
    seconds), or None when this thread has none in scope."""
    stack = getattr(_ctl, "stack", None)
    return stack[-1] if stack else None


def remaining(deadline: Optional[float],
              now: Optional[float] = None) -> Optional[float]:
    """Residual budget in seconds (may be negative); None for no
    deadline."""
    if deadline is None:
        return None
    return deadline - (time.monotonic() if now is None else now)


class deadline_scope:
    """Context manager attaching a deadline ``seconds`` from entry (or the
    absolute monotonic instant ``at``) to every engine op submitted inside
    the block on this thread.  ``seconds=None`` pushes an explicit
    no-deadline frame that shadows any outer scope."""

    __slots__ = ("_seconds", "_abs")

    def __init__(self, seconds: Optional[float] = None, *,
                 at: Optional[float] = None):
        if seconds is not None and at is not None:
            raise ValueError("pass seconds or at=, not both")
        self._seconds = seconds
        self._abs = at

    def __enter__(self) -> "deadline_scope":
        stack = getattr(_ctl, "stack", None)
        if stack is None:
            stack = _ctl.stack = []
        if self._abs is not None:
            stack.append(self._abs)
        elif self._seconds is not None:
            stack.append(time.monotonic() + self._seconds)
        else:
            stack.append(None)
        return self

    def __exit__(self, *exc) -> bool:
        _ctl.stack.pop()
        return False


__all__ = [
    "DeadlineExceededError",
    "current_deadline",
    "deadline_scope",
    "remaining",
]
