"""Executor-boundary failure types (counterpart of
``redisson_tpu/executor/failures.py``, the types this slice raises).

The reference's RedisExecutor surfaces typed exceptions
(→ org/redisson/command/RedisExecutor.java).  Here failures split by
where they surface:

- **Completion-time** (a dispatch or its result fetch raised): every op
  of the affected launch fails with a ``KernelExecutionError`` that
  locates the op range within the launch.
- **Result-wait timeouts**: blocking on a future past its deadline raises
  ``DispatchTimeoutError``.
"""

from __future__ import annotations


class RedissonTpuError(Exception):
    """Base class for executor-boundary failures (the JAX package's name,
    so callers catch one type in both packages)."""


class DispatchTimeoutError(RedissonTpuError, TimeoutError):
    """A blocking result wait exceeded its deadline."""


class KernelExecutionError(RedissonTpuError):
    """A device batch failed; carries the failed op range.

    ``op_start``/``op_count`` locate THIS future's ops within the failed
    launch; ``segment_ops`` is the launch's total."""

    def __init__(self, segment_key, op_start: int, op_count: int,
                 segment_ops: int, cause: BaseException):
        super().__init__(
            f"device batch {segment_key!r} failed: ops "
            f"[{op_start}, {op_start + op_count}) of {segment_ops} — {cause!r}"
        )
        self.segment_key = segment_key
        self.op_start = op_start
        self.op_count = op_count
        self.segment_ops = segment_ops
        self.__cause__ = cause
