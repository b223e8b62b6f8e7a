"""Executor-boundary failure types (counterpart of
``redisson_tpu/executor/failures.py``, with the JAX package's names so
callers catch one type in both packages).

The reference's RedisExecutor wraps every command in a retry state
machine (``retryAttempts`` x ``retryInterval``, →
org/redisson/command/RedisExecutor.java) and surfaces typed exceptions.
Here failures split by where they surface:

- **Dispatch-time** (the executor method raised before it wrote any
  pool state): safe to retry with backoff; exhaustion raises
  ``RetryExhaustedError``.  A method that raised AFTER its first
  in-place write surfaces ``NonRetryableDispatchError`` instead: a
  re-dispatch would apply its ops twice.
- **Completion-time** (the result fetch raised — an asynchronous CUDA
  error surfaces there): the launch already ran, so it is NOT retried;
  every op of it fails with a ``KernelExecutionError`` that locates the
  op range within the launch.
- **Result-wait timeouts**: blocking on a future past the fetch timeout
  raises ``DispatchTimeoutError``; past the op's own deadline,
  ``DeadlineExceededError``.
"""

from __future__ import annotations


class RedissonTpuError(Exception):
    """Base class for executor-boundary failures."""


class DispatchTimeoutError(RedissonTpuError, TimeoutError):
    """A blocking result wait exceeded its deadline."""


class DeadlineExceededError(RedissonTpuError, TimeoutError):
    """An op's end-to-end deadline expired.  Raised strictly BEFORE the
    device launch — admission control at submit, the expired-segment
    sweep at flush, the direct-dispatch check at the dispatch lock — so a
    deadline failure never means a half-applied op (``stage`` one of
    ``submit``/``admission``/``queue``/``direct``), or its result was not
    awaited in time (``fetch_wait``: the op may still complete on the
    device, but it was never acked)."""

    def __init__(self, msg: str, stage: str = "submit"):
        super().__init__(msg)
        self.stage = stage


class TenantThrottledError(RedissonTpuError):
    """The op was shed by a per-tenant quota (token-bucket rate limit or
    in-flight bound) before it reached the queue: one bursting tenant is
    shed here so the others never see its queue wait."""

    def __init__(self, tenant: str, reason: str, detail: str = ""):
        super().__init__(
            f"tenant {tenant!r} throttled ({reason})"
            + (f": {detail}" if detail else "")
        )
        self.tenant = tenant
        self.reason = reason


class NonRetryableDispatchError(RedissonTpuError):
    """A dispatch failed AFTER part of its device state was already
    written (a pool updated in place, or the first group of a
    migration-split launch applied).  A blind re-dispatch would apply
    the written part twice, so the coalescer fails it once."""


class RetryExhaustedError(RedissonTpuError):
    """Dispatch kept failing after the configured retry budget (or its
    circuit is open, or it was not retryable)."""

    def __init__(self, attempts: int, cause: BaseException):
        super().__init__(f"dispatch failed after {attempts} attempts: {cause!r}")
        self.attempts = attempts
        self.__cause__ = cause


class ExecutorRetiredError(RedissonTpuError):
    """The executor was replaced by a live topology change while this
    dispatch waited for it (the MOVED-redirect analog).  Raised before
    any pool write, so it is retryable: the coalescer's retry loop reads
    ``engine.executor`` again and lands on the new topology."""


class KernelExecutionError(RedissonTpuError):
    """A device batch failed at completion; carries the failed op range.

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
