"""Execution engine: the torch executor and the batch coalescer.

Imports stay lazy (PEP 562 ``__getattr__``), so importing the failure
types never imports the device layer."""

from redisson_tpu_torch.executor.failures import (
    DeadlineExceededError,
    DispatchTimeoutError,
    ExecutorRetiredError,
    KernelExecutionError,
    NonRetryableDispatchError,
    RedissonTpuError,
    RetryExhaustedError,
    TenantThrottledError,
)

__all__ = [
    "LazyResult",
    "TorchCommandExecutor",
    "ShardedTorchCommandExecutor",
    "RedissonTpuError",
    "DispatchTimeoutError",
    "DeadlineExceededError",
    "ExecutorRetiredError",
    "KernelExecutionError",
    "NonRetryableDispatchError",
    "RetryExhaustedError",
    "TenantThrottledError",
]


def __getattr__(name):
    if name in ("LazyResult", "TorchCommandExecutor"):
        from redisson_tpu_torch.executor import torch_executor

        return getattr(torch_executor, name)
    if name == "ShardedTorchCommandExecutor":
        from redisson_tpu_torch.executor import sharded_executor

        return sharded_executor.ShardedTorchCommandExecutor
    raise AttributeError(name)
