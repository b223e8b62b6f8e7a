"""RBatch — → org/redisson/RedissonBatch.java; the port's copy of
``redisson_tpu/grid/batch.py``.

``client.create_batch()`` hands out batch-scoped object facades; every
method call queues and returns a placeholder future; ``execute()`` runs
the queue in submission order and returns a ``BatchResult`` with one
response per call.  Sync-named sketch calls ride their objects'
``_DEFERRED`` forms, so one ``execute()`` coalesces into a few device
dispatches (the reference pipelines a batch by construction); data-grid
calls (maps, buckets, queues, ...) run on one serial worker in
submission order beside them.
"""

from __future__ import annotations

from typing import Any

from redisson_tpu_torch.objects.base import camel_to_snake

_PENDING = object()


class BatchResult:
    """→ org/redisson/api/BatchResult.java."""

    def __init__(self, responses: list):
        self._responses = responses

    def get_responses(self) -> list:
        return self._responses

    @property
    def responses(self) -> list:
        return self._responses

    def __len__(self):
        return len(self._responses)

    def __getitem__(self, i):
        return self._responses[i]


class BatchFuture:
    """Placeholder that ``Batch.execute()`` resolves (the RFuture a queued
    batch call returns in the reference)."""

    def __init__(self):
        self._value = _PENDING

    def _set(self, value: Any) -> None:
        self._value = value

    def result(self):
        if self._value is _PENDING:
            raise RuntimeError("batch has not been executed yet")
        return self._value

    get = result

    def done(self) -> bool:
        return self._value is not _PENDING


class _BatchProxy:
    """Object facade whose method calls queue into the batch."""

    def __init__(self, batch: "Batch", obj):
        object.__setattr__(self, "_batch", batch)
        object.__setattr__(self, "_obj", obj)

    def __getattr__(self, item):
        target = getattr(self._obj, item)  # resolves camelCase aliases too
        if not callable(target):
            return target

        def queued(*args, **kwargs):
            fut = BatchFuture()
            self._batch._ops.append((self._obj, item, args, kwargs, fut))
            return fut

        return queued


class Batch:
    """→ RedissonBatch: ``get_*`` mirrors the client's object factories;
    objects are batch-scoped proxies."""

    def __init__(self, client):
        self._client = client
        self._ops: list[tuple] = []
        self._executed = False

    def __getattr__(self, item):
        if item.startswith("get_") or (item.startswith("get") and item[3:4].isupper()):
            factory = getattr(self._client, item)

            def make(*args, **kwargs):
                return _BatchProxy(self, factory(*args, **kwargs))

            return make
        raise AttributeError(item)

    def execute(self) -> BatchResult:
        """Run every queued call in submission order; one response per
        call.  A batch runs once (reference semantics).  Deferred and
        ``*_async`` sketch calls are resolved after the whole queue is
        issued, so their dispatches coalesce; grid calls run on one serial
        worker in order; other calls run with their sync contract."""
        if self._executed:
            raise RuntimeError("batch was already executed")
        self._executed = True
        from redisson_tpu_torch.grid.base import GridObject

        serial = None  # per-execute single worker: grid ops leave the
        # caller thread but keep submission order (the one-connection
        # pipeline ordering of the reference batch)
        staged: list[tuple] = []  # (pending future or None, BatchFuture)
        try:
            for obj, meth, args, kwargs, fut in self._ops:
                # camelCase spellings first, or 'addAll' would match
                # neither the _DEFERRED table nor the *_async rule.
                if not hasattr(type(obj), meth):
                    meth = camel_to_snake(meth)
                deferred = getattr(type(obj), "_DEFERRED", {}).get(meth)
                if deferred is not None:
                    staged.append(
                        (getattr(obj, deferred)(*args, **kwargs), fut)
                    )
                    continue
                if isinstance(obj, GridObject):
                    # ALL grid ops — sync- and async-named — run on ONE
                    # serial worker in submission order, so a get never
                    # observes the map before an earlier fast_put_async.
                    # *_async names call the sync form: the batch pipeline
                    # itself is the asynchrony.  Blocking ops act at
                    # execute(), like commands in a Redis MULTI.
                    if meth.endswith("_async"):
                        sync_meth = meth[: -len("_async")]
                        if hasattr(obj, sync_meth):
                            meth = sync_meth
                    if serial is None:
                        from concurrent.futures import ThreadPoolExecutor

                        serial = ThreadPoolExecutor(
                            max_workers=1, thread_name_prefix="rtpu-batch"
                        )
                    staged.append(
                        (serial.submit(getattr(obj, meth), *args, **kwargs),
                         fut)
                    )
                    continue
                result = getattr(obj, meth)(*args, **kwargs)
                if meth.endswith("_async") and hasattr(result, "result"):
                    staged.append((result, fut))
                else:
                    fut._set(result)
                    staged.append((None, fut))
            responses = []
            for pending, fut in staged:
                if pending is not None:
                    fut._set(pending.result())
                responses.append(fut.result())
            return BatchResult(responses)
        finally:
            if serial is not None:
                serial.shutdown(wait=False)

    def discard(self) -> None:
        """→ RBatch#discard."""
        self._ops.clear()
        self._executed = True
