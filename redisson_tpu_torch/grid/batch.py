"""RBatch — → org/redisson/RedissonBatch.java; counterpart of
``redisson_tpu/grid/batch.py`` for the sketch objects.

``client.create_batch()`` hands out batch-scoped object facades; every
method call queues and returns a placeholder future; ``execute()`` runs
the queue in submission order and returns a ``BatchResult`` with one
response per call.  Sync-named sketch calls ride their objects'
``_DEFERRED`` forms, so one ``execute()`` coalesces into a few device
dispatches (the reference pipelines a batch by construction).

The JAX package's batch also runs data-grid objects (maps, buckets,
queues) on a serial worker; the grid is not ported yet, so that branch
waits for it.
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
        ``*_async`` calls are resolved after the whole queue is issued,
        so their dispatches coalesce; other calls run with their sync
        contract in order."""
        if self._executed:
            raise RuntimeError("batch was already executed")
        self._executed = True
        staged: list[tuple] = []  # (pending future or None, BatchFuture)
        for obj, meth, args, kwargs, fut in self._ops:
            # camelCase spellings first, or 'addAll' would match neither the
            # _DEFERRED table nor the *_async rule.
            if not hasattr(type(obj), meth):
                meth = camel_to_snake(meth)
            deferred = type(obj)._DEFERRED.get(meth)
            if deferred is not None:
                staged.append((getattr(obj, deferred)(*args, **kwargs), fut))
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

    def discard(self) -> None:
        """→ RBatch#discard."""
        self._ops.clear()
        self._executed = True
