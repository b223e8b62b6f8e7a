"""Reactive facade — → org/redisson/reactive/ + org/redisson/rx/
(RedissonReactiveClient / RedissonRxClient, SURVEY.md §2.3 facades row).

The reference wraps every object reflectively into Reactor ``Mono/Flux``
or RxJava types (ReactiveProxyBuilder/RxProxyBuilder).  The idiomatic
Python analog of that reactive idiom is **asyncio**: ``client.reactive()``
returns a client whose ``get_*`` factories hand out proxies where every
method call returns an awaitable — the blocking work runs off the event
loop (default executor), results resolve into the coroutine.

    rc = client.reactive()

    async def main():
        bf = rc.get_bloom_filter("users")
        await bf.try_init(1_000_000, 0.01)
        await bf.add("alice")
        hit = await bf.contains("alice")

Like the reference's reactive wrappers this is a REFLECTIVE facade over
the sync objects: the full method surface (camelCase aliases included)
is available without per-object adapter code.

Cancellation caveat (shared with the reference's reactive wrappers over
blocking drivers): cancelling/timing out an await abandons the result
but cannot interrupt the underlying worker thread — a parked blocking
call (queue take, lock wait) runs to completion off-loop.  Prefer the
timeout-taking method variants (poll(timeout), try_lock(wait)) over
asyncio.wait_for for operations that can block indefinitely.

The port's copy of ``redisson_tpu/reactive.py``.
"""

from __future__ import annotations

import functools

# The framework's own future types live under this package; a value of
# any other module is returned as it is.
_PKG = __name__.partition(".")[0]


class ReactiveProxy:
    """One object's reactive view: every callable attribute returns a
    coroutine; non-callables pass through."""

    __slots__ = ("_obj",)

    def __init__(self, obj):
        object.__setattr__(self, "_obj", obj)

    def __getattr__(self, item):
        target = getattr(self._obj, item)  # resolves camelCase aliases too
        if not callable(target):
            return target

        @functools.wraps(target)
        async def call(*args, **kwargs):
            import asyncio

            from redisson_tpu_torch.grid.base import _spawn_future

            # _spawn_future classifies by method name: possibly-blocking
            # ops (take/poll/lock/acquire/...) get dedicated threads so
            # they can never starve each other; everything else rides
            # ONE bounded pool — 5k concurrent awaits of map gets cost
            # pool-width threads, not 5k (grid/base.py _may_block).
            res = await asyncio.wrap_future(
                _spawn_future(target, args, kwargs)._fut
            )
            # Awaiting an already-async method (fooAsync / *_async)
            # must yield the VALUE, not a future handle.  Only the
            # framework's OWN future types unwrap — duck-typing on
            # result()/done() corrupted legitimate return values (a
            # queue holding concurrent.futures.Future objects would have
            # its elements awaited instead of returned).
            if (
                type(res).__module__.partition(".")[0] == _PKG
                and hasattr(res, "result")
                and callable(getattr(res, "result"))
                and hasattr(res, "done")
            ):
                res = await asyncio.wrap_future(
                    _spawn_future(res.result, (), {})._fut
                )
            return res

        return call

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return f"ReactiveProxy({self._obj!r})"


class ReactiveClient:
    """→ RedissonClient#reactive(): ``get_*`` factories mirror the sync
    client surface, returning ReactiveProxy-wrapped objects."""

    def __init__(self, client):
        self._client = client

    def __getattr__(self, item):
        if item.startswith("get_") or (
            item.startswith("get") and item[3:4].isupper()
        ):
            factory = getattr(self._client, item)

            def make(*args, **kwargs):
                return ReactiveProxy(factory(*args, **kwargs))

            return make
        raise AttributeError(item)
