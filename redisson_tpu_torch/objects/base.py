"""Object-layer base plumbing: RObject idiom + camelCase compatibility.

Counterpart of ``redisson_tpu/objects/base.py`` (→
org/redisson/RedissonObject.java and RedissonExpirable.java):
name-addressed objects bound to a client engine with the RObject
lifecycle (exists, delete, rename, TTL, DUMP/RESTORE); camelCase names
(``tryInit``) alias the snake_case API.
"""

from __future__ import annotations

import re

import numpy as np

from redisson_tpu_torch.codecs import encode_batch
from redisson_tpu_torch.utils import hashing

_CAMEL_RE = re.compile(r"(?<!^)(?=[A-Z])")


def camel_to_snake(name: str) -> str:
    return _CAMEL_RE.sub("_", name).lower()


class CamelCompatMixin:
    """bloomFilter.tryInit(...) works exactly like bloom_filter.try_init."""

    def __getattr__(self, item):
        if not item.startswith("_"):
            snake = camel_to_snake(item)
            if snake != item:
                try:
                    return getattr(self, snake)
                except AttributeError:
                    pass
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {item!r}"
        )


class MappedFuture:
    """Future adapter applying a transform on ``.result()`` (the deferred
    forms of sync-named methods, and engine results)."""

    def __init__(self, fut, transform):
        self._fut = fut
        self._transform = transform

    def result(self, *a, **kw):
        return self._transform(self._fut.result(*a, **kw))

    get = result

    def done(self) -> bool:
        return self._fut.done()


class CompletedFuture:
    """An already-resolved future (RFuture parity)."""

    def __init__(self, value):
        self._value = value

    def result(self, *a, **kw):
        return self._value

    get = result

    @staticmethod
    def done() -> bool:
        return True


class RObject(CamelCompatMixin):
    """Name-addressed object bound to a client engine.

    ``_DEFERRED`` maps sync-named methods to methods returning a future
    whose value matches the SYNC return contract: the Batch facade routes
    queued sync calls through them, so a batch coalesces instead of
    running call by call."""

    KIND: str = ""
    _DEFERRED: dict = {}

    def __init__(self, name: str, client):
        self._name = name
        self._client = client
        self._engine = client._engine
        self._codec = client.config.codec

    def get_name(self) -> str:
        return self._name

    @property
    def name(self) -> str:
        return self._name

    def is_exists(self) -> bool:
        return self._engine.exists(self._name)

    def delete(self) -> bool:
        return self._engine.delete(self._name)

    def rename(self, new_name: str) -> None:
        if not self._engine.rename(self._name, new_name):
            # A failed rename (missing or expired source) leaves the handle
            # alone: repointing it would mutate whatever lives at new_name.
            raise RuntimeError(f"object {self._name!r} does not exist")
        self._name = new_name

    # -- expiry (→ org/redisson/RedissonExpirable.java) --------------------

    def expire(self, ttl_s: float) -> bool:
        """Schedule deletion ``ttl_s`` seconds from now (EXPIRE)."""
        return self._engine.expire(self._name, ttl_s)

    def expire_at(self, timestamp: float) -> bool:
        """Absolute-deadline expiry (EXPIREAT, unix seconds)."""
        return self._engine.expire_at(self._name, timestamp)

    def clear_expire(self) -> bool:
        """Remove a pending TTL (PERSIST)."""
        return self._engine.clear_expire(self._name)

    def remain_time_to_live(self) -> int:
        """Remaining TTL in ms; -1 no TTL, -2 absent (PTTL)."""
        return self._engine.remain_ttl_ms(self._name)

    # -- dump/restore (→ org/redisson/RedissonObject.java#dump) ------------

    def dump(self) -> bytes:
        """Opaque serialized state (DUMP); raises if absent."""
        data = self._engine.dump(self._name)
        if data is None:
            raise RuntimeError(f"object {self._name!r} does not exist")
        return data

    def restore(self, data: bytes, replace: bool = False) -> None:
        """Recreate this object from ``dump`` bytes (RESTORE)."""
        self._engine.restore(self._name, data, replace=replace)

    def _encode(self, objs) -> tuple[np.ndarray, np.ndarray]:
        if np.isscalar(objs) or isinstance(objs, (str, bytes)):
            objs = [objs]
        return encode_batch(self._codec, objs)

    def _hash128(self, objs):
        blocks, lengths = self._encode(objs)
        return hashing.hash128_np(blocks, lengths)
