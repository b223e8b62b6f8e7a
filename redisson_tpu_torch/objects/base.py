"""Object-layer base plumbing: RObject idiom + camelCase compatibility.

Counterpart of ``redisson_tpu/objects/base.py`` (→
org/redisson/RedissonObject.java): name-addressed objects bound to a
client engine; camelCase names (``tryInit``) alias the snake_case API.
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


class RObject(CamelCompatMixin):
    """Name-addressed object bound to a client engine."""

    KIND: str = ""

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

    def _encode(self, objs) -> tuple[np.ndarray, np.ndarray]:
        if np.isscalar(objs) or isinstance(objs, (str, bytes)):
            objs = [objs]
        return encode_batch(self._codec, objs)

    def _hash128(self, objs):
        blocks, lengths = self._encode(objs)
        return hashing.hash128_np(blocks, lengths)
