"""RKeys — → org/redisson/RedissonKeys.java: keyspace administration
spanning BOTH backends (the host data grid and the sketch engine's tenant
registry), since a Redisson user sees one keyspace.
"""

from __future__ import annotations

import fnmatch
import random
from typing import Optional


def _chunked_snapshot_iter(fetch, count: int):
    """Shared SCAN-cursor shape: the snapshot is taken EAGERLY (at
    iterator creation, so the stated every-key-present-now guarantee
    holds even if consumption is deferred); iteration is a plain walk —
    ``count`` is accepted for SCAN-API parity but has no semantic effect
    on an in-process snapshot."""
    return iter(fetch())


class Keys:
    def __init__(self, client):
        self._client = client
        self._grid = client._grid
        self._engine = client._engine

    def get_keys(self, pattern: Optional[str] = None) -> list[str]:
        """→ RKeys#getKeys / getKeysByPattern (SCAN MATCH)."""
        names = self._grid.names(pattern)
        sketch = self._engine.names()
        if pattern is not None:
            sketch = [n for n in sketch if fnmatch.fnmatchcase(n, pattern)]
        return names + sketch

    def scan_iterator(self, pattern: Optional[str] = None, count: int = 10):
        """→ RKeys#getKeysByPattern's SCAN-cursor idiom (one O(N)
        keyspace snapshot).  Guarantees (stronger than Redis SCAN): every
        key present at iterator creation is yielded exactly once; keys
        created after creation do not appear."""
        return _chunked_snapshot_iter(lambda: self.get_keys(pattern), count)

    def count(self) -> int:
        """→ RKeys#count (DBSIZE)."""
        return len(self.get_keys())

    def count_exists(self, *names: str) -> int:
        """→ RKeys#countExists (EXISTS key [key ...])."""
        return sum(
            1
            for n in names
            if self._grid.exists(n) or self._engine.exists(n)
        )

    def delete(self, *names: str) -> int:
        """→ RKeys#delete: number of keys actually removed."""
        n = 0
        for name in names:
            if self._grid.delete(name):
                n += 1
            elif self._engine.exists(name) and self._engine.delete(name):
                n += 1
        return n

    def delete_by_pattern(self, pattern: str) -> int:
        """→ RKeys#deleteByPattern."""
        return self.delete(*self.get_keys(pattern))

    def flushall(self) -> None:
        """→ RKeys#flushall: every key in both backends."""
        self.delete(*self.get_keys())

    flushdb = flushall  # single logical database

    def random_key(self) -> Optional[str]:
        keys = self.get_keys()
        return random.choice(keys) if keys else None

    def rename(self, old: str, new: str) -> None:
        if self._grid.exists(old):
            self._grid.rename(old, new)
        elif self._engine.exists(old):
            self._engine.rename(old, new)
        else:
            raise RuntimeError(f"key {old!r} does not exist")

    def expire(self, name: str, ttl_seconds: float) -> bool:
        if self._grid.exists(name):
            return self._grid.expire(name, ttl_seconds)
        expire = getattr(self._engine, "expire", None)
        return expire(name, ttl_seconds) if expire else False

    def remain_time_to_live(self, name: str) -> int:
        if self._grid.exists(name):
            return self._grid.remain_ttl_ms(name)
        remain = getattr(self._engine, "remain_ttl_ms", None)
        if remain is not None:
            return remain(name)
        return -1 if self._engine.exists(name) else -2

    # camelCase parity
    getKeys = get_keys
    getKeysByPattern = get_keys
    countExists = count_exists
    deleteByPattern = delete_by_pattern
    randomKey = random_key
