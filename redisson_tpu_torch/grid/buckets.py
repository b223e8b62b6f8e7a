"""Buckets/values — → org/redisson/RedissonBucket.java (RBucket),
RedissonBuckets.java (RBuckets multi-get/set), RedissonBinaryStream.java.

Values are stored codec-encoded (the grid's Redis-string analog), so codec
round-trip semantics match the reference: what you read is
``codec.decode(codec.encode(x))``.
"""

from __future__ import annotations

import io
from typing import Any, Optional

from redisson_tpu_torch.grid.base import GridObject, journaled

_MISSING = object()


@journaled("set", "set_if_absent", "set_if_exists", "get_and_set",
           "get_and_delete", "compare_and_set")
class Bucket(GridObject):
    KIND = "bucket"

    @staticmethod
    def _new_value():
        return None

    def get(self) -> Any:
        e = self._entry(create=False)
        if e is None or e.value is None:
            return None
        return self._dec(e.value)

    def set(self, value: Any, ttl_seconds: Optional[float] = None) -> None:
        self._store.put_entry(self._name, self.KIND, self._enc(value))
        if ttl_seconds is not None:
            self.expire(ttl_seconds)

    def set_if_absent(self, value: Any, ttl_seconds: Optional[float] = None) -> bool:
        """→ RBucket#setIfAbsent (SET NX)."""
        with self._store.lock:
            if self._store.exists(self._name):
                return False
            self.set(value, ttl_seconds)
            return True

    # Deprecated reference alias kept for API parity.
    try_set = set_if_absent

    def set_if_exists(self, value: Any) -> bool:
        """→ RBucket#setIfExists (SET XX).  Replaces the entry wholesale —
        Redis SET XX without KEEPTTL clears any TTL, matching set()."""
        with self._store.lock:
            if self._entry(create=False) is None:
                return False
            self._store.put_entry(self._name, self.KIND, self._enc(value))
            return True

    def get_and_set(self, value: Any) -> Any:
        with self._store.lock:
            old = self.get()
            self.set(value)
            return old

    def get_and_delete(self) -> Any:
        with self._store.lock:
            old = self.get()
            self.delete()
            return old

    def compare_and_set(self, expect: Any, update: Any) -> bool:
        """→ RBucket#compareAndSet: encoded-bytes equality, like the
        reference's value comparison on the serialized form."""
        with self._store.lock:
            e = self._entry(create=False)
            cur = None if e is None or e.value is None else e.value
            exp = None if expect is None else self._enc(expect)
            if cur != exp:
                return False
            self.set(update)
            return True

    def size(self) -> int:
        """→ RBucket#size (STRLEN of the serialized value)."""
        e = self._entry(create=False)
        return 0 if e is None or e.value is None else len(e.value)


class Buckets:
    """→ org/redisson/RedissonBuckets.java: multi-key get/set (MGET/MSET)."""

    def __init__(self, client):
        self._client = client
        self._store = client._grid

    def get(self, *names: str) -> dict:
        out = {}
        for n in names:
            v = self._client.get_bucket(n).get()
            if v is not None:
                out[n] = v
        return out

    def set(self, mapping: dict) -> None:
        with self._store.lock:
            for n, v in mapping.items():
                self._client.get_bucket(n).set(v)

    def try_set(self, mapping: dict) -> bool:
        """MSETNX: all-or-nothing if any key exists."""
        with self._store.lock:
            if any(self._store.exists(n) for n in mapping):
                return False
            self.set(mapping)
            return True


@journaled("set")
class BinaryStream(GridObject):
    """→ org/redisson/RedissonBinaryStream.java: raw byte-string key with
    stream-style IO."""

    KIND = "binarystream"

    @staticmethod
    def _new_value():
        return b""

    def get(self) -> bytes:
        e = self._entry(create=False)
        return b"" if e is None else e.value

    def set(self, data: bytes) -> None:
        self._store.put_entry(self._name, self.KIND, bytes(data))

    def size(self) -> int:
        return len(self.get())

    def get_output_stream(self) -> io.BytesIO:
        """Writer whose close() commits the bytes (append semantics)."""
        stream = self

        class _Out(io.BytesIO):
            def close(self) -> None:
                with stream._store.lock:
                    e = stream._entry()
                    e.value = e.value + self.getvalue()
                super().close()

        return _Out()

    def get_input_stream(self) -> io.BytesIO:
        return io.BytesIO(self.get())


@journaled("set_path", "array_append", "string_append", "increment")
class JsonBucket(Bucket):
    """→ RJsonBucket (RedisJSON-backed bucket): JSON value with dot-path
    reads/writes (`$` or empty = root, `a.b.0.c` walks objects/arrays)."""

    KIND = "bucket"

    def __init__(self, name, client):
        super().__init__(name, client)
        import json as _json

        # JSON values travel as canonical JSON bytes regardless of codec.
        self._enc = lambda v: _json.dumps(v).encode()
        self._dec = lambda b: _json.loads(b.decode())

    @staticmethod
    def _walk(root, path):
        if path in ("", "$", None):
            return root, None, None
        parts = [p for p in str(path).replace("$.", "").split(".") if p]
        cur = root
        for p in parts[:-1]:
            cur = cur[int(p)] if isinstance(cur, list) else cur[p]
        leaf = parts[-1]
        key = int(leaf) if isinstance(cur, list) else leaf
        return cur[key], cur, key

    def get_path(self, path: str = "$"):
        """→ RJsonBucket#get(path) (JSON.GET)."""
        doc = self.get()
        if doc is None:
            return None
        value, _, _ = self._walk(doc, path)
        return value

    def _save(self, doc) -> None:
        """In-place value update PRESERVING the key's TTL — RedisJSON path
        writes (JSON.SET path / NUMINCRBY / ARRAPPEND) never touch key
        expiry, unlike SET."""
        with self._store.lock:
            e = self._entry()
            e.value = self._enc(doc)

    def set_path(self, path: str, value) -> None:
        """→ RJsonBucket#set(path, value) (JSON.SET)."""
        if path in ("", "$", None):
            self.set(value)
            return
        with self._store.lock:
            doc = self.get()
            if doc is None:
                raise ValueError("document does not exist; set the root first")
            _, parent, key = self._walk(doc, path)
            parent[key] = value
            self._save(doc)

    def array_append(self, path: str, *values) -> int:
        """→ JSON.ARRAPPEND: new array length."""
        with self._store.lock:
            doc = self.get()
            arr, parent, key = self._walk(doc, path)
            if not isinstance(arr, list):
                raise TypeError(f"path {path!r} does not hold an array")
            arr.extend(values)
            self._save(doc)
            return len(arr)

    def string_append(self, path: str, suffix: str) -> int:
        """→ JSON.STRAPPEND: new string length."""
        with self._store.lock:
            doc = self.get()
            s, parent, key = self._walk(doc, path)
            if not isinstance(s, str):
                raise TypeError(f"path {path!r} does not hold a string")
            out = s + suffix
            if parent is None:
                self._save(out)
            else:
                parent[key] = out
                self._save(doc)
            return len(out)

    def increment(self, path: str, delta) -> float:
        """→ JSON.NUMINCRBY."""
        with self._store.lock:
            doc = self.get()
            n, parent, key = self._walk(doc, path)
            if not isinstance(n, (int, float)) or isinstance(n, bool):
                raise TypeError(f"path {path!r} does not hold a number")
            out = n + delta
            if parent is None:
                self._save(out)
            else:
                parent[key] = out
                self._save(doc)
            return out
