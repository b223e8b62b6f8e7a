"""Pluggable key/value codecs — parity with org/redisson/client/codec/ and
org/redisson/codec/ (SURVEY.md §1 L4).

The reference ships ~15 codecs (JsonJacksonCodec, StringCodec,
ByteArrayCodec, LongCodec, Kryo5Codec, CompositeCodec, …).  We keep the same
interface shape — a ``Codec`` with key/value encode/decode — with Python
equivalents: pickle stands in for Java serialization (Kryo/FST/Marshalling),
json for Jackson.

``encode_batch`` is the device-relevant addition: it vectorizes encoding of a
whole key batch straight into the fixed-shape uint32 lane arrays the hash
kernels consume, with a zero-copy fast path for integer ndarrays.
"""

from __future__ import annotations

import json
import pickle
import struct
from typing import Any, Iterable

import numpy as np

from redisson_tpu_torch.utils import hashing


class Codec:
    """→ org/redisson/client/codec/Codec.java (key+value Encoder/Decoder)."""

    def encode(self, obj: Any) -> bytes:
        raise NotImplementedError

    def decode(self, data: bytes) -> Any:
        raise NotImplementedError

    # Map-style codecs can distinguish keys from values; default: same.
    def encode_key(self, obj: Any) -> bytes:
        return self.encode(obj)

    def decode_key(self, data: bytes) -> Any:
        return self.decode(data)


class StringCodec(Codec):
    """→ org/redisson/client/codec/StringCodec.java (UTF-8)."""

    def encode(self, obj: Any) -> bytes:
        return obj.encode("utf-8") if isinstance(obj, str) else str(obj).encode("utf-8")

    def decode(self, data: bytes) -> Any:
        return data.decode("utf-8")


class ByteArrayCodec(Codec):
    """→ org/redisson/client/codec/ByteArrayCodec.java."""

    def encode(self, obj: Any) -> bytes:
        return bytes(obj)

    def decode(self, data: bytes) -> Any:
        return data


class LongCodec(Codec):
    """→ org/redisson/client/codec/LongCodec.java; 8-byte little-endian
    (layout chosen to match the vectorized uint64 fast path).

    Encode accepts the full -2**63 .. 2**64-1 range.  The halves
    [-2**63, 0) and [2**63, 2**64) share byte patterns, so decode must
    know which interpretation the caller wants: the default round-trips
    SIGNED int64 (grid storage paths); ``LongCodec(unsigned=True)``
    round-trips uint64 (the sketch hash fast path, whose np.uint64 keys
    may exceed 2**63 — storing those through the default codec would
    silently come back negative)."""

    def __init__(self, unsigned: bool = False):
        self.unsigned = unsigned

    def encode(self, obj: Any) -> bytes:
        v = int(obj)
        # Full uint64 range: the ndarray fast path accepts np.uint64 keys
        # >= 2**63, and the per-element path must produce the SAME
        # little-endian bytes ('<q' raised struct.error there, crashing
        # top_k()/estimate() for keys add() had accepted).
        return struct.pack("<Q", v) if v >= 1 << 63 else struct.pack("<q", v)

    def decode(self, data: bytes) -> Any:
        v = struct.unpack("<q", data)[0]
        if self.unsigned and v < 0:
            v += 1 << 64  # symmetric with the '<Q' encode branch
        return v


class JsonCodec(Codec):
    """→ org/redisson/codec/JsonJacksonCodec.java analog."""

    def encode(self, obj: Any) -> bytes:
        return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode("utf-8")

    def decode(self, data: bytes) -> Any:
        return json.loads(data.decode("utf-8"))


class PickleCodec(Codec):
    """Analog of the Java-serialization codecs (Kryo5Codec/FstCodec/…,
    → org/redisson/codec/)."""

    def encode(self, obj: Any) -> bytes:
        return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)

    def decode(self, data: bytes) -> Any:
        return pickle.loads(data)


class CompositeCodec(Codec):
    """→ org/redisson/codec/CompositeCodec.java: separate key/value codecs."""

    def __init__(self, key_codec: Codec, value_codec: Codec):
        self.key_codec = key_codec
        self.value_codec = value_codec

    def encode(self, obj: Any) -> bytes:
        return self.value_codec.encode(obj)

    def decode(self, data: bytes) -> Any:
        return self.value_codec.decode(data)

    def encode_key(self, obj: Any) -> bytes:
        return self.key_codec.encode(obj)

    def decode_key(self, data: bytes) -> Any:
        return self.key_codec.decode(data)


DEFAULT_CODEC = PickleCodec()  # reference default is a binary object codec


def encode_batch(codec: Codec, objs: Iterable[Any]) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized batch encode → (uint32 lane blocks, byte lengths).

    Fast path: integer ndarray under a LongCodec avoids the per-item Python
    loop entirely (the hot bench path).  Only LongCodec opts in — other
    codecs must see every element so their byte layout is honored.
    """
    key_codec = codec.key_codec if isinstance(codec, CompositeCodec) else codec
    if (
        isinstance(objs, np.ndarray)
        and objs.dtype.kind in "iu"
        and isinstance(key_codec, LongCodec)
    ):
        return hashing.encode_uint64_batch(objs.astype(np.uint64, copy=False))
    return hashing.encode_bytes_batch([codec.encode_key(o) for o in objs])
