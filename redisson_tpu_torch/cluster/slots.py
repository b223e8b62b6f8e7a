"""Keyspace slot math — the 16384-slot CRC16 cluster topology layer
(PAPER.md §1, SURVEY §2.4 cluster row).

Three pure pieces every other cluster module builds on:

- ``crc16`` — CRC16/XMODEM (poly 0x1021, init 0), the exact polynomial
  redis-cluster hashes with, so slot numbers printed by this framework
  agree with redis-cli and every stock cluster client;
- ``hash_tag`` / ``key_slot`` — the ``{...}`` hash-tag rule: when a key
  contains a non-empty brace section, ONLY that section hashes, so
  callers co-locate multi-key operations (``{user:1}.cart`` and
  ``{user:1}.profile`` share a slot);
- ``command_keys`` — the RESP command → key-positions table the door's
  redirect check and the client's router share (one copy: a routing fix
  applied to only one side would strand traffic).

No locks, no I/O, no torch — client processes import this without paying
for the engine.
"""

from __future__ import annotations

NSLOTS = 16384

# CRC16/XMODEM table (poly 0x1021), generated once at import.
_CRC16_TABLE = []
for _i in range(256):
    _crc = _i << 8
    for _ in range(8):
        _crc = ((_crc << 1) ^ 0x1021 if _crc & 0x8000 else _crc << 1) & 0xFFFF
    _CRC16_TABLE.append(_crc)
del _i, _crc


def crc16(data: bytes) -> int:
    """CRC16/XMODEM over ``data`` (redis-cluster's keyslot hash)."""
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFF) ^ _CRC16_TABLE[((crc >> 8) ^ b) & 0xFF]
    return crc


def hash_tag(key: bytes) -> bytes:
    """The hashable section of ``key``: the content of the FIRST
    ``{...}`` pair when it is non-empty, else the whole key (the
    redis-cluster hash-tag rule — ``{}`` and an unterminated ``{`` hash
    the full key)."""
    i = key.find(b"{")
    if i >= 0:
        j = key.find(b"}", i + 1)
        if j > i + 1:  # non-empty interior only
            return key[i + 1 : j]
    return key


def key_slot(key) -> int:
    """Slot (0..16383) of ``key`` (str or bytes)."""
    if isinstance(key, str):
        key = key.encode()
    return crc16(hash_tag(key)) % NSLOTS


# -- command -> key positions -------------------------------------------------

# Commands whose ONLY key is argv[1] (the overwhelmingly common shape).
_FIRST_KEY = frozenset(
    b.encode()
    for b in (
        "GET SET SETNX SETEX PSETEX GETSET GETDEL APPEND STRLEN GETRANGE "
        "SETRANGE GETEX SETBIT GETBIT BITCOUNT BITPOS INCR INCRBY DECR "
        "INCRBYFLOAT TYPE DUMP RESTORE EXPIRE PEXPIRE TTL PTTL PERSIST "
        "EXPIREAT PEXPIREAT PFADD LPUSH RPUSH LPUSHX RPUSHX LPOP RPOP "
        "LLEN LRANGE LINDEX LSET LREM LTRIM HSET HGET HDEL HLEN HGETALL "
        "HMGET HKEYS HVALS HEXISTS HSETNX HINCRBY HRANDFIELD SADD SREM "
        "SISMEMBER SCARD SMEMBERS SMISMEMBER SPOP SRANDMEMBER ZADD "
        "ZSCORE ZRANGE ZCARD ZREM ZINCRBY ZRANK ZCOUNT ZRANGEBYSCORE "
        "ZPOPMIN ZPOPMAX ZREVRANGE ZREVRANK ZREMRANGEBYSCORE ZRANGEBYLEX "
        "ZRANDMEMBER LPOS HSCAN SSCAN ZSCAN XADD XLEN XRANGE XREVRANGE "
        "XDEL XTRIM XACK XPENDING XCLAIM XAUTOCLAIM GEOADD GEOPOS "
        "GEODIST GEOHASH GEOSEARCH BF.RESERVE BF.ADD BF.MADD BF.EXISTS "
        "BF.MEXISTS BF.INFO CMS.INITBYDIM CMS.INCRBY CMS.QUERY CMS.INFO "
        "TOPK.RESERVE TOPK.ADD TOPK.INCRBY TOPK.QUERY TOPK.COUNT "
        "TOPK.LIST TOPK.INFO"
    ).split()
)

# Every argument is a key.
_ALL_KEYS = frozenset(
    b.encode()
    for b in (
        "DEL EXISTS UNLINK MGET PFCOUNT PFMERGE SINTER SUNION SDIFF "
        "SINTERSTORE SUNIONSTORE SDIFFSTORE WATCH"
    ).split()
)

# key value [key value ...]
_STEP2 = frozenset((b"MSET", b"MSETNX"))

# Exactly two keys, argv[1] and argv[2].
_TWO_KEYS = frozenset(
    (b"RENAME", b"RENAMENX", b"COPY", b"SMOVE", b"LMOVE", b"RPOPLPUSH",
     b"GEOSEARCHSTORE")
)

# dest numkeys key [key ...]  (keys = dest + the counted block)
_DEST_NUMKEYS = frozenset((b"ZUNIONSTORE", b"ZINTERSTORE", b"CMS.MERGE"))

# numkeys key [key ...] at argv[1]
_NUMKEYS_AT_1 = frozenset((b"SINTERCARD",))

# script-shaped: <body|sha|fn> numkeys key [key ...]
_SCRIPT_SHAPE = frozenset((b"EVAL", b"EVALSHA", b"FCALL", b"FCALL_RO"))

# subcommand key ... (key at argv[2])
_SUBCMD_KEY = frozenset((b"OBJECT", b"XGROUP", b"XINFO"))


def command_keys(cmd: list) -> list:
    """Key arguments of one RESP command (argv incl. the command name),
    as bytes.  Unknown / keyless / admin commands return [] — the door
    serves them locally on any node, like redis-cluster."""
    if not cmd:
        return []
    name = cmd[0].upper()
    args = cmd[1:]
    try:
        if name in _FIRST_KEY:
            return args[:1]
        if name in _ALL_KEYS:
            return list(args)
        if name in _STEP2:
            return args[0::2]
        if name in _TWO_KEYS:
            return args[:2]
        if name in _DEST_NUMKEYS:
            n = int(args[1])
            return args[:1] + args[2 : 2 + n]
        if name in _NUMKEYS_AT_1:
            n = int(args[0])
            return args[1 : 1 + n]
        if name in _SCRIPT_SHAPE:
            n = int(args[1])
            return args[2 : 2 + n]
        if name in _SUBCMD_KEY:
            return args[1:2]
        if name in (b"BLPOP", b"BRPOP"):
            return args[:-1]
        if name in (b"XREAD", b"XREADGROUP"):
            for i, a in enumerate(args):
                if a.upper() == b"STREAMS":
                    rest = args[i + 1 :]
                    return rest[: len(rest) // 2]
            return []
    except (ValueError, IndexError):
        return []  # malformed: the handler's own arg parsing errors
    return []
