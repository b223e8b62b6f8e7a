"""Client-side RESP wire helpers shared by the bench and the test
harnesses (one copy of the reply-frame walker — a framing fix applied to
a private duplicate would leave the other silently wrong).

These are deliberately simple and allocation-light: the bench's reply
counter calls ``skip_reply_frame`` per frame on the hot loop.
"""

from __future__ import annotations


def wire_command(args) -> bytes:
    """Encode one command as a RESP multibulk request frame."""
    out = b"*%d\r\n" % len(args)
    for a in args:
        if isinstance(a, str):
            a = a.encode()
        out += b"$%d\r\n%s\r\n" % (len(a), a)
    return out


def skip_reply_frame(buf: bytes, i: int) -> int:
    """End offset of the RESP reply frame starting at ``i``.

    Raises IndexError when the frame is incomplete (read more bytes and
    retry) and ValueError on an unparseable frame type — callers must
    treat the latter as a corrupt stream, never silently resync."""
    j = buf.find(b"\r\n", i)
    if j < 0:
        raise IndexError("incomplete header")
    t, body = buf[i : i + 1], buf[i + 1 : j]
    i = j + 2
    if t in (b"+", b"-", b":"):
        return i
    if t == b"$":
        n = int(body)
        if n < 0:
            return i
        if len(buf) < i + n + 2:
            raise IndexError("incomplete bulk")
        return i + n + 2
    if t in (b"*", b">"):
        for _ in range(max(0, int(body))):
            i = skip_reply_frame(buf, i)
        return i
    raise ValueError(f"bad reply frame type {t!r}")


class ReplyError(Exception):
    """A RESP error reply (``-...``), decoded but NOT raised by
    ``decode_reply`` — scatter/gather callers must be able to place
    per-command errors positionally without unwinding the batch."""

    @property
    def code(self) -> str:
        """Leading word of the error ('MOVED', 'ASK', 'ERR', ...)."""
        return str(self).split(" ", 1)[0]


def decode_reply(buf: bytes, i: int = 0):
    """Decode ONE RESP reply frame at ``i`` into (value, end_offset).

    simple string -> bytes, integer -> int, bulk -> bytes|None,
    array/push -> list, error -> a ReplyError INSTANCE (returned, not
    raised).  IndexError/ValueError signal an incomplete frame, like
    ``skip_reply_frame``.
    """
    j = buf.index(b"\r\n", i)
    t, body = buf[i : i + 1], buf[i + 1 : j]
    i = j + 2
    if t == b"+":
        return body, i
    if t == b"-":
        return ReplyError(body.decode("latin-1", "replace")), i
    if t == b":":
        return int(body), i
    if t == b"$":
        n = int(body)
        if n < 0:
            return None, i
        if len(buf) < i + n + 2:
            raise IndexError("incomplete bulk")
        return buf[i : i + n], i + n + 2
    if t in (b"*", b">"):
        n = int(body)
        if n < 0:
            return None, i
        out = []
        for _ in range(n):
            v, i = decode_reply(buf, i)
            out.append(v)
        return out, i
    raise ValueError(f"bad reply frame type {t!r}")


def decode_command(buf: bytes, i: int = 0):
    """Decode ONE RESP multibulk REQUEST frame at ``i`` into
    (argv list of bytes, end_offset) — the inverse of
    :func:`wire_command`, for harnesses that play the SERVER side of
    the wire (the netsim protocol models' node actors).
    IndexError/ValueError signal an incomplete frame, like
    ``decode_reply``; a frame that is complete but not a multibulk
    command raises ValueError (corrupt stream, never resync)."""
    j = buf.index(b"\r\n", i)
    if buf[i : i + 1] != b"*":
        raise ValueError(
            f"bad command frame type {buf[i:i + 1]!r} (want multibulk)"
        )
    n = int(buf[i + 1 : j])
    i = j + 2
    out: list = []
    for _ in range(n):
        j = buf.index(b"\r\n", i)
        if buf[i : i + 1] != b"$":
            raise ValueError("command args must be bulk strings")
        ln = int(buf[i + 1 : j])
        i = j + 2
        if len(buf) < i + ln + 2:
            raise IndexError("incomplete bulk")
        out.append(buf[i : i + ln])
        i += ln + 2
    return out, i


def encode_reply(v) -> bytes:
    """Encode one decoded-reply-shaped value back into a RESP frame —
    the server half the netsim node harnesses speak.  The mapping is
    ``decode_reply``'s inverse: int -> ``:``, bytes -> bulk, None ->
    nil bulk, list -> array, ReplyError -> ``-``, str -> simple
    string (use bytes for data, str only for ``+OK``-class acks)."""
    if isinstance(v, bool):
        return b":%d\r\n" % int(v)
    if isinstance(v, int):
        return b":%d\r\n" % v
    if v is None:
        return b"$-1\r\n"
    if isinstance(v, ReplyError):
        return b"-" + str(v).encode("latin-1", "replace") + b"\r\n"
    if isinstance(v, str):
        return b"+" + v.encode("latin-1", "replace") + b"\r\n"
    if isinstance(v, (bytes, bytearray)):
        v = bytes(v)
        return b"$%d\r\n%s\r\n" % (len(v), v)
    if isinstance(v, (list, tuple)):
        return b"*%d\r\n" % len(v) + b"".join(encode_reply(x) for x in v)
    raise TypeError(f"cannot encode reply value of type {type(v)!r}")


def exchange(sock, cmds) -> list:
    """One pipelined request/response cycle on a CONNECTED socket:
    ship ``cmds`` in one sendall, decode exactly ``len(cmds)`` replies
    in order (error replies as ReplyError instances, never raised).

    The one copy of the client-side framing loop (this module's
    founding rule): the cluster client's pooled connections, the
    supervisor's control requests, and the migration pump all ride it.
    Raises OSError when the peer closes mid-reply — after which the
    socket is DESYNCED and must be discarded, never reused."""
    sock.sendall(b"".join(wire_command(c) for c in cmds))
    buf = b""
    out: list = []
    pos = 0
    while len(out) < len(cmds):
        chunk = sock.recv(1 << 16)
        if not chunk:
            raise OSError("peer closed mid-reply")
        buf += chunk
        while len(out) < len(cmds):
            try:
                val, pos = decode_reply(buf, pos)
            except (IndexError, ValueError):
                break  # incomplete frame: recv more
            out.append(val)
    return out
