"""The port's copy of the native RESP codec
(``redisson_tpu_torch/native/resp_codec.c`` via
``redisson_tpu_torch/serve/native_codec.py``, built into
``build/native/``): the counterpart of ``tests/test_native_resp.py``.

The C parser must frame byte streams exactly like the pure-Python
``_Reader`` path — and like the JAX package's build of the same source —
across pipelining, arbitrary chunk splits, binary payloads and malformed
input; a stale library missing ``rtpu_resp_tick`` or
``rtpu_resp_encode_bulks`` fails hard under ``RTPU_REQUIRE_NATIVE_RESP``.
"""

import os
import random
import socket
import threading

import pytest

from redisson_tpu_torch.serve import native_codec
from redisson_tpu_torch.serve.native_codec import get_parser
from redisson_tpu_torch.serve.resp import _Reader


def _wire(args):
    out = b"*%d\r\n" % len(args)
    for a in args:
        out += b"$%d\r\n%s\r\n" % (len(a), a)
    return out


@pytest.fixture(scope="module")
def parser():
    p = get_parser()
    assert p is not None, "native codec must build in this image (cc present)"
    return p


def test_parse_pipeline(parser):
    cmds = [
        [b"PING"],
        [b"SET", b"k", b"v" * 100],
        [b"GET", b""],  # empty bulk
        [b"BF.MADD", b"f"] + [b"item%d" % i for i in range(50)],
        [b"SET", b"bin", bytes(range(256)) + b"\r\n$9\r\n*3\r\n"],  # wire bytes inside payload
    ]
    buf = b"".join(_wire(c) for c in cmds)
    frames, consumed, err = parser.parse(buf)
    assert err == native_codec.PARSE_OK
    assert consumed == len(buf)
    assert frames == cmds


def test_parse_incomplete_then_complete(parser):
    cmd = [b"SET", b"key", b"value"]
    buf = _wire(cmd)
    for cut in range(len(buf)):
        frames, consumed, err = parser.parse(buf[:cut])
        assert frames == [] and consumed == 0
        assert err == native_codec.PARSE_OK, (cut, err)
    frames, consumed, err = parser.parse(buf)
    assert frames == [cmd] and consumed == len(buf)


def test_parse_trailing_partial(parser):
    full = _wire([b"PING"]) * 3
    tail = _wire([b"SET", b"a", b"b"])[:7]
    frames, consumed, err = parser.parse(full + tail)
    assert len(frames) == 3 and consumed == len(full)
    assert err == native_codec.PARSE_OK


def test_parse_inline_fallback(parser):
    frames, consumed, err = parser.parse(b"PING\r\n")
    assert frames == [] and consumed == 0
    assert err == native_codec.PARSE_FALLBACK
    # Pipelined frames BEFORE the inline command still parse.
    frames, consumed, err = parser.parse(_wire([b"PING"]) + b"QUIT\r\n")
    assert frames == [[b"PING"]]
    assert err == native_codec.PARSE_FALLBACK


def test_parse_protocol_errors(parser):
    for bad in (
        b"*2\r\nPING\r\n",  # missing $ header
        b"*x\r\n",  # non-numeric argc
        b"*1\r\n$3\r\nabcd\r\n",  # bulk length mismatch (no CRLF at end)
        b"*1\r\n$x\r\n",  # non-numeric bulk len
    ):
        frames, consumed, err = parser.parse(bad)
        assert err == native_codec.PARSE_PROTO_ERROR, bad
        assert frames == []


def test_parse_first_frame_exceeds_arg_capacity(parser):
    # A COMPLETE frame with more args than the descriptor capacity must
    # signal fallback (the slow path has no argc cap) — not read as
    # "incomplete", which would block the connection forever.
    big = [b"HSET", b"h"] + [b"f%d" % i for i in range(parser.MAX_ARGS)]
    frames, consumed, err = parser.parse(_wire(big))
    assert frames == [] and consumed == 0
    assert err == native_codec.PARSE_FALLBACK
    # Frames before the oversized one still parse; capacity stops cleanly.
    frames, consumed, err = parser.parse(_wire([b"PING"]) + _wire(big))
    assert frames == [[b"PING"]]
    assert err == native_codec.PARSE_OK


def test_reader_handles_oversized_frame(parser):
    big = [b"HSET", b"h"] + [b"f%d" % i for i in range(parser.MAX_ARGS)]
    payload = _wire([b"PING"]) + _wire(big) + _wire([b"PING"])
    got = _drive_reader(payload, 65536, native=True)
    assert got == [[b"PING"], big, [b"PING"]]


def test_encode_array_int_fast_path(parser):
    from redisson_tpu_torch.serve.resp import _encode_array

    vals = list(range(50)) + [-3, 10**12]
    expect = b"*%d\r\n" % len(vals) + b"".join(b":%d\r\n" % v for v in vals)
    assert _encode_array(vals) == expect
    # Mixed arrays keep the general path.
    assert _encode_array([1, b"x"]) == b"*2\r\n:1\r\n$1\r\nx\r\n"


def test_encode_ints(parser):
    vals = [0, 1, -1, 42, -42, 10**17, -(10**17)]
    assert parser.encode_ints(vals) == b"".join(
        b":%d\r\n" % v for v in vals
    )


def _reader_pair():
    a, b = socket.socketpair()
    return _Reader(a), a, b


def _drive_reader(payload, chunks, native: bool):
    """Feed ``payload`` to a _Reader in ``chunks``-byte slices; collect
    every command it frames."""
    if native:
        os.environ.pop("RTPU_NO_NATIVE_RESP", None)
    else:
        os.environ["RTPU_NO_NATIVE_RESP"] = "1"
    try:
        reader, a, b = _reader_pair()
        assert (reader._native is not None) == native
    finally:
        os.environ.pop("RTPU_NO_NATIVE_RESP", None)

    def feed():
        for i in range(0, len(payload), chunks):
            b.sendall(payload[i : i + chunks])
        b.shutdown(socket.SHUT_WR)

    t = threading.Thread(target=feed)
    t.start()
    got = []
    while True:
        cmd = reader.read_command()
        if cmd is None:
            break
        got.append(cmd)
    t.join()
    a.close()
    b.close()
    return got


@pytest.mark.parametrize("chunks", [1, 3, 64, 65536])
def test_reader_parity_native_vs_python(parser, chunks):
    rng = random.Random(42)
    cmds = []
    for _ in range(40):
        n = rng.randint(1, 6)
        cmds.append(
            [bytes(rng.randrange(256) for _ in range(rng.randint(0, 40))) for _ in range(n)]
        )
    cmds.append([b"INLINE", b"CMD"])  # sent inline (no * framing)
    payload = b"".join(_wire(c) for c in cmds[:-1]) + b"INLINE CMD\r\n"
    native = _drive_reader(payload, chunks, native=True)
    pure = _drive_reader(payload, chunks, native=False)
    assert native == pure == cmds


def test_reader_fallback_on_malformed(parser):
    # A malformed frame must produce the same outcome on both paths:
    # a typed ProtocolError (the serve loop replies '-ERR Protocol
    # error' and closes — never an unhandled thread crash).
    from redisson_tpu_torch.serve.resp import ProtocolError

    payload = _wire([b"PING"]) + b"*1\r\n$x\r\n"
    for native in (True, False):
        if native:
            os.environ.pop("RTPU_NO_NATIVE_RESP", None)
        else:
            os.environ["RTPU_NO_NATIVE_RESP"] = "1"
        try:
            reader, a, b = _reader_pair()
        finally:
            os.environ.pop("RTPU_NO_NATIVE_RESP", None)
        b.sendall(payload)
        b.shutdown(socket.SHUT_WR)
        assert reader.read_command() == [b"PING"]
        with pytest.raises(ProtocolError):
            reader.read_command()
        a.close()
        b.close()


def test_encode_bulks_native(parser):
    from redisson_tpu_torch.serve.resp import _encode_array, _encode_bulk

    vals = [b"abc", None, b"", b"x" * 4096, None, b"\r\n$5\r\n", b"1",
            b"tail"]
    want = b"".join(
        b"$-1\r\n" if v is None else b"$%d\r\n%s\r\n" % (len(v), v)
        for v in vals
    )
    assert parser.encode_bulks(vals) == want
    # The array encoder rides it for >=8 all-bytes/None items...
    assert _encode_array(vals) == b"*8\r\n" + want
    # ...and still matches the per-item Python path exactly.
    py = b"*8\r\n" + b"".join(_encode_bulk(v) for v in vals)
    assert _encode_array(vals) == py


def test_require_native_guard():
    # The CI job that exercises the native parser sets
    # RTPU_REQUIRE_NATIVE_RESP=1: the suite must FAIL (not silently
    # fall back to the Python parser) when the codec did not build.
    if os.environ.get("RTPU_REQUIRE_NATIVE_RESP"):
        assert get_parser() is not None
        assert native_codec.get_ticker() is not None, (
            "require mode: the tick entry point must be active too"
        )


# -- rtpu_resp_tick: the fused drain loop --------------------------


def test_ticker_drains_frames_and_classifies(parser):
    ticker = native_codec.get_ticker()
    assert ticker is not None, "fresh .so must carry rtpu_resp_tick"
    a, b = socket.socketpair()
    try:
        b.sendall(
            _wire([b"GET", b"k"]) + _wire([b"BF.ADD", b"f", b"x"])
            + _wire([b"PING"])
        )
        a.setblocking(False)
        tbuf = ticker.new_buf()
        out = []
        nread, eof, err = ticker.tick(a.fileno(), tbuf, out)
        assert err == native_codec.PARSE_OK
        assert not eof
        assert [(f, cmd) for f, cmd in out] == [
            (3, [b"GET", b"k"]),
            (1, [b"BF.ADD", b"f", b"x"]),
            (0, [b"PING"]),
        ]
        assert tbuf.have == 0
    finally:
        a.close()
        b.close()


def test_ticker_partial_frame_stays_buffered(parser):
    ticker = native_codec.get_ticker()
    assert ticker is not None
    a, b = socket.socketpair()
    try:
        whole = _wire([b"SET", b"k", b"v"])
        b.sendall(whole[: len(whole) - 3])
        a.setblocking(False)
        tbuf = ticker.new_buf()
        out = []
        ticker.tick(a.fileno(), tbuf, out)
        assert out == [] and tbuf.have == len(whole) - 3
        b.sendall(whole[len(whole) - 3:])
        ticker.tick(a.fileno(), tbuf, out)
        assert out == [(0, [b"SET", b"k", b"v"])]
        assert tbuf.have == 0
    finally:
        a.close()
        b.close()


def test_no_native_tick_env_disables_only_the_ticker(parser, monkeypatch):
    # The A/B lever: RTPU_NO_NATIVE_TICK turns off the fused drain loop
    # while the per-frame parser stays native.
    monkeypatch.setenv("RTPU_NO_NATIVE_TICK", "1")
    assert native_codec.get_ticker() is None
    assert get_parser() is not None


class _HidingLib:
    """A .so proxy that pretends chosen symbols were never exported —
    the stale-library simulation (an old _resp_codec.so with no
    compiler available to rebuild it)."""

    def __init__(self, real, hidden):
        self._real = real
        self._hidden = frozenset(hidden)

    def __getattr__(self, name):
        if name in self._hidden:
            raise AttributeError(name)
        return getattr(self._real, name)


def test_stale_so_missing_tick_symbol_fails_hard(parser, monkeypatch):
    """Satellite: RTPU_REQUIRE_NATIVE_RESP must fail hard — not
    silently drop to the Python drain loop — when the loaded .so
    predates rtpu_resp_tick."""
    stale = type(parser)(parser._lib)  # fresh instance over the same lib
    stale._lib = _HidingLib(parser._lib, ("rtpu_resp_tick",))
    monkeypatch.setattr(native_codec, "get_parser", lambda: stale)
    monkeypatch.delenv("RTPU_NO_NATIVE_TICK", raising=False)
    monkeypatch.delenv("RTPU_NO_NATIVE_RESP", raising=False)
    # Without require mode: quiet degrade to the Python tick loop.
    monkeypatch.delenv("RTPU_REQUIRE_NATIVE_RESP", raising=False)
    assert native_codec.get_ticker() is None
    # With it: a hard error naming the stale symbol.
    monkeypatch.setenv("RTPU_REQUIRE_NATIVE_RESP", "1")
    with pytest.raises(RuntimeError, match="rtpu_resp_tick"):
        native_codec.get_ticker()


def test_stale_so_missing_encode_bulks_fails_hard(parser, monkeypatch):
    """Same contract for rtpu_resp_encode_bulks: parser construction
    refuses a stale .so under require mode, degrades one call without."""
    hidden = _HidingLib(parser._lib, ("rtpu_resp_encode_bulks",))
    monkeypatch.delenv("RTPU_NO_NATIVE_RESP", raising=False)
    monkeypatch.delenv("RTPU_REQUIRE_NATIVE_RESP", raising=False)
    p = type(parser)(hidden)
    assert p._enc_bulks is None  # quiet degrade of that one call
    monkeypatch.setenv("RTPU_REQUIRE_NATIVE_RESP", "1")
    with pytest.raises(RuntimeError, match="rtpu_resp_encode_bulks"):
        type(parser)(hidden)


# -- the port's build against the JAX package's -------------------------------


def test_library_lives_in_build_native(parser):
    """The port builds its copy of the codec under build/native/, named by
    the source's digest, and never writes into the JAX package."""
    path = native_codec.library_path()
    assert path.exists()
    assert path.parent.name == "native" and path.parent.parent.name == "build"
    assert "redisson_tpu_torch" not in str(path.parent)
    src = (path.parents[2] / "redisson_tpu_torch" / "native" / "resp_codec.c").read_bytes()
    ref = (path.parents[2] / "redisson_tpu" / "native" / "resp_codec.c").read_bytes()
    # A copy: the same C code, only its header comment names the loader.
    strip = lambda b: b[b.index(b"#include"):]  # noqa: E731
    assert strip(src) == strip(ref)


def test_frames_equal_the_jax_packages_build(parser):
    """The port's library and the JAX package's frame the same random
    pipelined stream into the same commands and the same error codes."""
    from redisson_tpu.serve import native_codec as jnative

    jparser = jnative.get_parser()
    if jparser is None:  # no compiler: the JAX package degrades silently
        pytest.skip("the JAX package's codec did not build")
    rng = random.Random(7)
    cmds = [[bytes(rng.randrange(256) for _ in range(rng.randint(0, 30)))
             for _ in range(rng.randint(1, 5))] for _ in range(200)]
    buf = b"".join(_wire(c) for c in cmds)
    for cut in (len(buf), len(buf) - 3, len(buf) // 2):
        assert parser.parse(buf[:cut]) == jparser.parse(buf[:cut])
    for bad in (b"*2\r\nPING\r\n", b"*x\r\n", b"PING\r\n"):
        assert parser.parse(bad) == jparser.parse(bad)
    ints = [0, -1, 10**15, 42]
    assert parser.encode_ints(ints) == jparser.encode_ints(ints)
