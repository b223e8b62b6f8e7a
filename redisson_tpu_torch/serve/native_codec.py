"""ctypes loader for the native RESP codec (native/resp_codec.c), the
port's own copy of the JAX package's ``serve/native_codec.py``.

Build-on-first-use: the shared object compiles with the system C
compiler into ``build/native/`` at the repository root, named by a digest
of the source (an edited source never loads a stale library), and is
published tmp -> fsync -> rename like the CUDA kernels of ``ops/_build``.
Every consumer degrades to the pure-Python parser when no compiler is
available — the native path is a performance tier, not a dependency —
unless ``RTPU_REQUIRE_NATIVE_RESP`` is set, which turns every silent
degrade (no compiler, a library missing a symbol) into an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

from redisson_tpu_torch.analysis import witness as _witness

_SRC = Path(__file__).resolve().parent.parent / "native" / "resp_codec.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_CFLAGS = ("-O2", "-shared", "-fPIC")


def library_path() -> Path:
    """``build/native/_resp_codec-<digest>.so`` for the current source."""
    digest = hashlib.sha256(
        _SRC.read_bytes() + " ".join(_CFLAGS).encode()
    ).hexdigest()
    return BUILD_DIR / f"_resp_codec-{digest[:12]}.so"


# err codes from rtpu_resp_parse
PARSE_OK = 0
PARSE_PROTO_ERROR = 1
PARSE_FALLBACK = 2

# Per-tick byte budget of the native drain loop (mirrors the Python
# reactor's recv budget — one connection cannot monopolize a tick).
TICK_READ_BUDGET = 1 << 20

_lock = _witness.named(threading.Lock(), "serve.native_codec")
_parser: Optional["NativeRespParser"] = None
_load_failed = False


def _required() -> bool:
    """RTPU_REQUIRE_NATIVE_RESP turns every silent degrade of the native
    tier into a hard failure: parser load failure AND a stale .so missing
    rtpu_resp_tick / rtpu_resp_encode_bulks all raise instead of quietly
    dropping to Python.  An explicit RTPU_NO_NATIVE_RESP opt-out wins
    (tests that deliberately exercise the Python path)."""
    return bool(os.environ.get("RTPU_REQUIRE_NATIVE_RESP")) and not os.environ.get(
        "RTPU_NO_NATIVE_RESP"
    )


def _publish_file(tmp: Path, final: Path) -> None:
    """tmp -> final, durably: fsync the bytes before the rename and the
    directory after it, so a crash never publishes a torn library (a
    dlopen of one can crash the process instead of degrading)."""
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, final)
    fd = os.open(final.parent, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _build() -> bool:
    so = library_path()
    if so.exists():
        return True
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Per-process tmp name: concurrent builders (pytest workers, child
    # servers) must not publish each other's half-written library.
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    for cc in ("cc", "gcc", "g++", "clang"):
        try:
            r = subprocess.run(
                [cc, *_CFLAGS, str(_SRC), "-o", str(tmp)],
                capture_output=True,
                timeout=60,
            )
        except (OSError, subprocess.TimeoutExpired):
            continue
        if r.returncode == 0:
            _publish_file(tmp, so)
            return True
    return False


class NativeRespParser:
    """Batch frame parser: ``parse(buf)`` returns
    ``(frames, consumed, err)`` where frames is a list of arg-lists
    (bytes), consumed counts the bytes those frames occupy, and err is
    one of the PARSE_* codes describing why parsing stopped."""

    MAX_FRAMES = 1 << 10
    MAX_ARGS = 1 << 13

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        self._fn = lib.rtpu_resp_parse
        self._fn.restype = ctypes.c_long
        L = ctypes.c_long
        self._fn.argtypes = [
            ctypes.c_char_p, L, L, L,
            ctypes.POINTER(L), ctypes.POINTER(L), ctypes.POINTER(L),
            ctypes.POINTER(L), ctypes.POINTER(L),
        ]
        self._enc = lib.rtpu_resp_encode_ints
        self._enc.restype = ctypes.c_long
        self._enc.argtypes = [ctypes.POINTER(L), L, ctypes.c_char_p, L]
        # Batch bulk-reply encoder (fused GET/MGET runs, container
        # reads).  getattr-guarded: a stale .so without the symbol (no
        # compiler to rebuild) must degrade this one call, not unload
        # the whole parser.
        self._enc_bulks = getattr(lib, "rtpu_resp_encode_bulks", None)
        if self._enc_bulks is None and _required():
            raise RuntimeError(
                "RTPU_REQUIRE_NATIVE_RESP: loaded _resp_codec.so is stale — "
                "rtpu_resp_encode_bulks is missing (rebuild requires a C compiler)"
            )
        if self._enc_bulks is not None:
            self._enc_bulks.restype = ctypes.c_long
            self._enc_bulks.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(L), ctypes.POINTER(L), L,
                ctypes.c_char_p, L,
            ]
        self._counts = (L * self.MAX_FRAMES)()
        self._offs = (L * self.MAX_ARGS)()
        self._lens = (L * self.MAX_ARGS)()
        self._consumed = L()
        self._err = L()

    def parse(self, buf: bytes):
        n = self._fn(
            buf, len(buf), self.MAX_FRAMES, self.MAX_ARGS,
            self._counts, self._offs, self._lens,
            ctypes.byref(self._consumed), ctypes.byref(self._err),
        )
        frames = []
        a = 0
        offs, lens, counts = self._offs, self._lens, self._counts
        for f in range(n):
            c = counts[f]
            frames.append(
                [buf[offs[a + i] : offs[a + i] + lens[a + i]] for i in range(c)]
            )
            a += c
        return frames, self._consumed.value, self._err.value

    def encode_ints(self, vals) -> bytes:
        L = ctypes.c_long
        n = len(vals)
        arr = (L * n)(*vals)
        cap = 26 * n
        out = ctypes.create_string_buffer(cap)
        w = self._enc(arr, n, out, cap)
        if w < 0:  # pragma: no cover — cap is sized to the worst case
            raise ValueError("encode buffer overflow")
        return out.raw[:w]

    def encode_bulks(self, vals) -> Optional[bytes]:
        """Serialize ``vals`` (bytes or None per item) as concatenated
        RESP bulk-string replies in ONE native call; None when the loaded
        .so predates the symbol (caller keeps its Python path)."""
        if self._enc_bulks is None:
            return None
        L = ctypes.c_long
        n = len(vals)
        offs = (L * n)()
        lens = (L * n)()
        parts = []
        off = 0
        for i, v in enumerate(vals):
            if v is None:
                lens[i] = -1
            else:
                parts.append(v)
                offs[i] = off
                lens[i] = len(v)
                off += len(v)
        payload = b"".join(parts)
        cap = off + 26 * n
        out = ctypes.create_string_buffer(cap)
        w = self._enc_bulks(payload, offs, lens, n, out, cap)
        if w < 0:  # pragma: no cover — cap is sized to the worst case
            raise ValueError("encode buffer overflow")
        return out.raw[:w]


def _fail(reason: str) -> None:
    if _required():
        raise RuntimeError(f"RTPU_REQUIRE_NATIVE_RESP: {reason}")


def get_parser() -> Optional[NativeRespParser]:
    """Per-connection consumers each get their OWN parser instance
    (the descriptor arrays are per-instance scratch); this returns a
    template whose lib handle they share, or None when unavailable."""
    global _parser, _load_failed
    if os.environ.get("RTPU_NO_NATIVE_RESP"):
        return None
    if _parser is not None:
        return NativeRespParser(_parser._lib)
    if _load_failed:
        _fail("native RESP codec previously failed to load")
        return None
    with _lock:
        if _parser is not None:
            return NativeRespParser(_parser._lib)
        if _load_failed:
            _fail("native RESP codec previously failed to load")
            return None
        try:
            if not _build():
                _load_failed = True
                _fail("no C compiler available to build _resp_codec.so")
                return None
            lib = ctypes.CDLL(str(library_path()))
            _parser = NativeRespParser(lib)
        except RuntimeError:
            _load_failed = True
            raise
        except (OSError, AttributeError):
            # AttributeError: the .so built but exports mangled/missing
            # symbols (e.g. compiled as C++ without extern "C") — degrade
            # to the Python parser instead of crashing every connection.
            _load_failed = True
            _fail("_resp_codec.so failed to load or is missing symbols")
            return None
    return NativeRespParser(_parser._lib)


class TickBuf:
    """Per-connection leftover buffer for :class:`NativeTicker` — starts
    tiny (idle connections are the common case at scale) and doubles when
    a single frame outgrows it."""

    INITIAL = 1 << 12
    # A hair over proto-max-bulk-len: one 512MB bulk plus framing always
    # fits; a frame that does not (multi-bulk gigabytes) falls back to
    # the unbounded Python framer.
    MAX = (1 << 29) + (1 << 16)

    __slots__ = ("buf", "cap", "have")

    def __init__(self):
        self.cap = self.INITIAL
        self.buf = ctypes.create_string_buffer(self.cap)
        self.have = 0

    def grow(self) -> bool:
        if self.cap >= self.MAX:
            return False
        ncap = min(self.cap * 2, self.MAX)
        nbuf = ctypes.create_string_buffer(ncap)
        ctypes.memmove(nbuf, self.buf, self.have)
        self.buf, self.cap = nbuf, ncap
        return True

    def take(self) -> bytes:
        """Drain the leftover bytes (handing a connection over to the
        slow-path framer)."""
        out = bytes(memoryview(self.buf)[: self.have])
        self.have = 0
        return out


class NativeTicker:
    """The native per-tick hot loop (rtpu_resp_tick): one readable-fd
    drain + RESP frame parse + per-frame family classification in a
    single ctypes call, leaving Python only dispatch decisions.

    One instance per reactor THREAD — the descriptor arrays are shared
    scratch, extracted before the next call; only the leftover bytes
    (:class:`TickBuf`) are per-connection state.
    """

    MAX_FRAMES = NativeRespParser.MAX_FRAMES
    MAX_ARGS = NativeRespParser.MAX_ARGS

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        L = ctypes.c_long
        self._fn = lib.rtpu_resp_tick
        self._fn.restype = L
        self._fn.argtypes = [
            L, ctypes.c_void_p, L, L, L, L, L,
            ctypes.POINTER(L), ctypes.POINTER(L), ctypes.POINTER(L),
            ctypes.POINTER(L), ctypes.POINTER(L), ctypes.POINTER(L),
            ctypes.POINTER(L), ctypes.POINTER(L),
        ]
        self._counts = (L * self.MAX_FRAMES)()
        self._offs = (L * self.MAX_ARGS)()
        self._lens = (L * self.MAX_ARGS)()
        self._fams = (L * self.MAX_FRAMES)()
        self._consumed = L()
        self._nread = L()
        self._eof = L()
        self._err = L()

    def new_buf(self) -> TickBuf:
        return TickBuf()

    def tick(self, fd: int, tbuf: TickBuf, out) -> tuple:
        """Drain ``fd`` and append ``(family, argv)`` tuples to ``out``.

        Returns ``(nread, eof, err)``.  err != PARSE_OK means the
        connection must fall back to the slow-path framer: feed it
        ``tbuf.take()`` and retire the tick path for this connection.
        The read budget caps BYTES READ per tick, never parsing — every
        complete frame already buffered is always surfaced (a frame left
        unparsed with no further bytes coming would hang, since the
        selector only fires on new readability).
        """
        total = 0
        eof = 0
        counts, offs, lens, fams = self._counts, self._offs, self._lens, self._fams
        while True:
            rem = TICK_READ_BUDGET - total
            if rem < 0:
                rem = 0
            n = self._fn(
                fd, tbuf.buf, tbuf.cap, tbuf.have, rem,
                self.MAX_FRAMES, self.MAX_ARGS,
                counts, offs, lens, fams,
                ctypes.byref(self._consumed), ctypes.byref(self._nread),
                ctypes.byref(self._eof), ctypes.byref(self._err),
            )
            have = tbuf.have + self._nread.value
            total += self._nread.value
            err = self._err.value
            mv = memoryview(tbuf.buf)
            a = 0
            for f in range(n):
                c = counts[f]
                out.append(
                    (
                        fams[f],
                        [
                            bytes(mv[offs[a + i] : offs[a + i] + lens[a + i]])
                            for i in range(c)
                        ],
                    )
                )
                a += c
            mv.release()
            consumed = self._consumed.value
            left = have - consumed
            if left and consumed:
                ctypes.memmove(tbuf.buf, ctypes.byref(tbuf.buf, consumed), left)
            tbuf.have = left
            if self._eof.value:
                eof = 1
            if err != PARSE_OK:
                return total, eof, err
            if n == 0:
                if left == tbuf.cap and not eof:
                    # One frame larger than the buffer: grow and re-drain.
                    if not tbuf.grow():
                        return total, eof, PARSE_FALLBACK
                    continue
                return total, eof, PARSE_OK
            # n > 0: the descriptor caps may have cut off complete frames
            # still in the leftover — loop until a scan yields nothing.


def get_ticker() -> Optional[NativeTicker]:
    """A :class:`NativeTicker` bound to the loaded library, or None (no
    compiler, RTPU_NO_NATIVE_RESP / RTPU_NO_NATIVE_TICK opt-outs, or the
    .so predates rtpu_resp_tick).  RTPU_NO_NATIVE_TICK exists for the
    native-tick A/B arm: it disables only the fused drain loop while the
    per-frame parser stays native."""
    if os.environ.get("RTPU_NO_NATIVE_TICK"):
        return None
    p = get_parser()
    if p is None:
        return None
    if getattr(p._lib, "rtpu_resp_tick", None) is None:
        _fail("loaded _resp_codec.so is stale — rtpu_resp_tick is missing")
        return None
    return NativeTicker(p._lib)
