/* RESP2 wire codec — the native hot loop of the front door.
 *
 * Role parity: org/redisson/client/handler/CommandDecoder (the reference
 * decodes RESP frames inside Netty's native-transport event loop; this
 * framework's serving tier is Python, so the per-byte frame scan is the
 * one place the host language binds — SURVEY.md §7 stance: native code
 * where the Python host loop is the measured bottleneck).
 *
 * One call parses as many COMPLETE pipelined command frames
 * (`*N\r\n` followed by N `$len\r\n<bytes>\r\n` bulks) as fit the caller's
 * descriptor capacity, writing per-argument (offset, length) descriptors
 * into flat arrays — zero copies; Python slices the argument bytes out of
 * its own buffer afterwards.
 *
 * Exit conditions (err):
 *   0 — clean stop: out of complete frames, or descriptor capacity hit.
 *   1 — protocol error at byte *consumed (caller: surface/close).
 *   2 — frame does not start with '*' (inline command etc.): caller
 *       falls back to the slow-path parser for this frame.
 * Frames already parsed before the stop are always valid; *consumed is
 * the exact byte count they occupy.
 *
 * Build: cc -O2 -shared -fPIC resp_codec.c -o _resp_codec.so
 * (loaded via ctypes — redisson_tpu_torch/serve/native_codec.py).
 */

#include <errno.h>
#include <stdint.h>
#include <string.h>
#include <unistd.h>

/* The build probes cc/gcc/g++/clang in order; under a C++ compiler the
 * symbols must not mangle (ctypes looks them up by C name). */
#ifdef __cplusplus
extern "C" {
#endif

/* Family classification for the reactor's merged window (must mirror
 * _Reactor._family_key in serve/reactor.py): commands of one fusable
 * family chunk together inside a dispatch round.  Returns the family
 * class only — the grouping OBJECT (argv[1]) is already a parsed
 * descriptor on the Python side. */
static long rtpu_classify(const unsigned char *p, long n)
{
    unsigned char u[10];
    if (n < 3 || n > 10)
        return 0;
    for (long i = 0; i < n; i++) {
        unsigned char c = p[i];
        if (c >= 'a' && c <= 'z')
            c = (unsigned char)(c - 32);
        u[i] = c;
    }
    switch (n) {
    case 3:
        if (!memcmp(u, "GET", 3))
            return 3;
        break;
    case 4:
        if (!memcmp(u, "MGET", 4))
            return 3;
        break;
    case 6:
        if (!memcmp(u, "BF.ADD", 6))
            return 1;
        if (!memcmp(u, "SETBIT", 6) || !memcmp(u, "GETBIT", 6))
            return 2;
        break;
    case 7:
        if (!memcmp(u, "BF.MADD", 7))
            return 1;
        break;
    case 9:
        if (!memcmp(u, "BF.EXISTS", 9))
            return 1;
        if (!memcmp(u, "CMS.QUERY", 9))
            return 4;
        break;
    case 10:
        if (!memcmp(u, "BF.MEXISTS", 10))
            return 1;
        break;
    }
    return 0;
}

/* Shared frame scan: rtpu_resp_parse with an optional per-frame family
 * output (fams != 0 additionally classifies argv[0] of every complete
 * frame — the run-detection half of the tick loop). */
static long rtpu_parse_core(const unsigned char *buf, long len,
                            long max_frames, long max_args_total,
                            long *counts, long *offs, long *lens,
                            long *fams, long *consumed, long *err)
{
    long pos = 0, nframes = 0, nargs = 0;
    *err = 0;
    while (nframes < max_frames) {
        long p = pos;
        if (p >= len)
            break;
        if (buf[p] != '*') {
            *err = 2;
            break;
        }
        /* *N\r\n header */
        long q = p + 1, n = 0, digs = 0;
        while (q < len && buf[q] >= '0' && buf[q] <= '9') {
            n = n * 10 + (buf[q] - '0');
            q++;
            digs++;
            if (n > 1024 * 1024) { /* argv cap, matches Redis proto limit */
                *err = 1;
                goto out;
            }
        }
        if (q + 1 >= len)
            break; /* incomplete header */
        if (digs == 0 || buf[q] != '\r' || buf[q + 1] != '\n') {
            *err = 1;
            break;
        }
        q += 2;
        if (nargs + n > max_args_total) {
            /* Descriptor capacity: stop BEFORE this frame.  If it is the
             * FIRST frame, no progress is possible at any buffer size —
             * signal fallback so the caller's slow path (which has no
             * argc capacity) parses it instead of waiting forever. */
            if (nframes == 0)
                *err = 2;
            break;
        }
        long ok = 1;
        for (long i = 0; i < n; i++) {
            if (q >= len) {
                ok = 0;
                break;
            }
            if (buf[q] != '$') {
                *err = 1;
                goto out;
            }
            long r = q + 1, blen = 0, d2 = 0;
            while (r < len && buf[r] >= '0' && buf[r] <= '9') {
                blen = blen * 10 + (buf[r] - '0');
                r++;
                d2++;
                if (blen > 512L * 1024 * 1024) { /* proto-max-bulk-len */
                    *err = 1;
                    goto out;
                }
            }
            if (r + 1 >= len) {
                ok = 0;
                break;
            }
            if (d2 == 0 || buf[r] != '\r' || buf[r + 1] != '\n') {
                *err = 1;
                goto out;
            }
            r += 2;
            if (r + blen + 2 > len) {
                ok = 0;
                break;
            }
            if (buf[r + blen] != '\r' || buf[r + blen + 1] != '\n') {
                *err = 1;
                goto out;
            }
            offs[nargs + i] = r;
            lens[nargs + i] = blen;
            q = r + blen + 2;
        }
        if (!ok)
            break; /* incomplete frame: wait for more bytes */
        counts[nframes] = n;
        if (fams)
            fams[nframes] =
                (n > 0) ? rtpu_classify(buf + offs[nargs], lens[nargs]) : 0;
        nframes++;
        nargs += n;
        pos = q;
    }
out:
    *consumed = pos;
    return nframes;
}

long rtpu_resp_parse(const unsigned char *buf, long len,
                     long max_frames, long max_args_total,
                     long *counts, long *offs, long *lens,
                     long *consumed, long *err)
{
    return rtpu_parse_core(buf, len, max_frames, max_args_total, counts,
                           offs, lens, (long *)0, consumed, err);
}

/* One reactor tick for one readable connection: drain the fd into the
 * caller's buffer (read(2) loop — nonblocking socket), then parse every
 * complete frame AND classify each frame's command family, all in one
 * native call.  Python is left holding only dispatch decisions.
 *
 * In:  buf[0..have) holds leftover bytes from the previous tick; cap is
 *      the buffer capacity; budget caps bytes read this call.
 * Out: *nread    bytes appended by read(2) (buf now holds have+*nread);
 *      *eof      1 when the peer closed (read returned 0) or the socket
 *                errored fatally (anything but EAGAIN/EWOULDBLOCK/EINTR);
 *      *consumed bytes occupied by the returned frames (caller compacts);
 *      *err      as rtpu_resp_parse (0 clean / 1 protocol / 2 fallback).
 * Returns the number of complete frames described in counts/offs/lens,
 * with fams[i] holding each frame's family class.
 *
 * The read loop stops at EAGAIN, at the byte budget, or when the buffer
 * fills (the caller grows it when a single frame exceeds cap). */
long rtpu_resp_tick(long fd, unsigned char *buf, long cap, long have,
                    long budget, long max_frames, long max_args_total,
                    long *counts, long *offs, long *lens, long *fams,
                    long *consumed, long *nread, long *eof, long *err)
{
    long got = 0;
    *eof = 0;
    while (got < budget && have + got < cap) {
        long want = budget - got;
        if (want > cap - (have + got))
            want = cap - (have + got);
        long n = (long)read((int)fd, buf + have + got, (size_t)want);
        if (n > 0) {
            got += n;
            if (n < want)
                break; /* short read: socket drained for now */
            continue;
        }
        if (n == 0) {
            *eof = 1;
            break;
        }
        if (errno == EINTR)
            continue;
        if (errno != EAGAIN && errno != EWOULDBLOCK)
            *eof = 1; /* fatal socket error: treat as peer-gone */
        break;
    }
    *nread = got;
    return rtpu_parse_core(buf, have + got, max_frames, max_args_total,
                           counts, offs, lens, fams, consumed, err);
}

/* Serialize a batch of integer replies (`:n\r\n`) — the common reply shape
 * of SETBIT/SADD/HSET/... pipelines; one call per flush instead of one
 * Python string-build per reply. Returns bytes written, or -1 if the
 * output buffer is too small. */
long rtpu_resp_encode_ints(const long *vals, long n, unsigned char *out,
                           long cap)
{
    long w = 0;
    for (long i = 0; i < n; i++) {
        long v = vals[i];
        unsigned char tmp[24];
        long t = 0, neg = 0;
        if (w + 26 > cap)
            return -1;
        if (v < 0) {
            neg = 1;
            v = -v;
        }
        do {
            tmp[t++] = '0' + (unsigned char)(v % 10);
            v /= 10;
        } while (v);
        out[w++] = ':';
        if (neg)
            out[w++] = '-';
        while (t)
            out[w++] = tmp[--t];
        out[w++] = '\r';
        out[w++] = '\n';
    }
    return w;
}

/* Serialize a batch of bulk-string replies (`$len\r\n<bytes>\r\n`, or
 * `$-1\r\n` for nil when lens[i] < 0) — the common reply shape of fused
 * GET/MGET runs and container reads (HGETALL/LRANGE/SMEMBERS pipelines).
 * Values arrive concatenated in `payload` at (offs[i], lens[i]); one call
 * per reply batch instead of one Python string-build per value.  Returns
 * bytes written, or -1 if the output buffer is too small. */
long rtpu_resp_encode_bulks(const unsigned char *payload, const long *offs,
                            const long *lens, long n, unsigned char *out,
                            long cap)
{
    long w = 0;
    for (long i = 0; i < n; i++) {
        long L = lens[i];
        if (L < 0) {
            if (w + 5 > cap)
                return -1;
            memcpy(out + w, "$-1\r\n", 5);
            w += 5;
            continue;
        }
        /* "$" + <=20 digits + CRLF + payload + CRLF */
        if (w + L + 26 > cap)
            return -1;
        out[w++] = '$';
        unsigned char tmp[24];
        long t = 0, v = L;
        do {
            tmp[t++] = '0' + (unsigned char)(v % 10);
            v /= 10;
        } while (v);
        while (t)
            out[w++] = tmp[--t];
        out[w++] = '\r';
        out[w++] = '\n';
        memcpy(out + w, payload + offs[i], (size_t)L);
        w += L;
        out[w++] = '\r';
        out[w++] = '\n';
    }
    return w;
}

#ifdef __cplusplus
}
#endif
