"""RCountMinSketch deployments: one sketch ``try_init(depth, width,
track_top_k)`` fed a stream of LongCodec event keys through
``add_all_seq``, and read with ``top_k(10)``.

Keys.  The stream carries ``keys`` distinct keys; rank ``i`` (rank 0 the
most frequent under a zipf mix) is the key ``i * A + salt mod 2**64``,
with ``A`` odd, so the hot keys are scattered over 64 bits and the map
inverts; the salt comes from the seed, so each seed streams other keys.

The comparison.  Counters only grow, so an estimate lies between two
states the reference rebuilds from the calls' times: a lower one holding
every add call that had completed before the checked call was issued, and
an upper one holding every add call issued before it completed (the
checked call itself left out).  Within an ``add_all_seq`` call each event
adds its own earlier events of the call, its own update included (the
estimate at its sequence point).  A ``top_k`` count lies between the two
states' estimates of its key.  After the window the sketch read back
through ``dump()`` must equal the count-min of every event of every call,
warm-up included, ``total_count()`` the events sent, and the final
``top_k(10)`` the ten keys with the largest true counts, with the final
estimates of those keys, where the gap between the tenth and the eleventh
count exceeds the sketch's error bound e/w times the events (the sketch
cannot be asked to rank keys closer than that).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.kinds import dumped_row
from portbench.reference.cms import (
    CmsServer, Done, add, cell_mismatches, cells, estimate, occurrences)
from portbench.reference.hashing import to_i64

NAME = "cms0"
A = 0x9E3779B97F4A7C15  # odd: rank -> key is a bijection mod 2**64
A_INV = pow(A, -1, 1 << 64)
TOP = 10  # the benchmark's top_k(10)


def _i64(x: int) -> int:
    """A uint64 as the int64 of the same bits."""
    return x - (1 << 64) if x >= 1 << 63 else x


class Space:
    def __init__(self, cfg: dict, seed: int):
        self.cfg = cfg
        self.n_targets = 1
        self.names = [NAME]
        self.dtype = np.uint64
        self.d, self.w = int(cfg["depth"]), int(cfg["width"])
        self.track = int(cfg["track_top_k"])
        self.keys = int(cfg["keys"])
        salt = int(np.random.default_rng([int(seed) % (1 << 64), 5]).integers(0, 1 << 63))
        self.salt = salt

    def domain(self, source: str) -> int:
        if source != "stream":
            raise ValueError(f"a count-min stream has no {source!r} keys")
        return self.keys

    def values(self, source: str, target: int, ranks: np.ndarray, out: np.ndarray) -> None:
        np.multiply(ranks.view(np.uint64), np.uint64(A), out=out)
        np.add(out, np.uint64(self.salt), out=out)

    def values_t(self, source: str, target: int, ranks):
        return ranks * _i64(A) + self.salt

    def ranks_t(self, keys):
        """The ranks of keys made by ``values_t``."""
        return (keys - self.salt) * _i64(A_INV)

    def all_keys(self) -> np.ndarray:
        out = np.empty(self.keys, np.uint64)
        self.values("stream", 0, np.arange(self.keys, dtype=np.int64), out)
        return out


def client_config(rt, cfg: dict, device: str):
    from redisson_tpu_torch.codecs import LongCodec

    return rt.Config().set_codec(LongCodec(unsigned=True)).use_gpu_sketch(
        device=device, **cfg.get("gpu_sketch", {}))


class _Kept:
    """Answers kept for the comparison: the checked ``add_seq`` calls'
    estimates and every ``topk`` call's list, by ``(client, call)``."""

    def __init__(self):
        self.estimates: dict = {}
        self.topks: dict = {}

    def keep(self, call, value):
        if call.op == "topk":
            self.topks[(call.client, call.number)] = list(value)
        elif call.check:
            self.estimates[(call.client, call.number)] = np.array(value, copy=True)
        return Done(value)


class ProgramApi:
    """The program, through its public client."""

    def __init__(self, client, space: Space):
        self.client, self.space = client, space
        self.handle = client.get_count_min_sketch(NAME)
        self.kept = _Kept()

    def setup(self) -> dict:
        sp, h = self.space, self.handle
        if not h.try_init(sp.d, sp.w, track_top_k=sp.track):
            raise RuntimeError(f"{NAME}: try_init refused")
        sized = int(h.get_depth() != sp.d) + int(h.get_width() != sp.w)
        # The warm-up's calls are all adds (a mix's topk comes every 64th
        # call): warm the path top_k re-estimates its candidates on, at
        # the table's sizes (up to twice its cap of 4 * max(k, 16)).
        # Estimates add nothing to the sketch.
        keys = sp.all_keys()
        for n in (1, 16, 64, 128, 8 * max(sp.track, 16)):
            h.estimate_all(keys[:n])
        return {"sketch_sized_wrong": (sized, 0)}

    def issue(self, call):
        if call.op == "add_seq":
            return self.kept.keep(call, self.handle.add_all_seq(call.elements))
        if call.op == "topk":
            return self.kept.keep(call, self.handle.top_k(TOP))
        raise ValueError(f"a count-min sketch has no {call.op!r} call")

    def rows(self) -> dict:
        h = self.handle
        return {"row": dumped_row(h), "total": int(h.total_count()), "final_topk": h.top_k(TOP),
                "kept": self.kept}


class ServerApi:
    """The reference in the program's place (a control run)."""

    def __init__(self, space: Space, device, variant: str):
        self.space = space
        self.server = CmsServer(space.d, space.w, device, variant)
        self.kept = _Kept()
        self._all = space.all_keys()

    def setup(self) -> dict:
        return {}

    def issue(self, call):
        if call.op == "add_seq":
            return self.kept.keep(call, self.server.add_seq(call.elements).result())
        return self.kept.keep(call, self.server.top_k(self._all, TOP))

    def rows(self) -> dict:
        return {"row": self.server.row_words(), "total": self.server.count,
                "final_topk": self.server.top_k(self._all, TOP), "kept": self.kept}


def _answer_t(est, n: int, dev):
    """A call's returned estimates as int64 uint32 values, or None where
    they are not ``n`` numbers."""
    a = np.asarray(est)
    if a.shape != (n,):
        return None
    return torch.from_numpy(a.astype(np.int64) & 0xFFFFFFFF).to(dev)


def _topk_keys(answer, dev):
    keys = np.asarray([k for k, _ in answer], dtype=np.uint64)
    counts = torch.tensor([int(c) for _, c in answer], dtype=torch.int64, device=dev)
    return to_i64(keys).to(dev), counts


class _Prefetch:
    """The adds' keys, made from the seed on host threads ahead of their
    use, in the order the adds were issued (the generator's zipf draw is
    the comparison's longest host step)."""

    AHEAD = 64

    def __init__(self, plans, order, dev):
        from concurrent.futures import ThreadPoolExecutor

        self.plans, self.order, self.dev = plans, order, dev
        self.pool = ThreadPoolExecutor(4)
        self.futs: dict = {}
        self.next = 0

    def __call__(self, r):
        key = (r.client, r.number)
        while self.next < len(self.order) and (key not in self.futs
                                               or len(self.futs) < self.AHEAD):
            q = self.order[self.next]
            self.next += 1
            self.futs[(q.client, q.number)] = self.pool.submit(
                self.plans[q.client].elements_on, q.number, "cpu")
        fut = self.futs.pop(key, None)
        keys = fut.result() if fut is not None else \
            self.plans[r.client].elements_on(r.number, "cpu")
        return keys.to(self.dev)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.pool.shutdown(wait=True, cancel_futures=True)


class _States:
    """The lower and upper states and every key's true count.  An add's
    events join them in a batch at the next read (the tables are sums, so
    the order of the adds between two reads does not matter): one hash
    and one scatter per row over the batch, not per call."""

    def __init__(self, space: Space, dev):
        self.space = space
        shape = (space.d, space.w)
        self.low = torch.zeros(shape, dtype=torch.int64, device=dev)
        self.high = torch.zeros(shape, dtype=torch.int64, device=dev)
        self.true = torch.zeros(space.keys, dtype=torch.int64, device=dev)
        self.issued: list = []  # (call, keys) to join the upper state
        self.done: list = []  # calls to join the lower state
        self.cells: dict = {}  # call -> its cells, from its issue to its end

    def issue(self, key, keys) -> None:
        self.issued.append((key, keys))

    def finish(self, key) -> None:
        self.done.append(key)

    def flush(self) -> None:
        sp = self.space
        if self.issued:
            keys = torch.cat([k for _, k in self.issued])
            c = cells(keys, sp.d, sp.w)
            add(self.high, c)
            self.true += torch.bincount(sp.ranks_t(keys), minlength=sp.keys)
            parts = torch.split(c, [k.numel() for _, k in self.issued])
            for (key, _), part in zip(self.issued, parts):
                self.cells[key] = part
            self.issued.clear()
        if self.done:
            add(self.low, torch.cat([self.cells.pop(k) for k in self.done]))
            self.done.clear()


def check(space: Space, plans, records, rows: dict, device) -> dict:
    dev = torch.device(device)
    d, w = space.d, space.w
    kept = rows["kept"]
    adds = [r for r in records if r.op == "add_seq" and r.n > 0]
    reads = [r for r in records if (r.client, r.number) in kept.estimates
             or (r.client, r.number) in kept.topks]
    # The timeline: an add joins the upper state when issued and the lower
    # one when done; a checked call reads the lower state when issued and
    # the upper one when done (at equal times reads come first).
    events = []
    for r in adds:
        events.append((r.t_issue, 1, "issue", r))
        events.append((r.t_done, 1, "done", r))
    for r in reads:
        events.append((r.t_issue, 0, "read_lo", r))
        events.append((r.t_done, 0, "read_hi", r))
    events.sort(key=lambda e: (e[0], e[1]))
    st = _States(space, dev)
    made: dict = {}  # keys of a checked add, made when it was read first
    lo_est: dict = {}
    wrong = ambiguous = answered = 0
    with _Prefetch(plans, sorted(adds, key=lambda r: r.t_issue), dev) as keys_of:
        for _, _, what, r in events:
            key = (r.client, r.number)
            if what == "issue":
                keys = made.pop(key, None)
                st.issue(key, keys_of(r) if keys is None else keys)
                continue
            if what == "done":
                st.finish(key)
                continue
            st.flush()
            if key in kept.topks:
                topk = kept.topks[key]
                if not topk:
                    continue
                tk, counts = _topk_keys(topk, dev)
                est = estimate(st.low if what == "read_lo" else st.high, cells(tk, d, w))
                if what == "read_lo":
                    lo_est[key] = est
                    continue
                answered += len(topk)
                lo = lo_est.pop(key)
                ambiguous += int((lo != est).sum())
                wrong += int(((counts < lo) | (counts > est)).sum()) + max(0, len(topk) - TOP)
                continue
            if key in st.cells:
                c = st.cells[key]
            else:
                made[key] = keys_of(r)  # a checked call is an add
                c = cells(made[key], d, w)
            before, total = occurrences(c)
            if what == "read_lo":
                lo_est[key] = estimate(st.low, c, before)
                continue
            hi = estimate(st.high, c, before - total)
            lo = lo_est.pop(key)
            answered += r.n
            ans = _answer_t(kept.estimates[key], r.n, dev)
            if ans is None:
                wrong += r.n
                continue
            ambiguous += int((lo != hi).sum())
            wrong += int(((ans < lo) | (ans > hi)).sum())
    st.flush()
    low, true = st.low, st.true
    cells_wrong = cell_mismatches(rows["row"], low)
    sent = sum(r.n for r in adds)
    # The final top_k: the exact top ten by true counts, where the sketch
    # can rank them, and the final estimates of the keys returned.
    final = rows["final_topk"]
    top = torch.topk(true, TOP + 1).values.cpu().numpy()
    n_events = int(true.sum())
    eps_n = math.e / w * n_events
    gap = int(top[TOP - 1] - top[TOP])
    topk_wrong = 0
    if final:
        tk, counts = _topk_keys(final, dev)
        topk_wrong += int((counts != estimate(low, cells(tk, d, w))).sum())
    if gap > eps_n:
        want = set(torch.topk(true, TOP).indices.cpu().tolist())
        got = set()
        if final:
            got = set(space.ranks_t(_topk_keys(final, dev)[0]).cpu().tolist())
        topk_wrong += len(want - got)
    return {
        "wrong_answers": (wrong, 0),
        "cells_wrong": (cells_wrong, 0),
        "count_wrong": (abs(int(rows["total"]) - sent), 0),
        "topk_wrong": (topk_wrong, 0),
        "answers_checked": (answered, None),
        "answers_order_dependent": (ambiguous, None),
        "topk_gap_over_eps_n": (round(gap / eps_n, 3) if eps_n > 0 else None, None),
    }


def element_bytes(space: Space, op: str) -> float:
    """Per ``add_seq`` event: 12 B of op columns in (two cell halves and a
    weight, 4 B each) and a 4 B estimate out, plus the table read and
    written once per launch of ``SEQ_CALL`` events (8 d w / SEQ_CALL B).
    A ``topk`` call carries no events."""
    if op != "add_seq":
        return 0.0
    return 16 + 8 * space.d * space.w / SEQ_CALL


def element_ops(space: Space, op: str) -> float:
    """Per ``add_seq`` event and row: the cell index (an add and a
    conditional subtract), the counter's add and the running minimum (the
    hash runs on the host)."""
    if op != "add_seq":
        return 0.0
    return 4.0 * space.d


# Events per launch: the program's sequential chunk and the mix's call.
SEQ_CALL = 1 << 15
