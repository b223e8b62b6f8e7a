"""RBitSet deployments: one bitset of ``bits`` bits, ``preset_bits``
random bits set at set-up (drawn from the seed), then the traffic's
SETBIT and GETBIT calls on ``uniform`` indexes.

The comparison.  Bits are only ever set, so a bit's value at any instant
lies between two states the reference rebuilds from the calls' times: a
lower one holding the set-up bits and every set call that had completed
before the checked call was issued, and an upper one holding every set
call issued before the checked call completed (the checked call itself
left out).  Within a call Redis's sequential semantics hold: an index
seen earlier in the same set call reads its bit as set.  The bitset read
back at the end must equal the set-up bits and every set call of the
run.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.kinds import dumped_row
from portbench.reference.bitmaps import BitsetServer, bit_mismatches, first_occurrence

NAME = "bs0"
PRESET_CALL = 1 << 21


class Space:
    def __init__(self, cfg: dict, seed: int):
        self.cfg = cfg
        self.n_targets = 1
        self.names = [NAME]
        self.dtype = np.uint32
        self.bits = int(cfg["bits"])
        if self.bits > 1 << 31:
            raise ValueError("bits past 2**31 do not fit the index layout")
        self.seed = int(seed) % (1 << 64)

    def domain(self, source: str) -> int:
        if source != "uniform":
            raise ValueError(f"a bitset has no {source!r} indexes")
        return self.bits

    def values(self, source: str, target: int, ranks: np.ndarray, out: np.ndarray) -> None:
        np.copyto(out, ranks, casting="unsafe")

    def values_t(self, source: str, target: int, ranks):
        return ranks

    def preset(self) -> list:
        rng = np.random.default_rng([self.seed, 11])
        n = int(self.cfg["preset_bits"])
        return [rng.integers(0, self.bits, min(PRESET_CALL, n - lo), dtype=np.int64).astype(np.uint32)
                for lo in range(0, n, PRESET_CALL)]


def client_config(rt, cfg: dict, device: str):
    from redisson_tpu_torch.codecs import LongCodec

    return rt.Config().set_codec(LongCodec(unsigned=True)).use_gpu_sketch(
        device=device, **cfg.get("gpu_sketch", {}))


class ProgramApi:
    def __init__(self, client, space: Space):
        self.client, self.space = client, space
        self.handle = client.get_bit_set(NAME)

    def setup(self) -> dict:
        # The top bit first: the bitset takes its full size at once.
        self.handle.set(self.space.bits - 1)
        futs = [self.handle.set_many_async(idx) for idx in self.space.preset()]
        for f in futs:
            f.result()
        return {}

    def issue(self, call):
        if call.op == "set":
            return self.handle.set_many_async(call.elements)
        if call.op == "get":
            return self.handle.get_many_async(call.elements)
        raise ValueError(f"a bitset has no {call.op!r} call")

    def rows(self) -> dict:
        return {NAME: [dumped_row(self.handle)]}


class ServerApi:
    def __init__(self, space: Space, device, variant: str):
        self.space = space
        self.server = BitsetServer(space.bits, device, variant)

    def setup(self) -> dict:
        self.server.set(NAME, np.asarray([self.space.bits - 1], np.uint32))
        for idx in self.space.preset():
            self.server.set(NAME, idx)
        return {}

    def issue(self, call):
        if call.op == "set":
            return self.server.set(NAME, call.elements)
        return self.server.get(NAME, call.elements)

    def rows(self) -> dict:
        return {NAME: [self.server.row_words(NAME)]}


def check(space: Space, plans, records, rows: dict, device) -> dict:
    dev = torch.device(device)

    def idx_of(r):
        return plans[r.client].elements_on(r.number, dev)

    s0 = torch.zeros(space.bits, dtype=torch.bool, device=dev)
    s0[space.bits - 1] = True
    for idx in space.preset():
        s0[torch.from_numpy(idx.astype(np.int64)).to(dev)] = True
    sets = [r for r in records if r.op == "set"]
    checked = [r for r in records if r.answer is not None]
    # Each set call's indexes, made once; int32 holds every index.
    idx = {id(r): idx_of(r).to(torch.int32) for r in sets}
    for r in checked:
        if id(r) not in idx:
            idx[id(r)] = idx_of(r).to(torch.int32)
    # Lower bounds: sets applied as they complete, read as a checked call
    # is issued.
    low = {}
    state = s0.clone()
    by_done = sorted(sets, key=lambda r: r.t_done)
    i = 0
    for r in sorted(checked, key=lambda r: r.t_issue):
        while i < len(by_done) and by_done[i].t_done < r.t_issue:
            state[idx[id(by_done[i])].long()] = True
            i += 1
        low[id(r)] = state[idx[id(r)].long()]
    del state
    # Upper bounds: sets applied as they are issued (each index once per
    # call), read as a checked call completes, its own set taken out.
    count = s0.to(torch.int16)
    by_issue = sorted(sets, key=lambda r: r.t_issue)
    i = 0
    wrong = ambiguous = answered = 0
    for r in sorted(checked, key=lambda r: r.t_done):
        while i < len(by_issue) and by_issue[i].t_issue < r.t_done:
            u = torch.unique(idx[id(by_issue[i])].long())
            count.index_put_((u,), torch.ones_like(u, dtype=torch.int16), accumulate=True)
            i += 1
        ix = idx[id(r)].long()
        answered += ix.numel()
        if r.answer.shape != (ix.numel(),):
            wrong += ix.numel()
            continue
        ans = torch.from_numpy(r.answer).to(dev)
        hi = count[ix] > (1 if r.op == "set" else 0)
        lo = low[id(r)]
        if r.op == "set":
            earlier = ~first_occurrence(ix)
            lo, hi = lo | earlier, hi | earlier
        ambiguous += int((lo != hi).sum())
        wrong += int(((ans & ~hi) | (~ans & lo)).sum())
    del count
    final = s0
    for r in sets:
        final[idx[id(r)].long()] = True
    row_bits = sum(bit_mismatches(row, final) for row in rows[NAME])
    return {
        "wrong_answers": (wrong, 0),
        "row_bits_wrong": (row_bits, 0),
        "answers_checked": (answered, None),
        "answers_order_dependent": (ambiguous, None),
    }


def element_bytes(space: Space, op: str) -> float:
    """4 B of index, a 4 B word read (and written, for a set), 1 bit of
    answer."""
    return 4 + 4 * (2 if op == "set" else 1) + 1 / 8


def element_ops(space: Space, op: str) -> float:
    """A shift and a mask for the word and bit, a test (and an or)."""
    return 3 + (1 if op == "set" else 0)
