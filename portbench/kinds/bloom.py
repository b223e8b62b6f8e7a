"""RBloomFilter deployments: ``tenants`` filters, each ``tryInit(n, p)`` and
loaded with ``loaded_keys_per_tenant`` LongCodec keys before the window.

Keys are 64-bit and fall in three disjoint classes by their top two bits:
``loaded`` (0: salt << 48 | tenant << 32 | rank, every rank below the
loaded count added at set-up), ``absent`` (1: never added) and ``fresh``
(2: added by the traffic).  The salt comes from the seed, so each seed
loads other keys.

The comparison.  A filter's row is the OR of its keys' bits whatever the
order calls took, so the reference rebuilds it: the loaded keys (``S0``)
and then every add of the run (``final``).  Answers are bounded by those
two states: a contains is True if all bits are set in ``S0``, False if
one is clear in ``final``; an add reports "newly added" False if all its
bits are set in ``S0``, True if one of its bits is set by no other key.
Loaded keys must read present, absent keys absent except for false
positives that both bounds agree on; in a contains-only mix the two
states are one and every answer is exact.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from portbench.kinds import dumped_row, replica_rows
from portbench.reference.bitmaps import BloomServer, bit_mismatches
from portbench.reference.hashing import bloom_positions, bloom_size, to_i64

ABSENT, FRESH = np.uint64(1 << 62), np.uint64(2 << 62)
LOAD_CALL = 1 << 20  # keys per set-up add call


class Space:
    def __init__(self, cfg: dict, seed: int):
        self.cfg = cfg
        self.n_targets = int(cfg["tenants"])
        self.names = [f"bf{i}" for i in range(self.n_targets)]
        self.dtype = np.uint64
        self.n = int(cfg["expected_insertions"])
        self.p = float(cfg["false_probability"])
        self.m, self.k = bloom_size(self.n, self.p)
        self.loaded = int(cfg["loaded_keys_per_tenant"])
        if self.loaded > 1 << 32 or self.n_targets > 1 << 14:
            raise ValueError("loaded keys or tenants exceed the key layout")
        salt = int(np.random.default_rng([int(seed) % (1 << 64), 7]).integers(0, 1 << 14))
        self.salt = np.uint64(salt) << np.uint64(48)

    def domain(self, source: str) -> int:
        if source == "loaded":
            return self.loaded
        if source in ("absent", "fresh"):
            return 1 << 62
        raise ValueError(f"a Bloom filter has no {source!r} keys")

    def values(self, source: str, target: int, ranks: np.ndarray, out: np.ndarray) -> None:
        """The keys of ``ranks`` (int64, below ``domain(source)``) into ``out``."""
        if source == "loaded":
            tag = self.salt | (np.uint64(target) << np.uint64(32))
        else:
            tag = ABSENT if source == "absent" else FRESH
        np.bitwise_or(ranks.view(np.uint64), tag, out=out)

    def values_t(self, source: str, target: int, ranks):
        """``values`` on a device: the keys' bits in an int64 tensor."""
        if source == "loaded":
            tag = int(self.salt) | (target << 32)
        else:
            tag = 1 << 62 if source == "absent" else -(1 << 63)  # class 2: the sign bit
        return ranks | tag

    def loaded_keys(self, target: int, lo: int = 0, hi: int = None) -> np.ndarray:
        hi = self.loaded if hi is None else hi
        out = np.empty(hi - lo, np.uint64)
        self.values("loaded", target, np.arange(lo, hi, dtype=np.int64), out)
        return out


def client_config(rt, cfg: dict, device: str):
    from redisson_tpu_torch.codecs import LongCodec

    return rt.Config().set_codec(LongCodec(unsigned=True)).use_gpu_sketch(
        device=device, **cfg.get("gpu_sketch", {}))


def _load(space, add, replicate) -> None:
    """Every tenant's loaded keys through ``add(tenant, keys)``, at most 64
    calls outstanding; then ``replicate(tenant)`` where the deployment
    replicates."""
    pending = []
    for t in range(space.n_targets):
        for lo in range(0, space.loaded, LOAD_CALL):
            pending.append(add(t, space.loaded_keys(t, lo, min(space.loaded, lo + LOAD_CALL))))
            if len(pending) >= 64:
                pending.pop(0).result()
    for f in pending:
        f.result()
    if space.cfg.get("replicated"):
        for t in range(space.n_targets):
            if not replicate(t):
                raise RuntimeError(f"{space.names[t]}: set_replicated() refused")


class ProgramApi:
    """The program, through its public client."""

    def __init__(self, client, space: Space):
        self.client, self.space = client, space
        self.handles = [client.get_bloom_filter(n) for n in space.names]

    def setup(self) -> dict:
        sp = self.space
        for h in self.handles:
            if not h.try_init(sp.n, sp.p):
                raise RuntimeError(f"{h.get_name()}: try_init refused")
        sized = [(h.get_size(), h.get_hash_iterations()) for h in self.handles]
        _load(sp, lambda t, keys: self.handles[t].add_all_async(keys),
              lambda t: self.handles[t].set_replicated())
        return {"filters_sized_wrong": (sum(s != (sp.m, sp.k) for s in sized), 0)}

    def issue(self, call):
        h = self.handles[call.target]
        if call.op == "add":
            return h.add_all_async(call.elements)
        if call.op == "contains":
            return h.contains_all_async(call.elements)
        raise ValueError(f"a Bloom filter has no {call.op!r} call")

    def rows(self) -> dict:
        rows = {h.get_name(): [dumped_row(h)] for h in self.handles}
        if self.space.cfg.get("replicated"):
            for name in self.space.names:
                rows[name] += replica_rows(self.client, name)
        return rows


class ServerApi:
    """The reference in the program's place (a control run)."""

    def __init__(self, space: Space, device, variant: str):
        self.space = space
        self.server = BloomServer(space.m, space.k, device, variant)

    def setup(self) -> dict:
        _load(self.space, lambda t, keys: self.server.add(self.space.names[t], keys),
              lambda t: True)
        return {}

    def issue(self, call):
        name = self.space.names[call.target]
        if call.op == "add":
            return self.server.add(name, call.elements)
        return self.server.contains(name, call.elements)

    def rows(self) -> dict:
        return {name: [self.server.row_words(name)] for name in self.space.names}


def _unique_per_key(pos: torch.Tensor) -> torch.Tensor:
    """bool[B, k]: True where a key's position differs from its earlier ones."""
    uniq = torch.ones_like(pos, dtype=torch.bool)
    for i in range(1, pos.shape[1]):
        uniq[:, i] = ~(pos[:, :i] == pos[:, i:i + 1]).any(dim=1)
    return uniq


def check(space: Space, plans, records, rows: dict, device) -> dict:
    dev = torch.device(device)
    m, k = space.m, space.k
    adds, checked = defaultdict(list), defaultdict(list)
    for r in records:
        if r.op == "add":
            adds[r.target].append(r)
        if r.answer is not None:
            checked[r.target].append(r)

    def keys_of(recs):
        return torch.cat([plans[r.client].elements_on(r.number, dev) for r in recs])

    def answers_of(recs):
        """The calls' answers, or None where one has the wrong length."""
        if any(r.answer.shape != (r.n,) for r in recs):
            return None
        return torch.from_numpy(np.concatenate([r.answer for r in recs])).to(dev)

    wrong = ambiguous = answered = row_bits = 0
    for t, name in enumerate(space.names):
        s0 = torch.zeros(m, dtype=torch.bool, device=dev)
        loaded_pos = []
        add_checked = any(r.op == "add" for r in checked[t])
        for lo in range(0, space.loaded, LOAD_CALL):
            keys = to_i64(space.loaded_keys(t, lo, min(space.loaded, lo + LOAD_CALL))).to(dev)
            pos = bloom_positions(keys, m, k)
            s0[pos.reshape(-1)] = True
            if add_checked:
                loaded_pos.append(pos)
        final = s0.clone()
        add_pos = bloom_positions(keys_of(adds[t]), m, k) if adds[t] else None
        if add_pos is not None:
            final[add_pos.reshape(-1)] = True
        for row in rows[name]:
            row_bits += bit_mismatches(row, final)
        for op in ("contains", "add"):
            recs = [r for r in checked[t] if r.op == op]
            if not recs:
                continue
            n = sum(r.n for r in recs)
            answered += n
            ans = answers_of(recs)
            if ans is None:
                wrong += n
                continue
            pos = bloom_positions(keys_of(recs), m, k)
            if op == "contains":
                lo_b, hi_b = s0[pos].all(dim=1), final[pos].all(dim=1)
                ambiguous += int((lo_b != hi_b).sum())
                wrong += int(((ans & ~hi_b) | (~ans & lo_b)).sum())
                continue
            # Keys covering each bit, each key counted once per bit.
            counts = torch.zeros(m, dtype=torch.int32, device=dev)
            for p in loaded_pos + [add_pos]:
                u = _unique_per_key(p)
                counts.index_put_((p[u],), torch.ones(int(u.sum()), dtype=torch.int32,
                                                      device=dev), accumulate=True)
            u = _unique_per_key(pos)
            must_false = s0[pos].all(dim=1)
            must_true = ((counts[pos] == 1) & u).any(dim=1)
            ambiguous += int((~must_false & ~must_true).sum())
            wrong += int(((ans & must_false) | (~ans & must_true)).sum())
    return {
        "wrong_answers": (wrong, 0),
        "row_bits_wrong": (row_bits, 0),
        "answers_checked": (answered, None),
        "answers_order_dependent": (ambiguous, None),
    }


def element_bytes(space: Space, op: str) -> float:
    """8 B of key, k words of 4 B read (and written, for an add), 1 bit of
    answer."""
    words = space.k * (2 if op == "add" else 1)
    return 8 + 4 * words + 1 / 8


def element_ops(space: Space, op: str) -> float:
    """MurmurHash3 x86_128 of one 16-byte block (92 32-bit operations:
    4 x 11 in the block mix, 4 x 8 in fmix, 16 adds and xors), the two
    64-bit reductions and 3 per position (a multiply, an add, a
    modulo), each counted once."""
    return 92 + 2 + 3 * space.k
