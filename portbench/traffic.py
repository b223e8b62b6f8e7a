"""The one traffic generator: a mix file of parameters in, calls out.

A mix (``portbench/traffic/<mix>.json``) names its ``loop``, the module
under ``portbench/loops/`` that paces the calls (``closed``: ``inflight``
calls outstanding per client; ``open``: calls due on a schedule), and
``clients`` threads that run it, every call carrying ``elements_per_call``
elements.  Each call draws its operation from ``ops``: an op with
``every: N`` takes every N-th call of a client; the others share the rest
by ``weight``, or in turn when ``order`` is ``"alternate"``.  An op may
carry its own ``elements`` (0 for a call with none).  Each call's target
object comes from ``target`` (``uniform`` or ``zipf`` over the
deployment's objects), and its elements from the op's ``parts``, each a
``share`` of the call taken from one ``source`` of the deployment's kind
(a Bloom filter's ``loaded``, ``absent`` and ``fresh`` keys; a BitSet's
``uniform`` indexes) by ``uniform`` or ``zipf`` ranks, with any
``theta`` above 0.  ``warmup_calls`` per client run before the window,
and ``check_share`` of all calls keep their answers for the comparison
with the reference.  Keys beyond these are the loop's own (its ``KEYS``).

Every call is a pure function of ``(seed, client, call number)``, so the
reference regenerates any call's elements after the run.  A uniform part
is a base array drawn once per client plus a per-call offset modulo the
source's size: each call's ranks are uniform, and a call of 2**21
elements costs one vectorised add instead of a fresh draw, which keeps
the load generator's host time out of the program's way.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from portbench import spec

_MIX_KEYS = {"loop", "clients", "inflight", "elements_per_call", "warmup_calls",
             "target", "order", "ops", "check_share", "why"}
_OP_KEYS = {"op", "weight", "parts", "every", "elements"}


def load_mix(path: str, root: str = spec.ROOT) -> dict:
    with open(path) as f:
        mix = json.load(f)
    loop = spec.loop(mix.get("loop", ""), root)
    unknown = set(mix) - _MIX_KEYS - set(loop.KEYS)
    if unknown:
        raise ValueError(f"{path}: unknown keys {sorted(unknown)}")
    if hasattr(loop, "check"):
        loop.check(mix)
    for op in mix["ops"]:
        if set(op) - _OP_KEYS:
            raise ValueError(f"{path}: unknown keys {sorted(set(op) - _OP_KEYS)} in an op")
        if "every" in op and int(op["every"]) < 1:
            raise ValueError(f"{path}: every must be at least 1")
        parts = op.get("parts", [])
        if int(op.get("elements", mix["elements_per_call"])) == 0:
            if parts:
                raise ValueError(f"{path}: {op['op']} has no elements to take parts of")
            continue
        shares = sum(p["share"] for p in parts)
        if not math.isclose(shares, 1.0):
            raise ValueError(f"{path}: parts of {op['op']} share {shares}, not 1")
    if not any("every" not in op for op in mix["ops"]):
        raise ValueError(f"{path}: every op has 'every': no op takes the other calls")
    if mix.get("order", "random") not in ("random", "alternate"):
        raise ValueError(f"{path}: order must be random or alternate")
    return mix


def zeta(n: int, theta: float) -> float:
    """sum_{i=1..n} i**-theta: exact over the first 2**20 terms, the
    midpoint integral beyond (relative error under 1e-12 there)."""
    head = min(n, 1 << 20)
    s = float(np.sum(np.arange(1, head + 1, dtype=np.float64) ** -theta))
    if n > head:
        s += _tail_mass(head + 0.5, n + 0.5, theta)
    return s


def _tail_mass(a: float, b: float, theta: float) -> float:
    """The integral of x**-theta from a to b."""
    if theta == 1.0:
        return math.log(b / a)
    return (b ** (1 - theta) - a ** (1 - theta)) / (1 - theta)


class Zipf:
    """Zipf ranks: rank 0 the most popular of ``n``, P(rank r) proportional
    to (r + 1)**-theta.  Below theta 1 it is YCSB's ZipfianGenerator (Gray
    et al., SIGMOD 1994), as the YCSB workloads draw.  From theta 1 on,
    where that formula does not hold, it inverts the distribution: exactly
    over the first 2**16 ranks, and by the midpoint integral beyond."""

    HEAD = 1 << 16

    def __init__(self, n: int, theta: float):
        self.n, self.theta = int(n), float(theta)
        if not (self.n >= 1 and self.theta > 0):
            raise ValueError("zipf needs n >= 1 and theta > 0")
        if self.theta < 1:
            self.zetan = zeta(self.n, self.theta)
            self.alpha = 1.0 / (1.0 - self.theta)
            self.eta = (1 - (2.0 / self.n) ** (1 - self.theta)) / (
                1 - zeta(2, self.theta) / self.zetan)
            self.half = 1 + 0.5 ** self.theta
            return
        head = min(self.n, self.HEAD)
        self.cum = np.cumsum(np.arange(1, head + 1, dtype=np.float64) ** -self.theta)
        self.a = head + 0.5
        self.total = self.cum[-1] + (
            _tail_mass(self.a, self.n + 0.5, self.theta) if self.n > head else 0.0)

    def ranks(self, u: np.ndarray) -> np.ndarray:
        if self.theta < 1:
            uz = u * self.zetan
            r = np.floor(self.n * (self.eta * u - self.eta + 1) ** self.alpha).astype(np.int64)
            r = np.where(uz < self.half, 1, r)
            r = np.where(uz < 1.0, 0, r)
            return np.minimum(r, self.n - 1)
        mass = u * self.total
        r = np.searchsorted(self.cum, mass, side="right").astype(np.int64)
        tail = mass - self.cum[-1]
        over = tail > 0
        if over.any():
            t, th = tail[over], self.theta
            if th == 1.0:
                x = self.a * np.exp(t)
            else:
                x = (self.a ** (1 - th) + t * (1 - th)) ** (1 / (1 - th))
            r[over] = np.floor(x - 0.5).astype(np.int64)  # x in [i + 0.5, i + 1.5): rank i
        return np.clip(r, 0, self.n - 1)


@dataclass
class Call:
    client: int
    number: int
    op: str
    target: int
    elements: np.ndarray
    check: bool


class ClientPlan:
    """The calls of one client thread.  ``space`` is the deployment's kind
    object: ``n_targets``, ``dtype`` of the elements, ``domain(source)``
    and ``values(source, target, ranks, out)``.  Not thread-safe: one
    plan per client."""

    def __init__(self, mix: dict, space, seed: int, client: int):
        self.mix, self.space, self.client = mix, space, client
        self.seed = int(seed) % (1 << 64)
        ops = mix["ops"]
        self._sizes = [int(op.get("elements", mix["elements_per_call"])) for op in ops]
        rng = np.random.default_rng([self.seed, client, 1 << 40])
        t = mix.get("target", {"dist": "uniform"})
        self._target_zipf: Optional[Zipf] = (
            Zipf(space.n_targets, t["theta"]) if t["dist"] == "zipf" else None)
        self._parts = []
        for op, n in zip(ops, self._sizes):
            parts, left = [], n
            op_parts = op.get("parts", [])
            for i, p in enumerate(op_parts):
                size = left if i == len(op_parts) - 1 else int(round(p["share"] * n))
                left -= size
                dom = space.domain(p["source"])
                dist = p.get("dist", "uniform")
                if dist == "zipf":
                    parts.append((p["source"], size, dom, Zipf(dom, p["theta"]), None))
                elif dist == "uniform":
                    base = rng.integers(0, dom, size, dtype=np.int64)
                    parts.append((p["source"], size, dom, None, base))
                else:
                    raise ValueError(f"unknown dist {dist!r}")
            self._parts.append(parts)
        self._scratch = np.empty(max(self._sizes), np.int64)
        self._bases: dict = {}
        # Ops with "every" take their calls first; the rest share the others.
        self._every = [(i, int(op["every"])) for i, op in enumerate(ops) if "every" in op]
        self._rest = [i for i, op in enumerate(ops) if "every" not in op]
        w = np.asarray([ops[i].get("weight", 1.0) for i in self._rest], np.float64)
        self._cum = np.cumsum(w / w.sum())

    def buffers(self) -> dict:
        """One output array per op, for ``call(j, out=...)``."""
        return {i: np.empty(n, self.space.dtype) for i, n in enumerate(self._sizes)}

    def _draw(self, j: int):
        """Call ``j``'s draws: op index, target, per part ``(source, size,
        dom, base, offset or zipf ranks)``, and whether it is checked."""
        rng = np.random.default_rng([self.seed, self.client, j])
        mix = self.mix
        oi = next((i for i, every in self._every if (j + 1) % every == 0), None)
        if oi is None and mix.get("order", "random") == "alternate":
            oi = self._rest[(j + self.client) % len(self._rest)]
        elif oi is None:
            at = int(np.searchsorted(self._cum, rng.random(), side="right"))
            oi = self._rest[min(at, len(self._rest) - 1)]
        if self._target_zipf is not None:
            target = int(self._target_zipf.ranks(rng.random(1))[0])
        else:
            target = int(rng.integers(0, self.space.n_targets))
        parts = []
        for source, size, dom, zipf, base in self._parts[oi]:
            if zipf is not None:
                parts.append((source, size, dom, None, zipf.ranks(rng.random(size))))
            else:
                parts.append((source, size, dom, base, int(rng.integers(0, dom))))
        check = bool(rng.random() < float(mix.get("check_share", 1.0)))
        return oi, target, parts, check

    def call(self, j: int, out: Optional[dict] = None) -> Call:
        """Call ``j``.  ``out`` (from ``buffers()``) receives the elements
        in place of a new array: a loop that reuses its buffers pays no
        allocation for a call of millions of elements."""
        oi, target, parts, check = self._draw(j)
        elements = np.empty(self._sizes[oi], self.space.dtype) if out is None else out[oi]
        at = 0
        for source, size, dom, base, r in parts:
            if base is None:
                ranks = r
            else:
                ranks = self._scratch[:size]
                np.add(base, r, out=ranks)
                np.subtract(ranks, dom, out=ranks, where=ranks >= dom)  # mod dom
            self.space.values(source, target, ranks, elements[at:at + size])
            at += size
        return Call(self.client, j, self.mix["ops"][oi]["op"], target, elements, check)

    def elements_on(self, j: int, device):
        """Call ``j``'s elements made on ``device`` as an int64 tensor of
        their bits (the reference's copy: same draws, no host arrays)."""
        import torch

        _, target, parts, _ = self._draw(j)
        out = []
        for source, size, dom, base, r in parts:
            if base is None:
                ranks = torch.from_numpy(r).to(device)
            else:
                key = (id(base), str(device))
                if key not in self._bases:
                    self._bases[key] = torch.from_numpy(base).to(device)
                ranks = self._bases[key] + r
                ranks = torch.where(ranks >= dom, ranks - dom, ranks)
            out.append(self.space.values_t(source, target, ranks))
        if not out:
            return torch.empty(0, dtype=torch.int64, device=device)
        return out[0] if len(out) == 1 else torch.cat(out)
