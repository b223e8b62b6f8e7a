"""CountMinSketch — counterpart of ``redisson_tpu/objects/count_min_sketch.py``
(the RObject idiom: tryInit/add/estimate/topK, name-addressed,
codec-encoded keys).

Geometry: depth d × width w counters per tenant; point estimates are the
classic min-over-rows upper bound.  Heavy-hitter tracking (benchmark
config 5) is ENGINE-shared and name-addressed (engines.TopKStore): every
handle to one sketch sees one candidate table; each add batch offers its
heaviest candidates (argpartition over the post-update estimate stream
that rides back with the batch), and ``top_k()`` re-estimates candidates
on device so the ranking reflects current counts exactly.
"""

from __future__ import annotations

import math
import time

import numpy as np

from redisson_tpu_torch.objects.base import MappedFuture, RObject, data_call
from redisson_tpu_torch.obs import spans as _spans
from redisson_tpu_torch.tenancy import PoolKind


class CountMinSketch(RObject):
    KIND = PoolKind.CMS

    # Batch pipelining.
    _DEFERRED = {
        "add": "add_deferred",
        "add_all": "add_all_async",
        "estimate": "estimate_deferred",
        "estimate_all": "estimate_all_async",
    }

    def add_deferred(self, obj, count: int = 1):
        return MappedFuture(self.add_all_async([obj], [count]), lambda v: int(v[0]))

    def estimate_deferred(self, obj):
        return MappedFuture(self.estimate_all_async([obj]), lambda v: int(v[0]))

    @data_call
    def estimate_all_async(self, objs):
        H1, H2 = self._hash128(objs)
        return self._engine.cms_estimate(self._name, H1, H2)

    # -- lifecycle ---------------------------------------------------------

    def try_init(self, depth: int, width: int, track_top_k: int = 0) -> bool:
        """Create with explicit geometry.  ``track_top_k``: keep a live
        top-K candidate table updated on every add (shared across every
        handle to this name)."""
        created = self._engine.cms_try_init(self._name, int(depth), int(width))
        if track_top_k and created:
            # Only the CREATING init arms tracking: tryInit on an existing
            # object must change nothing regardless of params (a failed
            # init silently enabling tracking taxed every handle's adds).
            self._engine.topk.configure(self._name, int(track_top_k))
        return created

    def try_init_by_error(
        self, epsilon: float, confidence: float, track_top_k: int = 0
    ) -> bool:
        """Standard CMS sizing: w = ceil(e/eps), d = ceil(ln(1/(1-conf)))."""
        w = math.ceil(math.e / epsilon)
        d = max(1, math.ceil(math.log(1.0 / (1.0 - confidence))))
        return self.try_init(d, w, track_top_k)

    def _params(self) -> dict:
        p = self._engine.params(self._name)
        if p is None:
            raise RuntimeError(f"count-min sketch {self._name!r} is not initialized")
        return p

    def get_depth(self) -> int:
        return self._params()["depth"]

    def total_count(self) -> int:
        """Total inserted weight (the RedisBloom CMS.INFO 'count' field):
        row-0 cell sum — every increment lands once per depth row."""
        self._params()
        return self._engine.cms_total(self._name)

    def get_width(self) -> int:
        return self._params()["width"]

    # -- data path ---------------------------------------------------------

    def add(self, obj, count: int = 1) -> int:
        """Add and return the post-update estimate for obj."""
        return int(self.add_all([obj], [count])[0])

    def add_all(self, objs, counts=None) -> np.ndarray:
        return self.add_all_async(objs, counts).result()

    @data_call
    def add_all_async(self, objs, counts=None):
        # Materialize FIRST: a generator would be exhausted by the hash
        # pass, leaving _make_offer an empty key list (counters updated,
        # top-K candidates silently never recorded).
        if not isinstance(objs, np.ndarray):
            objs = list(objs)
        H1, H2 = self._hash128(objs)
        if counts is None:
            counts = np.ones(len(H1), np.uint32)
        fut = self._engine.cms_add(
            self._name, H1, H2, np.asarray(counts, np.uint32)
        )
        k = self._engine.topk.track(self._name)
        if not k:
            return fut
        return _OfferOnResult(fut, self._make_offer(objs, k), self._calls)

    def _make_offer(self, objs, k: int):
        """Top-K candidate feed shared by add_all_async and add_all_seq:
        the batch's heaviest UNIQUE keys (≤4k) go to the engine table."""
        name, engine = self._name, self._engine
        objs_ref = list(objs) if not isinstance(objs, np.ndarray) else objs

        def offer(est):
            # Select the batch's heaviest UNIQUE keys (a heavy key appears
            # many times per batch; taking top ops would offer only its
            # duplicates), then push ≤4k candidates to the shared table.
            est = np.asarray(est)
            n_offer = min(4 * max(k, 16), est.shape[0])
            if isinstance(objs_ref, np.ndarray):
                uniq, inv = np.unique(objs_ref, return_inverse=True)
                per_key = np.zeros(len(uniq), est.dtype)
                np.maximum.at(per_key, inv, est)
                keys_list, ests_arr = uniq, per_key
            else:
                best: dict = {}
                for o, e in zip(objs_ref, est):
                    e = int(e)
                    if best.get(o, -1) < e:
                        best[o] = e
                keys_list = list(best)
                ests_arr = np.fromiter(best.values(), dtype=np.int64)
            if n_offer < len(keys_list):
                top = np.argpartition(ests_arr, -n_offer)[-n_offer:]
            else:
                top = np.arange(len(keys_list))
            # Keep keys as their ORIGINAL scalar types (.tolist() would
            # turn np.uint64 into int, which codecs encode differently —
            # re-estimation would then miss every candidate).
            keys = [keys_list[i] for i in top]
            engine.topk.offer(name, keys, ests_arr[top])
            return est

        return offer

    @data_call
    def add_all_seq(self, objs, counts=None) -> np.ndarray:
        """Streaming variant of add_all (kernel K1, ops/cms_seq.py): each
        op's returned estimate is its
        AT-SEQUENCE-POINT value — its own update applied, LATER ops in
        the batch excluded (five adds of one key return 1,2,3,4,5).
        add_all's vectorized path instead returns post-whole-batch
        estimates (5,5,5,5,5); the final table is identical either way.
        One data call: ``encode``, ``hash``, the engine's ``drain``,
        ``submit`` (K1's host issue), the ``fetch`` of the estimates and
        the top-K ``offer``."""
        if not isinstance(objs, np.ndarray):
            objs = list(objs)  # generators: see add_all_async
        H1, H2 = self._hash128(objs)
        if counts is None:
            counts = np.ones(len(H1), np.uint32)
        fut = self._engine.cms_add_seq(
            self._name, H1, H2, np.asarray(counts, np.uint32)
        )
        t = _spans.clock(wait=True)
        res = np.asarray(fut.result())
        _spans.spent("fetch", t)
        k = self._engine.topk.track(self._name)
        if k:
            # Sequential estimates are per-op lower than batch-final; the
            # shared table max-merges, so offering them is still sound —
            # same unique-key/cap selection as add_all_async.
            t = _spans.clock()
            self._make_offer(objs, k)(res)
            _spans.spent("offer", t)
        return res

    def estimate(self, obj) -> int:
        # [obj], never np.atleast_1d: coercing a python int to np.int64
        # changes its codec encoding, silently estimating a different key.
        return int(self.estimate_all([obj])[0])

    def estimate_all(self, objs) -> np.ndarray:
        return self.estimate_all_async(objs).result()

    def merge(self, *other_names: str) -> None:
        """CMS.MERGE: add every named sketch's counters into this one."""
        self._engine.cms_merge(self._name, other_names)

    # -- top-K tracking (engine-shared, see module docstring) --------------

    def top_k(self, k: int | None = None):
        """[(key, estimated_count)] heaviest-first.  Candidates come from
        the engine-shared table; their counts are RE-ESTIMATED on device
        at call time, so the ranking reflects all adds from every handle."""
        k = k or self._engine.topk.track(self._name) or 10
        cands = self._engine.topk.candidates(self._name)
        if not cands:
            return []
        ests = self.estimate_all(cands)
        # int64 BEFORE negation: -uint32 wraps, ranking zero-count stale
        # candidates as the heaviest hitters.
        order = np.argsort(-ests.astype(np.int64), kind="stable")[:k]
        return [(cands[i], int(ests[i])) for i in order]


class _OfferOnResult:
    """Future adapter: feeds the engine's top-K table exactly once when the
    batch's estimates materialize, and records how long that took as the
    ``offer`` stage of ``add_all_async`` (its call has returned by then)."""

    def __init__(self, fut, offer, calls=None):
        self._fut = fut
        self._offer = offer
        self._calls = calls
        self._done_val = None
        self._offered = False

    def result(self, *a, **kw):
        v = self._fut.result(*a, **kw)
        if not self._offered:
            self._offered = True
            t = time.monotonic()
            self._done_val = self._offer(v)
            if self._calls is not None:
                self._calls.observe(
                    "CountMinSketch.add_all_async", "offer", time.monotonic() - t)
        return self._done_val if self._done_val is not None else v

    def get(self):
        return self.result()

    def done(self):
        return self._fut.done()
