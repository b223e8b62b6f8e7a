"""The count-min stream's records (``obs/spans.py``, ``objects/engines.py``
``TopKStore``):

* ``add_all_seq`` is one data call whose ``rtpu_call_phase_seconds``
  observe ``encode``, ``admit_wait``, ``hash``, ``drain``, ``submit``,
  ``fetch`` and ``offer`` once each, summing to the call's time;
  ``add_all_async`` adds ``hash`` to the three of every call and observes
  its ``offer`` once, when its result is first read.
* ``TopKStore`` counts the keys offered and its prunes, and its gauge holds
  the candidates of every table.
* An idle gap before a launch made with no segment is split by the stamps
  of the call that made it (``caller``, ``encode``, ``hash``, ``drain``,
  ``submit``); ``direct`` only where no call is behind the launch.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu_torch as rt  # noqa: E402
from redisson_tpu_torch.codecs import LongCodec  # noqa: E402
from redisson_tpu_torch.obs import Observability, spans  # noqa: E402
from redisson_tpu_torch.obs.spans import (  # noqa: E402
    CALL_PHASES, IDLE_CAUSES, STAGE_PHASES, idle_causes)
from test_torch_grid_coordination import _one_torch_thread  # noqa: E402,F401

SEQ = "CountMinSketch.add_all_seq"
ASYNC = "CountMinSketch.add_all_async"
SEQ_PHASES = CALL_PHASES + STAGE_PHASES  # add_all_seq has every stage


def _client(**kw):
    kw.setdefault("nearcache", False)
    cfg = rt.Config().use_gpu_sketch(device="cpu", **kw)
    cfg.set_codec(LongCodec(unsigned=True))
    return rt.create(cfg)


def _hist(cl):
    fam = cl.obs.registry.family("rtpu_call_phase_seconds")
    return {lv: (c.sum, c.count) for lv, c in fam.items()}


def _value(cl, family):
    fam = cl.obs.registry.family(family)
    return sum(c.value for _, c in fam.items())


def _events(seed, n=4096):
    rng = np.random.default_rng(seed)
    return (rng.zipf(1.2, n) % 3000).astype(np.uint64)


@pytest.mark.parametrize("track", [20, 0])
def test_add_all_seq_observes_each_of_its_phases_once(track):
    cl = _client()
    try:
        cms = cl.get_count_min_sketch("seq")
        assert cms.try_init(5, 4096, track_top_k=track)
        cms.add_all_seq(_events(0))
        cl.obs.reset_op_stats()
        t0 = time.monotonic()
        for i in range(3):
            cms.add_all_seq(_events(i + 1))
        wall = time.monotonic() - t0
        h = _hist(cl)
        want = set(SEQ_PHASES) - (set() if track else {"offer"})
        assert {ph for (o, ph) in h if o == SEQ} == want
        assert all(h[(SEQ, ph)][1] == 3 for ph in want)
        assert 0 < sum(h[(SEQ, ph)][0] for ph in want) <= wall
        assert h[(SEQ, "admit_wait")][0] == 0.0  # K1 is no coalesced segment
        assert all(h[(SEQ, ph)][0] > 0 for ph in ("hash", "submit"))
    finally:
        cl.shutdown()


def test_the_phases_partition_the_call():
    """A stage made 30 ms slower shows in its own phase, and the sum of
    the phases stays the call's time."""
    cl = _client()
    try:
        cms = cl.get_count_min_sketch("part")
        assert cms.try_init(5, 4096, track_top_k=20)
        eng = cl._engine
        orig = eng._drain

        def slow_drain():
            time.sleep(0.03)
            orig()

        eng._drain = slow_drain
        cl.obs.reset_op_stats()
        t0 = time.monotonic()
        cms.add_all_seq(_events(5))
        wall = time.monotonic() - t0
        h = _hist(cl)
        assert h[(SEQ, "drain")][0] >= 0.03
        total = sum(h[(SEQ, ph)][0] for ph in SEQ_PHASES)
        assert 0.03 <= total <= wall
        assert h[(SEQ, "submit")][0] < total - 0.03
    finally:
        cl.shutdown()


def test_add_all_async_hashes_in_its_call_and_offers_on_its_result():
    cl = _client()
    try:
        cms = cl.get_count_min_sketch("async")
        assert cms.try_init(5, 4096, track_top_k=20)
        cms.add_all_async(_events(0)).result()
        cl.obs.reset_op_stats()
        futs = [cms.add_all_async(_events(i)) for i in range(1, 4)]
        h = _hist(cl)
        assert {ph for (o, ph) in h if o == ASYNC} == set(CALL_PHASES) | {"hash"}
        for f in futs:
            f.result()
            f.result()  # the offer runs once
        h = _hist(cl)
        assert {ph for (o, ph) in h if o == ASYNC} == set(CALL_PHASES) | {"hash", "offer"}
        assert all(h[(ASYNC, ph)][1] == 3 for ph in ("encode", "hash", "offer"))
    finally:
        cl.shutdown()


def test_the_top_k_table_counts_offers_prunes_and_candidates():
    cl = _client()
    try:
        cms = cl.get_count_min_sketch("topk")
        assert cms.try_init(5, 4096, track_top_k=4)  # cap 4 * 16 = 64
        store = cl._engine.topk
        n_offered = 0
        for i in range(6):
            keys = np.arange(i * 1000, i * 1000 + 500, dtype=np.uint64)
            cms.add_all_seq(keys)
            n_offered += min(64, 500)  # the call's heaviest 4 * max(k, 16)
        assert _value(cl, "rtpu_topk_offered_total") == n_offered
        # 64 new keys a call: past 2 * 64 the table is cut back to 64, at
        # the third offer and the fifth; the sixth leaves 128.
        assert _value(cl, "rtpu_topk_prunes_total") == 2
        assert _value(cl, "rtpu_topk_candidates") == len(store.candidates("topk")) == 128
        other = cl.get_count_min_sketch("topk2")
        assert other.try_init(5, 4096, track_top_k=4)
        other.add_all_seq(np.arange(10, dtype=np.uint64))
        assert _value(cl, "rtpu_topk_candidates") == 138
        cms.rename("topk3")
        assert _value(cl, "rtpu_topk_candidates") == 138
        assert cms.delete()
        assert _value(cl, "rtpu_topk_candidates") == 10
    finally:
        cl.shutdown()


def test_the_store_without_a_bundle_records_nothing():
    from redisson_tpu_torch.objects.engines import TopKStore

    store = TopKStore()
    store.configure("x", 1)
    store.offer("x", list(range(200)), list(range(1, 201)))  # past 2 * 64: cut
    assert sorted(store.candidates("x")) == list(range(136, 200))


def test_an_idle_gap_before_k1_goes_to_the_call_that_made_it():
    """The caller sleeps 50 ms between calls: each gap before K1's launch
    is the caller's, and none is ``direct``."""
    cl = _client()
    try:
        cms = cl.get_count_min_sketch("idle")
        assert cms.try_init(5, 4096)
        cms.add_all_seq(_events(0))
        cl.obs.reset_op_stats()
        for i in range(4):
            time.sleep(0.05)
            cms.add_all_seq(_events(i + 1))
        gaps = [g for g in cl.obs.launches.recent_gaps() if g[2] == "cms_update_estimate_seq"]
        assert len(gaps) >= 3
        for gap, parts, _op in gaps:
            assert set(parts) <= {"caller", "encode", "hash", "drain", "submit"}, parts
            assert parts["caller"] >= 0.045
            assert abs(sum(parts.values()) - gap) <= 1e-9
        fam = cl.obs.registry.family("rtpu_device_idle_seconds_total")
        idle = {lv[0]: c.value for lv, c in fam.items()}
        assert "direct" not in idle and idle["hash"] > 0
    finally:
        cl.shutdown()


CALL_STAMPS = {
    # name: (call start, encode end, marks, idle interval, expected parts)
    "whole call": (10, 11, (("hash", 12), ("drain", 13), ("hash", 14), ("drain", 15)),
                   (8, 16), {"caller": 2, "encode": 1, "hash": 2, "drain": 2, "submit": 1}),
    "gap from the hash on": (10, 11, (("hash", 12), ("drain", 13)), (11.5, 13.5),
                             {"hash": 0.5, "drain": 1, "submit": 0.5}),
    "no stage marked": (10, 11, (), (9, 12), {"caller": 1, "encode": 1, "submit": 1}),
}


@pytest.mark.parametrize("case", sorted(CALL_STAMPS))
def test_a_direct_launchs_gap_splits_by_its_calls_stamps(case):
    t0, t_enc, marks, (a, b), want = CALL_STAMPS[case]
    parts = idle_causes(None, a, b, (t0, t_enc, marks))
    assert parts == pytest.approx(want)
    assert sum(parts.values()) == pytest.approx(b - a, abs=1e-12)
    assert list(parts) == [c for c in IDLE_CAUSES if c in parts]


def test_a_launch_with_no_call_behind_it_is_direct():
    timer = Observability().launches
    cpu = torch.device("cpu")
    for _ in range(2):
        launch = timer.begin((cpu,), "op")
        timer.end(launch)
        timer.retire(launch, fetched=True)
        time.sleep(0.01)
    (gap, parts, _), = timer.recent_gaps()
    assert set(parts) == {"direct"}


def test_a_stage_outside_a_call_is_not_recorded():
    assert spans.clock() is None and spans.clock(wait=True) is None
    spans.spent("hash", None)  # nothing open, nothing to do
