"""Why the card sits idle, from inside the port (``obs/spans.py``).

* Every public data call of the objects' async paths observes its
  ``encode``, ``admit_wait`` and ``submit`` phases in
  ``rtpu_call_phase_seconds`` exactly once (a count-min call its host
  ``hash`` too); a call held by the queue bound spends the hold in
  ``admit_wait``.
* Each launch's device time (its host duration on the CPU) reaches
  ``rtpu_launch_device_seconds``, and the idle gap before a launch is
  split into ``rtpu_device_idle_seconds_total{cause}``: a caller that
  sleeps between calls puts the sleep under ``caller``, a slow staging
  under ``host_stage``, and so does a caller before a direct dispatch
  made inside its call (``direct`` is a launch with no call behind it,
  ``tests/test_torch_cms_stream_trace.py``); the causes of
  a gap sum to it, and a launch whose result is never fetched retires
  with the next launch of its stream.
* No ``record_function`` is entered while no profiler records; an
  all-threads profile shows ``rtpu:encode`` and ``rtpu:submit`` on the
  client thread and ``rtpu:stage`` and ``rtpu:enqueue:<op>`` on the flush
  thread.
* A segment shed at its deadline ends its span in one ``enqueue`` phase,
  with no ``coalesce_wait`` sample.
* The records add little to the submit path of a 1024-key call.
"""

import gc
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu_torch as rt  # noqa: E402
from redisson_tpu_torch.codecs import LongCodec  # noqa: E402
from redisson_tpu_torch.executor.coalescer import BatchCoalescer  # noqa: E402
from redisson_tpu_torch.obs import Observability, spans  # noqa: E402
from redisson_tpu_torch.obs.spans import CALL_PHASES, IDLE_CAUSES, idle_causes  # noqa: E402
from test_torch_grid_coordination import _one_torch_thread  # noqa: E402,F401


def _client(**kw):
    kw.setdefault("min_bucket", 64)
    kw.setdefault("nearcache", False)
    cfg = rt.Config().use_gpu_sketch(device="cpu", **kw)
    cfg.set_codec(LongCodec())
    return rt.create(cfg)


def _hist(cl, family):
    return {lv: (c.sum, c.count) for lv, c in cl.obs.registry.family(family).items()}


def _idle(cl) -> dict:
    fam = cl.obs.registry.family("rtpu_device_idle_seconds_total")
    return {lv[0]: c.value for lv, c in fam.items()}


# -- per-call phases -----------------------------------------------------------------


def _bloom(cl):
    bf = cl.get_bloom_filter("calls-bf")
    bf.try_init(100_000, 0.01)
    return bf


def _bitset(cl):
    bs = cl.get_bit_set("calls-bs")
    bs.set(1)
    return bs


def _hll(cl):
    return cl.get_hyper_log_log("calls-hll")


def _cms(cl):
    cms = cl.get_count_min_sketch("calls-cms")
    cms.try_init(4, 4096)
    return cms


_KEYS = np.arange(2048, dtype=np.uint64)
CALLS = {
    "BloomFilter.add_all_async": (_bloom, lambda o: o.add_all_async(_KEYS)),
    "BloomFilter.contains_all_async": (_bloom, lambda o: o.contains_all_async(_KEYS)),
    "BloomFilter.mixed_async": (
        _bloom, lambda o: o.mixed_async(_KEYS, np.arange(len(_KEYS)) % 3 == 0)),
    "BitSet.set_many_async": (_bitset, lambda o: o.set_many_async(np.arange(0, 8192, 4))),
    "BitSet.get_many_async": (_bitset, lambda o: o.get_many_async(np.arange(0, 8192, 3))),
    "HyperLogLog.add_all_async": (_hll, lambda o: o.add_all_async(_KEYS)),
    "CountMinSketch.add_all_async": (_cms, lambda o: o.add_all_async(_KEYS)),
    "CountMinSketch.estimate_all_async": (_cms, lambda o: o.estimate_all_async(_KEYS)),
}
# The stages a call observes besides the three (obs/spans.py STAGE_PHASES).
STAGES = {"CountMinSketch.add_all_async": {"hash"},
          "CountMinSketch.estimate_all_async": {"hash"}}


@pytest.mark.parametrize("op", sorted(CALLS))
def test_each_call_observes_its_three_phases_once(op):
    make, call = CALLS[op]
    cl = _client()
    try:
        obj = make(cl)
        cl.obs.reset_op_stats()  # the set-up's own launches
        t0 = time.monotonic()
        for _ in range(3):
            call(obj).result()
        wall = time.monotonic() - t0
        h = _hist(cl, "rtpu_call_phase_seconds")
        phases = set(CALL_PHASES) | STAGES.get(op, set())
        assert {ph for (o, ph) in h if o == op} == phases
        assert all(h[(op, ph)][1] == 3 for ph in phases)
        assert 0 < sum(h[(op, ph)][0] for ph in phases) <= wall
        assert h[(op, "admit_wait")][0] == 0.0  # an empty queue admits at once
        # Each call created the segment it rode, and its span knows when
        # the call began.
        spans_ = cl.obs.spans.recent()
        assert spans_ and all(s.first[0] is not None for s in spans_)
        assert all(s.device_s is not None and s.device_s > 0 for s in spans_)
    finally:
        cl.shutdown()


def test_a_call_held_by_the_queue_bound_spends_it_in_admit_wait():
    """A second call over ``max_queued_ops`` waits until the first call's
    segment leaves the queue (here: at the end of a 60 ms window)."""
    cl = _client(batch_window_us=60_000, adaptive_window=False, max_queued_ops=2048)
    try:
        bf = _bloom(cl)
        bf.contains_all_async(_KEYS[:1024]).result()  # warm
        f1 = bf.contains_all_async(_KEYS[:2048])
        f2 = bf.contains_all_async(_KEYS[:1024])
        f1.result(), f2.result()
        h = _hist(cl, "rtpu_call_phase_seconds")
        s, n = h[("BloomFilter.contains_all_async", "admit_wait")]
        assert n == 3 and s >= 0.03
    finally:
        cl.shutdown()


# -- device time and idle gaps ---------------------------------------------------------


def _slow_stage(orig):
    def stage(self, seg):
        cols = orig(self, seg)
        time.sleep(0.05)  # staging that took 50 ms longer
        seg.span.stamp("host_stage")  # phases sum by name: one longer phase
        return cols

    return stage


@pytest.mark.parametrize("held", ["caller", "host_stage", "direct"])
def test_an_idle_gap_goes_to_the_phase_that_held_the_launch(held, monkeypatch):
    """``direct``: no coalescer, so each launch is a direct dispatch made
    inside the caller's data call; the caller's sleep before the call is
    still the caller's."""
    if held == "host_stage":
        monkeypatch.setattr(BatchCoalescer, "_stage", _slow_stage(BatchCoalescer._stage))
    cl = _client(coalesce=held != "direct", batch_window_us=100)
    cause = "caller" if held == "direct" else held
    try:
        bf = _bloom(cl)
        bf.add_all_async(_KEYS).result()
        cl.obs.reset_op_stats()
        for _ in range(5):
            if held != "host_stage":
                time.sleep(0.05)
            bf.contains_all_async(_KEYS).result()
        gaps = cl.obs.launches.recent_gaps()
        assert len(gaps) == 5
        for gap, parts, _op in gaps:
            assert set(parts) <= set(IDLE_CAUSES)
            assert parts.get(cause, 0.0) >= 0.045, (gap, parts)
            assert parts[cause] >= 0.5 * gap
        idle = _idle(cl)
        assert idle[cause] >= 0.045 * len(gaps)
        if held == "direct":
            assert set(idle) <= {"caller", "encode", "submit"}
            ops = {o for (o,) in _hist(cl, "rtpu_launch_device_seconds")}
            assert ops == {"bloom_contains_keys_st"}  # the executor method
    finally:
        cl.shutdown()


SYNTHETIC = {
    # name: (first, stamps after t0 = 10, idle interval, expected parts)
    "no call": (None, (("coalesce_wait", 12), ("host_stage", 13), ("slot_wait", 14)),
                (8, 15), {"caller": 2, "coalesce_wait": 2, "host_stage": 1,
                          "slot_wait": 1, "enqueue": 1}),
    "call": ((5, None, None), (("coalesce_wait", 12), ("host_stage", 13), ("slot_wait", 14)),
             (4, 15), {"caller": 1, "encode": 5, "coalesce_wait": 2, "host_stage": 1,
                       "slot_wait": 1, "enqueue": 1}),
    "admitted after a wait": ((3, 6, 9), (("coalesce_wait", 12),), (2, 13),
                              {"caller": 1, "encode": 3, "admit_wait": 3,
                               "coalesce_wait": 3, "enqueue": 1}),
    "gap inside staging": ((3, None, None), (("coalesce_wait", 12), ("host_stage", 14)),
                           (12.5, 13.25), {"host_stage": 0.75}),
    "retried: latest stamps": ((3, None, None), (
        ("coalesce_wait", 11), ("host_stage", 12), ("slot_wait", 13),
        ("coalesce_wait", 20), ("host_stage", 21), ("slot_wait", 22)),
        (19, 23), {"coalesce_wait": 1, "host_stage": 1, "slot_wait": 1, "enqueue": 1}),
}


@pytest.mark.parametrize("case", sorted(SYNTHETIC) + ["direct", "a client's run"])
def test_the_causes_of_each_gap_sum_to_it(case):
    if case == "direct":
        assert idle_causes(None, 1.0, 3.5) == {"direct": 2.5}
        return
    if case == "a client's run":
        cl = _client(batch_window_us=100)
        try:
            bf = _bloom(cl)
            for _ in range(6):
                bf.contains_all_async(_KEYS).result()
            gaps = cl.obs.launches.recent_gaps()
            assert len(gaps) >= 5
            for gap, parts, _op in gaps:
                assert abs(sum(parts.values()) - gap) <= 1e-9
            assert sum(_idle(cl).values()) == pytest.approx(sum(g for g, _, _ in gaps), abs=1e-9)
        finally:
            cl.shutdown()
        return
    first, stamps, (a, b), want = SYNTHETIC[case]
    span = Observability().spans.start("op")
    span.t0 = 10.0
    span.first = first
    span.stamps = list(stamps)
    parts = idle_causes(span, a, b)
    assert parts == pytest.approx(want)
    assert sum(parts.values()) == pytest.approx(b - a, abs=1e-12)
    assert list(parts) == [c for c in IDLE_CAUSES if c in parts]  # in launch order


def test_a_launch_never_fetched_retires_with_the_next_one():
    obs = Observability()
    timer = obs.launches
    cpu = torch.device("cpu")
    launches = []
    for _ in range(3):
        launch = timer.begin((cpu,), "op")
        time.sleep(0.002)
        timer.end(launch)
        launches.append(launch)
    timer.retire(launches[-1], fetched=True)
    h = dict(obs.registry.family("rtpu_launch_device_seconds").items())
    assert h[("op",)].count == 3
    assert len(timer.recent_gaps()) == 2
    assert all(L.left == 0 and L.device_s >= 0.002 for L in launches)


# -- profiler ranges -----------------------------------------------------------------


def test_no_record_function_without_a_profiler(monkeypatch):
    from torch.autograd.profiler import record_function

    entered = []
    enter = record_function.__enter__

    def spy(self):
        entered.append((self.name, threading.get_ident()))
        return enter(self)

    monkeypatch.setattr(record_function, "__enter__", spy)
    for coalesce in (True, False):
        cl = _client(coalesce=coalesce)
        try:
            bf = _bloom(cl)
            bf.add_all_async(_KEYS).result()
            bf.contains_all_async(_KEYS).result()
        finally:
            cl.shutdown()
    assert entered == []


def test_an_all_threads_profile_shows_the_host_ranges_on_their_threads():
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    cl = _client(batch_window_us=100)
    try:
        bf = _bloom(cl)
        bf.contains_all_async(_KEYS).result()

        def client():
            for _ in range(3):
                bf.contains_all_async(_KEYS).result()

        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
            t = threading.Thread(target=client)
            t.start()
            t.join()
        assert not spans.profiling()
        threads: dict = {}
        for e in prof.events():
            if e.name.startswith("rtpu:"):
                threads.setdefault(e.name, set()).add(e.thread)
        assert {"rtpu:encode", "rtpu:submit", "rtpu:stage",
                "rtpu:enqueue:bloom_mixkr"} <= set(threads), sorted(threads)
        assert threads["rtpu:encode"] == threads["rtpu:submit"]
        assert threads["rtpu:stage"] == threads["rtpu:enqueue:bloom_mixkr"]
        assert not threads["rtpu:encode"] & threads["rtpu:stage"]
    finally:
        cl.shutdown()


def test_a_segment_shed_at_its_deadline_ends_in_enqueue():
    """A queued segment whose deadline lapses behind a slow launch is shed
    before dispatch: its span is one ``enqueue`` phase (the launches still
    count by ``enqueue``) and adds no ``coalesce_wait`` sample, which the
    coalescer's queue-time readings take."""
    from redisson_tpu_torch.executor.failures import DeadlineExceededError

    class _Lazy:
        def __init__(self, v):
            self.v = v

        def result(self):
            return self.v

    gate = threading.Event()

    def slow(cols):
        gate.wait(10.0)
        return _Lazy(cols[0])

    obs = Observability()
    c = BatchCoalescer(batch_window_us=100, max_batch=1024, obs=obs)
    try:
        fa = c.submit(("slow",), slow, (np.arange(8),), 8)
        time.sleep(0.05)  # the flush thread is inside slow()
        fb = c.submit(("shed",), lambda cols: _Lazy(cols[0]), (np.arange(8),), 8,
                      deadline=time.monotonic() + 0.1)
        time.sleep(0.3)  # the deadline lapses while 'slow' holds the loop
        gate.set()
        with pytest.raises(DeadlineExceededError):
            fb.result(timeout=5.0)
        assert fa.result(timeout=5.0) is not None
        shed = [s for s in obs.spans.recent() if s.op == "shed"]
        assert len(shed) == 1 and shed[0].error
        assert list(shed[0].phases()) == ["enqueue"]
        counts = {lv: c.count for lv, c in obs.registry.family(
            "rtpu_op_phase_seconds").items()}
        assert counts[("shed", "enqueue")] == 1
        assert ("shed", "coalesce_wait") not in counts
    finally:
        gate.set()
        c.shutdown()


# -- cost on the submit path ----------------------------------------------------------


def test_the_records_add_little_to_a_1024_key_submit():
    """The per-call records on the submit path of a 1024-key contains
    (the ``data_call`` wrapper, the ambient call, its three observes, the
    encode stamp and the range checks) against the same calls made as
    the path was without them: the undecorated method and an ``_encode``
    that only encodes.  The coalescer's one thread-local read of the
    ambient call is left in both arms.  The harness of the JAX package's
    overhead guards: a window that never closes, so the flush thread
    stays parked; rounds alternate the arms with GC paused; the cleanest
    observation (min of paired ratios and of minima) bounds the cost at
    the 10% the reference bounds its instrumented submit at."""
    from redisson_tpu_torch.codecs import encode_batch

    cl = _client(batch_window_us=30_000_000, max_batch=1 << 22, max_queued_ops=1 << 24)
    try:
        bf = _bloom(cl)
        keys = np.arange(1024, dtype=np.uint64)
        n = 10
        recorded_call = bf.contains_all_async
        plain_call = type(bf).contains_all_async.__wrapped__.__get__(bf)

        def plain_encode(objs):
            if np.isscalar(objs) or isinstance(objs, (str, bytes)):
                objs = [objs]
            return encode_batch(bf._codec, objs)

        def round_time(plain):
            if plain:
                bf._encode, call = plain_encode, plain_call
            else:
                bf.__dict__.pop("_encode", None)
                call = recorded_call
            t0 = time.perf_counter()
            for _ in range(n):
                call(keys)
            return time.perf_counter() - t0

        history = []
        for _ in range(4):
            plain, recorded = [], []
            gc.disable()
            try:
                for r in range(16):
                    if r % 2:
                        plain.append(round_time(True))
                        recorded.append(round_time(False))
                    else:
                        recorded.append(round_time(False))
                        plain.append(round_time(True))
            finally:
                gc.enable()
            ratio = min(min(q / p for p, q in zip(plain, recorded)),
                        min(recorded) / min(plain))
            history.append(ratio)
            if ratio <= 1.10:
                break
        else:
            raise AssertionError(f"recorded submit >10% slower: {history}")
        assert _hist(cl, "rtpu_call_phase_seconds")[
            ("BloomFilter.contains_all_async", "encode")][1] > 0
        # Let the one queued launch go before shutdown drains it.
        cl._engine.coalescer.flush_hint()
    finally:
        cl.shutdown()
