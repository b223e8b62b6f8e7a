"""The port's chaos engine and circuit breakers against the JAX package's.

Counterparts of ``TestSchedule`` and ``TestBreaker`` in
``tests/test_chaos.py``: for the same seed, rate and points both packages'
rules fire on the same call indexes, ``fire``/``inject``/``clear`` behave
alike, and scripted breaker sequences under an injected clock give the
same states, ``allow`` answers and transition callbacks in both.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from redisson_tpu import chaos as jchaos  # noqa: E402
from redisson_tpu.executor import health as jhealth  # noqa: E402
from redisson_tpu_torch import chaos  # noqa: E402
from redisson_tpu_torch.analysis import witness as port_witness  # noqa: E402
from redisson_tpu_torch.chaos import ChaosSchedule, FaultInjected  # noqa: E402
from redisson_tpu_torch.executor import health  # noqa: E402
from redisson_tpu_torch.executor.health import (  # noqa: E402
    CLOSED,
    HALF_OPEN,
    OPEN,
    kind_of_op,
)


@pytest.fixture(autouse=True)
def _port_witness_guard():
    """``tests/conftest.py`` drains only the JAX package's witness: under
    ``RTPU_LOCK_WITNESS=1`` a test that leaves a violation in the port's
    fails with its stack pairs (nothing to do with the witness off)."""
    yield
    if port_witness.active():
        vs = port_witness.take_violations()
        if vs:
            pytest.fail(
                "port lock-order witness found %d violation(s):\n\n%s"
                % (len(vs), "\n\n".join(v.format() for v in vs)),
                pytrace=False,
            )


PACKAGES = {"torch": (chaos, health), "jax": (jchaos, jhealth)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _chaos_off():
    """Every test starts and ends with both packages' chaos disarmed."""
    for mod in (chaos, jchaos):
        mod.clear()
        mod.reset_counts()
    yield
    for mod in (chaos, jchaos):
        mod.clear()
        mod.reset_counts()


# -- schedule determinism ----------------------------------------------------


def _pattern(mod, seed, rate, point, n=400):
    (rule,) = mod.ChaosSchedule(seed=seed, rate=rate, points=(point,)).rules()
    return [rule.roll() for _ in range(n)]


class TestSchedule:
    @pytest.mark.parametrize("seed,rate,point", [
        (7, 0.3, "dispatch"),
        (42, 0.05, "dispatch.bloom_mixed_keys_runs"),
        (42, 0.05, "fetch"),
        (42, 0.05, "h2d.staging"),
        (0, 0.5, "snapshot.save"),
    ])
    def test_same_seed_same_fire_pattern(self, seed, rate, point):
        mine = _pattern(chaos, seed, rate, point)
        assert mine == _pattern(jchaos, seed, rate, point)  # the JAX package's
        assert mine == _pattern(chaos, seed, rate, point)
        assert mine != _pattern(chaos, seed + 1, rate, point)

    def test_rate_zero_never_fires_rate_one_always(self):
        (never,) = ChaosSchedule(seed=1, rate=0.0, points=("p",)).rules()
        (always,) = ChaosSchedule(seed=1, rate=1.0, points=("p",)).rules()
        assert not any(never.roll() for _ in range(100))
        assert all(always.roll() for _ in range(100))

    def test_points_roll_independently(self):
        for mod in (chaos, jchaos):
            ra, rb = mod.ChaosSchedule(seed=3, rate=0.5, points=("a", "b")).rules()
            pa, pb = [ra.roll() for _ in range(64)], [rb.roll() for _ in range(64)]
            assert pa != pb
        ja, jb = jchaos.ChaosSchedule(seed=3, rate=0.5, points=("a", "b")).rules()
        assert pa == [ja.roll() for _ in range(64)]
        assert pb == [jb.roll() for _ in range(64)]

    def test_install_clear_toggle_guard(self):
        assert not chaos.ENABLED
        chaos.install(ChaosSchedule(seed=0, rate=1.0, points=("x",)))
        assert chaos.ENABLED and chaos.active() == {"x": ("error", 1.0, 0)}
        chaos.clear()
        assert not chaos.ENABLED

    def test_fire_kinds(self):
        chaos.inject("err", kind="error", rate=1.0)
        with pytest.raises(FaultInjected):
            chaos.fire("err")
        chaos.inject("corr", kind="corrupt", rate=1.0)
        with pytest.raises(chaos.CorruptionDetected):
            chaos.fire("corr", data=np.arange(8, dtype=np.uint32))
        chaos.inject("lat", kind="latency", rate=1.0, latency_s=0.01)
        t0 = time.monotonic()
        chaos.fire("lat")  # must NOT raise
        assert time.monotonic() - t0 >= 0.009
        chaos.inject("press", kind="pressure", rate=1.0, latency_s=30.0)
        chaos.fire("press")  # inert at an ordinary point
        assert chaos.bias("press") == 30.0
        assert chaos.counts()[("err", "error")] == 1
        with pytest.raises(ValueError):
            chaos.inject("x", kind="meltdown")

    def test_prefix_match_for_dispatch_points(self):
        chaos.inject("dispatch", kind="error", rate=1.0)
        with pytest.raises(FaultInjected):
            chaos.fire("dispatch.bloom_mixed_keys_runs")
        chaos.clear()
        chaos.inject("dispatch.read_row", kind="error", rate=1.0)
        chaos.fire("dispatch.bloom_mixed_keys_runs")  # no rule for this method
        with pytest.raises(FaultInjected):
            chaos.fire("dispatch.read_row")
        chaos.clear()
        chaos.inject("*", kind="error", rate=1.0)
        with pytest.raises(FaultInjected):
            chaos.fire("fetch")

    def test_seeded_schedule_over_points_fires_alike_in_both(self):
        """A multi-point schedule driven through the same point sequence
        injects on the same calls in both packages."""
        points = ("dispatch", "fetch", "h2d.staging")
        seq = [("dispatch.bloom_mixed_keys_runs", "fetch", "h2d.staging",
                "dispatch.cms_update_estimate_seq", "dispatch.read_row")[i % 5]
               for i in range(600)]
        fired = {}
        for name, mod in (("torch", chaos), ("jax", jchaos)):
            mod.install(mod.ChaosSchedule(seed=42, rate=0.05, points=points))
            hits = []
            for i, p in enumerate(seq):
                try:
                    mod.fire(p)
                except mod.FaultInjected:
                    hits.append(i)
            fired[name] = (hits, mod.counts())
            mod.clear()
        assert fired["torch"] == fired["jax"]
        assert fired["torch"][0]  # the schedule did fire


def test_disabled_guard_never_consults_fire(monkeypatch):
    """With chaos disabled the hot paths never reach ``fire``."""
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec

    calls = []
    monkeypatch.setattr(chaos, "fire", lambda *a, **k: calls.append(a))
    c = rt.create(rt.Config().set_codec(LongCodec()).use_gpu_sketch(
        device="cpu", min_bucket=64))
    try:
        bf = c.get_bloom_filter("guard-bf")
        bf.try_init(1000, 0.01)
        assert bf.add(7) is True
        assert bf.contains(7) is True
        assert c.get_count_min_sketch("guard-cms").try_init(4, 256)
        c.get_count_min_sketch("guard-cms").add_all_seq(np.arange(8, dtype=np.uint64))
    finally:
        c.shutdown()
    assert calls == []


# -- circuit breakers: one scripted sequence on both packages ------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _run(script, **board_kw):
    """Run ``script(board, clock, log)`` on both packages' BreakerBoard
    with an injected clock; returns the two logs (required equal)."""
    logs = {}
    for name, (_, hmod) in PACKAGES.items():
        clk = _Clock()
        b = hmod.BreakerBoard(clock=clk, **board_kw)
        log = []
        b.on_open = lambda s, o, log=log: log.append(("open", s, o))
        b.on_close = lambda s, o, log=log: log.append(("close", s, o))
        script(b, clk, log)
        logs[name] = log
    assert logs["torch"] == logs["jax"]
    return logs["torch"]


class TestBreaker:
    def test_closed_open_halfopen_close(self):
        def script(b, clk, log):
            for _ in range(2):
                b.record_failure(0, "bloom_mixkr", RuntimeError("x"))
            log.append(b.states()[(0, "bloom_mixkr")])
            log.append(b.allow(0, "bloom_mixkr"))
            b.record_failure(0, "bloom_mixkr", RuntimeError("x"))
            log.append(b.states()[(0, "bloom_mixkr")])
            log.append(b.allow(0, "bloom_mixkr"))  # open: fail fast
            clk.t = 1.5
            log.append(b.allow(0, "bloom_mixkr"))  # the probe
            log.append(b.states()[(0, "bloom_mixkr")])
            log.append(b.allow(0, "bloom_mixkr"))  # one probe at a time
            b.record_success(0, "bloom_mixkr")
            log.append(b.states()[(0, "bloom_mixkr")])
            log.append(b.allow(0, "bloom_mixkr"))

        log = _run(script, failure_threshold=3, open_s=1.0)
        assert log == [CLOSED, True, ("open", 0, "bloom_mixkr"), OPEN, False,
                       True, HALF_OPEN, False, ("close", 0, "bloom_mixkr"),
                       CLOSED, True]

    def test_probe_failure_reopens(self):
        def script(b, clk, log):
            b.record_failure(0, "cms_mix", RuntimeError("x"))
            log.append(b.states()[(0, "cms_mix")])
            clk.t = 1.1
            log.append(b.allow(0, "cms_mix"))
            b.record_failure(0, "cms_mix", RuntimeError("probe died"))
            log.append(b.states()[(0, "cms_mix")])
            log.append(b.allow(0, "cms_mix"))
            clk.t = 2.5  # a second window elapses
            log.append(b.allow(0, "cms_mix"))
            log.append(b.open_count())

        log = _run(script, failure_threshold=1, open_s=1.0)
        assert log == [("open", 0, "cms_mix"), OPEN, True, OPEN, False, True, 1]

    def test_success_resets_failure_streak(self):
        def script(b, clk, log):
            b.record_failure(0, "hll_add", RuntimeError("x"))
            b.record_failure(0, "hll_add", RuntimeError("x"))
            b.record_success(0, "hll_add")
            b.record_failure(0, "hll_add", RuntimeError("x"))
            log.append(b.states()[(0, "hll_add")])  # the streak broke
            b.force_open(0, "hll_add")
            log.append(sorted(b.state_codes().items()))

        log = _run(script, failure_threshold=3, open_s=1.0)
        assert log == [CLOSED, [(("0", "hll_add"), 1)]]

    def test_transition_callbacks(self):
        def script(b, clk, log):
            b.record_failure(1, "bs_mix", RuntimeError("x"))
            log.append(b.allow(1, "bs_mix"))  # open_s=0: immediate probe
            b.record_success(1, "bs_mix")

        log = _run(script, failure_threshold=1, open_s=0.0)
        assert log == [("open", 1, "bs_mix"), True, ("close", 1, "bs_mix")]

    def test_kind_of_op(self):
        labels = ["bloom_mixkr", "bloom_mixk", "bs_mix", "bitset_get", "hll_add",
                  "cms_mix", "cms_updest", "write_row", "read_row", "copy_row", "op"]
        assert [kind_of_op(x) for x in labels] == [jhealth.kind_of_op(x) for x in labels]
        assert kind_of_op("bloom_mixkr") == "bloom"
        assert kind_of_op("bs_mix") == "bitset"
        assert kind_of_op("bitset_get") == "bitset"
        assert kind_of_op("hll_add") == "hll"
        assert kind_of_op("cms_updest") == "cms"
        assert kind_of_op("write_row") is None

    def test_health_degrades_kind_and_reconciles_on_close(self):
        """DispatchHealth: a breaker opening marks its kind degraded; the
        monitor's probe closes it and the reconcile callback clears the
        kind (polled with a 5 s deadline)."""
        h = health.DispatchHealth(failure_threshold=1, open_s=0.05)
        calls = []
        h.reconcile_cb = lambda kind: calls.append(kind) or True
        h.ensure_probe("cms", lambda: None)
        try:
            assert h.state() == "healthy" and not h.any_degraded
            h.record_failure("cms_mix", RuntimeError("x"))
            assert h.any_degraded and h.degraded_kind("cms")
            assert h.state() in ("degraded", "probing")
            deadline = time.monotonic() + 5.0
            while h.any_degraded:
                assert time.monotonic() < deadline, "no reconcile within 5 s"
                time.sleep(0.01)
            assert calls == ["cms"]
            assert h.summary()["recoveries"] == 1 and h.state() == "healthy"
        finally:
            h.shutdown()
