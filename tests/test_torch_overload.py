"""The port's overload control plane: deadlines, admission control,
per-tenant shedding, fetch timeouts.

Counterparts of ``TestDeadlineScope``, ``TestTenantGovernor``, the
coalescer- and engine-level deadline tests and ``TestDirectDispatchDeadlines``
of ``tests/test_overload.py``.  The governor cases run one scripted
admit/throttle/release sequence on the port's and the JAX package's
``TenantGovernor`` under an injected clock and require equal outcomes.
No case races a short sleep: a dispatch that must be "in flight" signals
an event, and a lapsed deadline is waited out by polling the clock.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from redisson_tpu.tenancy.registry import TenantGovernor as JaxGovernor  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
from redisson_tpu_torch import chaos, overload  # noqa: E402
from redisson_tpu_torch.codecs import LongCodec  # noqa: E402
from redisson_tpu_torch.executor.coalescer import BatchCoalescer, HintedFuture  # noqa: E402
from redisson_tpu_torch.executor.failures import (  # noqa: E402
    DeadlineExceededError,
    DispatchTimeoutError,
    TenantThrottledError,
)
from redisson_tpu_torch.obs import Observability, total  # noqa: E402
from redisson_tpu_torch.tenancy.registry import TenantGovernor  # noqa: E402

WAIT_S = 5.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _chaos_off():
    chaos.clear()
    chaos.reset_counts()
    yield
    chaos.clear()
    chaos.reset_counts()


def make_client(**kw):
    kw.setdefault("batch_window_us", 100)
    kw.setdefault("min_bucket", 64)
    # Breakers stay out of the way unless a test wants them.
    kw.setdefault("breaker_failure_threshold", 10_000)
    cfg = rt.Config().set_codec(LongCodec()).use_gpu_sketch(device="cpu", **kw)
    cfg.retry_attempts = 2
    cfg.retry_interval_ms = 5
    return rt.create(cfg)


class _FakeLazy:
    def __init__(self, value):
        self._v = value

    def result(self):
        return self._v


class _BlockingLazy:
    def __init__(self, gate, value):
        self._gate = gate
        self._v = value

    def result(self):
        self._gate.wait(10.0)
        return self._v


class _FakeHealth:
    def __init__(self):
        self.failures = []

    def allow_dispatch(self, op):
        return True

    def record_failure(self, op, exc=None):
        self.failures.append((op, exc))

    def record_success(self, op):
        pass


def _await_past(deadline: float) -> None:
    while time.monotonic() <= deadline:
        time.sleep(0.005)


# -- deadline scope ----------------------------------------------------------


class TestDeadlineScope:
    def test_nesting_inner_wins_and_restores(self):
        assert overload.current_deadline() is None
        with overload.deadline_scope(10.0):
            outer = overload.current_deadline()
            assert outer is not None
            with overload.deadline_scope(0.5):
                assert overload.current_deadline() < outer
            assert overload.current_deadline() == outer
        assert overload.current_deadline() is None

    def test_none_frame_shadows_outer(self):
        with overload.deadline_scope(1.0):
            with overload.deadline_scope(None):
                assert overload.current_deadline() is None
            assert overload.current_deadline() is not None
        with pytest.raises(ValueError):
            overload.deadline_scope(1.0, at=5.0)
        assert overload.remaining(None) is None
        assert overload.remaining(10.0, now=4.0) == 6.0

    def test_thread_isolation(self):
        seen = []
        with overload.deadline_scope(5.0):
            t = threading.Thread(target=lambda: seen.append(overload.current_deadline()))
            t.start()
            t.join(WAIT_S)
        assert not t.is_alive() and seen == [None]

    def test_client_op_deadline_defaults_to_config(self):
        c = make_client(op_deadline_ms=250)
        try:
            with c.op_deadline():
                rem = overload.remaining(overload.current_deadline())
                assert 0 < rem <= 0.25
            with c.op_deadline(0):
                assert overload.current_deadline() is None
        finally:
            c.shutdown()


# -- tenant governor: one script on both packages -----------------------------


def _script(make, steps):
    """Run ``steps`` (("admit"|"release"|"clock"|"limits"|"peek", ...))
    on a governor built by ``make(clock)``; returns the outcomes."""
    clock = [0.0]
    g = make(lambda: clock[0])
    out = []
    for op, *args in steps:
        if op == "clock":
            clock[0] = args[0]
        elif op == "admit":
            try:
                g.admit(*args)
                out.append("ok")
            except Exception as e:
                out.append(("throttled", type(e).__name__, e.reason))
        elif op == "release":
            g.release(*args)
        elif op == "limits":
            g.set_limits(**args[0])
            out.append(("active", g.active))
        elif op == "peek":
            out.append(("peek", g.peek_over_quota(args[0])))
    st = g.stats()
    out.append(("stats", st["throttled_ops"], st["tenants_tracked"]))
    return out


def _both(kw, steps):
    mine = _script(lambda clk: TenantGovernor(clock=clk, **kw), steps)
    ref = _script(lambda clk: JaxGovernor(clock=clk, **kw), steps)
    assert mine == ref
    return mine


class TestTenantGovernor:
    def test_rate_limit_sheds_over_quota_only(self):
        out = _both(dict(rate_limit=100.0, burst=100.0), [
            ("admit", "a", 100), ("admit", "a", 1), ("peek", "a"),
            ("admit", "b", 100), ("clock", 0.5), ("admit", "a", 50),
            ("admit", "a", 1)])
        assert out[:2] == ["ok", ("throttled", "TenantThrottledError", "rate")]
        assert out[2] == ("peek", True) and out[3:6] == ["ok", "ok", out[1]]

    def test_full_bucket_admits_oversize_with_debt(self):
        out = _both(dict(rate_limit=10.0, burst=20.0), [
            ("admit", "a", 500), ("admit", "a", 1), ("clock", 60.0),
            ("admit", "a", 1)])
        assert [o if o == "ok" else o[2] for o in out[:3]] == ["ok", "rate", "ok"]

    def test_inflight_quota_and_release(self):
        out = _both(dict(max_inflight=10), [
            ("admit", "a", 8), ("admit", "a", 4), ("release", "a", 8),
            ("admit", "a", 10)])
        assert out[:3] == ["ok", ("throttled", "TenantThrottledError", "inflight"), "ok"]

    def test_inflight_oversize_single_submit_admitted_when_idle(self):
        out = _both(dict(max_inflight=100), [
            ("admit", "a", 512), ("admit", "a", 1), ("release", "a", 512),
            ("admit", "a", 512)])
        assert out[0] == "ok" and out[1][0] == "throttled" and out[2] == "ok"

    def test_set_limits_live(self):
        out = _both({}, [
            ("admit", "a", 10_000), ("limits", dict(rate_limit=1.0, burst=1.0)),
            ("admit", "a", 1), ("admit", "a", 1)])
        assert out[:3] == ["ok", ("active", True), "ok"] and out[3][0] == "throttled"

    def test_disable_reenable_inflight_does_not_leak(self):
        out = _both(dict(max_inflight=1000), [
            ("admit", "a", 500), ("limits", dict(max_inflight=0)),
            ("admit", "a", 10_000), ("limits", dict(max_inflight=400)),
            ("admit", "a", 400), ("release", "a", 500), ("release", "a", 500),
            ("admit", "a", 400)])
        assert all(o == "ok" for o in out if isinstance(o, str))
        assert "throttled" not in str(out[:-1])

    def test_obs_counts_throttled_ops(self):
        obs = Observability()
        g = TenantGovernor(rate_limit=1.0, burst=1.0, obs=obs, clock=lambda: 0.0)
        g.admit("t", 1)
        with pytest.raises(TenantThrottledError):
            g.admit("t", 7)
        assert obs.tenant_throttled.get(("t",)) == 7
        assert obs.shed_ops.get(("tenant",)) == 7


# -- coalescer: deadlines and admission ---------------------------------------


def _mk(**kw):
    kw.setdefault("batch_window_us", 200)
    kw.setdefault("max_batch", 1024)
    return BatchCoalescer(**kw)


def _cols(n=8):
    return (np.arange(n, dtype=np.int64),)


def test_expired_deadline_sheds_at_submit():
    obs = Observability()
    c = _mk(obs=obs)
    try:
        with pytest.raises(DeadlineExceededError) as ei:
            c.submit(("k",), lambda cols: _FakeLazy(cols[0]), _cols(), 8,
                     deadline=time.monotonic() - 0.01)
        assert ei.value.stage == "submit"
        assert obs.deadline_exceeded.get(("submit",)) == 8
    finally:
        c.shutdown()


def test_admission_sheds_on_pressure_bias():
    """``overload.pressure`` inflates the wait estimate: a deadline-carrying
    submit sheds fast, a no-deadline submit still queues and completes."""
    chaos.inject("overload.pressure", kind="pressure", rate=1.0, latency_s=30.0)
    c = _mk()
    try:
        with pytest.raises(DeadlineExceededError) as ei:
            c.submit(("k",), lambda cols: _FakeLazy(cols[0]), _cols(), 8,
                     deadline=time.monotonic() + 1.0)
        assert ei.value.stage == "admission"
        fut = c.submit(("k",), lambda cols: _FakeLazy(cols[0]), _cols(), 8)
        assert HintedFuture(fut, c).result(timeout=WAIT_S) is not None
    finally:
        chaos.clear()
        c.shutdown()


def test_queued_segment_expired_is_shed_pre_dispatch():
    """A segment stuck behind a slow launch whose deadline lapses is shed
    without ever dispatching; the op ahead is untouched."""
    gate, entered = threading.Event(), threading.Event()
    b_dispatched = []

    def slow(cols):
        entered.set()
        gate.wait(10.0)
        return _FakeLazy(cols[0])

    def fast(cols):
        b_dispatched.append(1)
        return _FakeLazy(cols[0])

    c = _mk(batch_window_us=100)
    try:
        fa = c.submit(("a",), slow, _cols(), 8)
        c.flush_hint()
        assert entered.wait(WAIT_S)  # the flush thread is inside slow()
        dl = time.monotonic() + 0.05
        fb = c.submit(("b",), fast, _cols(), 8, deadline=dl)
        _await_past(dl)  # lapses while 'a' holds the flush thread
        gate.set()
        with pytest.raises(DeadlineExceededError) as ei:
            HintedFuture(fb, c).result(timeout=WAIT_S)
        assert ei.value.stage == "queue"
        assert not b_dispatched  # shed strictly pre-dispatch
        assert HintedFuture(fa, c).result(timeout=WAIT_S) is not None
    finally:
        gate.set()
        c.shutdown()


def test_parked_backoff_all_expired_dropped_fast():
    """A parked (retry-backoff) segment whose every op expired is dropped
    with its futures resolved, not after the backoff."""
    def dispatch(cols):
        raise RuntimeError("transient")

    c = _mk(retry_attempts=10, retry_interval_s=5.0, retry_max_backoff_s=5.0)
    try:
        fut = c.submit(("k",), dispatch, _cols(), 8, deadline=time.monotonic() + 0.25)
        t0 = time.monotonic()
        with pytest.raises(DeadlineExceededError):
            fut.result(timeout=10.0)
        assert time.monotonic() - t0 < 2.0  # the backoff alone is 5 s
    finally:
        c.shutdown()


def test_fetch_timeout_from_config_records_breaker_failure():
    """A no-deadline .result() is bounded by fetch_timeout_s; tripping it
    records a breaker failure and rtpu_fetch_timeouts."""
    gate = threading.Event()
    health = _FakeHealth()
    obs = Observability()
    c = _mk(fetch_timeout_s=0.2, health=health, obs=obs)
    try:
        fut = c.submit(("bloom_mixkr",), lambda cols: _BlockingLazy(gate, cols[0]),
                       _cols(), 8)
        hf = HintedFuture(fut, c, op="bloom_mixkr")
        t0 = time.monotonic()
        with pytest.raises(DispatchTimeoutError):
            hf.result()
        assert time.monotonic() - t0 < 2.0
        assert health.failures and health.failures[0][0] == "bloom_mixkr"
        assert total(obs.fetch_timeouts) == 1
    finally:
        gate.set()
        c.shutdown()


def test_deadline_bounded_wait_is_not_a_device_failure():
    gate = threading.Event()
    health = _FakeHealth()
    c = _mk(fetch_timeout_s=30.0, health=health)
    try:
        dl = time.monotonic() + 0.15
        fut = c.submit(("k",), lambda cols: _BlockingLazy(gate, cols[0]), _cols(), 8,
                       deadline=dl)
        with pytest.raises(DeadlineExceededError) as ei:
            HintedFuture(fut, c, deadline=dl, op="k").result()
        assert ei.value.stage == "fetch_wait"
        assert not health.failures
    finally:
        gate.set()
        c.shutdown()


def _fill_queue(c, gate, entered):
    """Key 'a' holds the flush thread inside its dispatch; key 'b' stays
    queued, holding the 64-op bound."""
    def dispatch(cols):
        entered.set()
        gate.wait(WAIT_S)
        return _FakeLazy(np.concatenate(cols) if len(cols) > 1 else cols[0])

    futs = [c.submit(("a",), dispatch, _cols(32), 32)]
    c.flush_hint()
    assert entered.wait(WAIT_S)
    futs.append(c.submit(("b",), dispatch, _cols(40), 40))
    return dispatch, futs


def test_no_deadline_submit_still_blocks_at_queue_bound():
    gate, entered = threading.Event(), threading.Event()
    c = _mk(max_queued_ops=64, max_inflight=1)
    try:
        dispatch, futs = _fill_queue(c, gate, entered)
        done = threading.Event()

        def producer():
            futs.append(c.submit(("c",), dispatch, _cols(64), 64))
            done.set()

        threading.Thread(target=producer, daemon=True).start()
        deadline = time.monotonic() + WAIT_S
        while not c._admit_q:  # the producer is queued at the bound
            assert time.monotonic() < deadline
            time.sleep(0.005)
        assert not done.is_set()  # blocked, not shed
        gate.set()
        assert done.wait(WAIT_S)
        for f in futs:
            HintedFuture(f, c).result(timeout=WAIT_S)
    finally:
        gate.set()
        c.shutdown()


def test_deadline_bounded_queue_wait_sheds_instead_of_blocking():
    gate, entered = threading.Event(), threading.Event()
    c = _mk(max_queued_ops=64, max_inflight=1)
    try:
        dispatch, _ = _fill_queue(c, gate, entered)
        t0 = time.monotonic()
        with pytest.raises(DeadlineExceededError) as ei:
            c.submit(("c",), dispatch, _cols(64), 64, deadline=time.monotonic() + 0.2)
        assert ei.value.stage == "queue"
        assert time.monotonic() - t0 < 2.0
    finally:
        gate.set()
        c.shutdown()


def test_admission_estimator_tracks_phase_flip():
    """The put-RT EWMA corrects the admission estimate in both directions
    (synthetic retirement samples, no wall-clock dependence)."""
    c = _mk(max_batch=64, max_inflight=8)
    try:
        c._service_ewma_s = 0.005
        c._ops_per_launch_ewma = 8.0
        with c._lock:
            c._queued_ops = 64  # 8 launches queued ahead
        assert c.estimate_wait_s() < 0.1
        for _ in range(3):
            c._release_launch_slot(0.5, genuine=False)
        assert c._put_rt_ewma > c.slow_launch_s
        assert c.estimate_wait_s() > 0.5  # floored by the phase signal
        assert c._inflight_limit < 8  # AIMD halved on slow retirements
        with pytest.raises(DeadlineExceededError) as ei:
            c.submit(("k",), lambda cols: _FakeLazy(cols[0]), _cols(), 8,
                     deadline=time.monotonic() + 0.2)
        assert ei.value.stage == "admission"
        c._service_ewma_s = 1.0
        for _ in range(8):
            c._release_launch_slot(0.01, genuine=True)
        assert c._put_rt_ewma < c.fast_launch_s
        assert c.estimate_wait_s() <= c.slow_launch_s
        with c._lock:
            c._queued_ops = 0
        fut = c.submit(("k",), lambda cols: _FakeLazy(cols[0]), _cols(), 8,
                       deadline=time.monotonic() + 5.0)
        assert HintedFuture(fut, c).result(timeout=10.0) is not None
    finally:
        c.shutdown()


def test_phase_service_neutral_between_thresholds_and_merge_cap():
    c = _mk(max_batch_slow_phase=4096)
    try:
        c._service_ewma_s = 0.02
        c._put_rt_ewma = 0.1  # between fast (0.08) and slow (0.25)
        assert c._phase_service_s() == 0.02 and c.merge_cap() == 1024
        c._put_rt_ewma = 0.0
        assert c._phase_service_s() == 0.02
        c._put_rt_ewma = 1.0  # slow phase: backlogs merge past max_batch
        assert c.merge_cap() == 4096
    finally:
        c.shutdown()


def test_backoff_is_jittered_exponential_and_capped():
    c = _mk(retry_interval_s=0.1, retry_max_backoff_s=0.5, retry_jitter=0.2)
    try:
        for attempt, base in ((1, 0.1), (2, 0.2), (3, 0.4), (4, 0.5), (9, 0.5)):
            b = c._backoff_s(attempt)
            assert 0.8 * base - 1e-12 <= b <= 1.2 * base + 1e-12
    finally:
        c.shutdown()


def test_adaptive_window_moves_with_load():
    c = _mk(batch_window_us=1000, max_batch=1024)
    try:
        assert (c.min_window_s, c.max_window_s) == (0.0005, 0.008)
        with c._lock:
            c._rate_mark = (time.monotonic() - 0.05, 0)
            c._ops_seen = 10**6  # a flood: pressure 1
            c._update_window_locked()
            assert c.window_s == pytest.approx(c.max_window_s)
            c._rate_ewma = 0.0
            c._rate_mark = (time.monotonic() - 1.0, c._ops_seen)
            c._update_window_locked()  # silence: back toward the minimum
            assert c.window_s < 0.001
    finally:
        c.shutdown()


# -- engine level -------------------------------------------------------------


class TestEngineDeadlines:
    def test_injected_latency_converts_to_fast_deadline_error(self):
        client = make_client()
        try:
            bf = client.get_bloom_filter("dl")
            bf.try_init(10_000, 0.01)
            keys = np.arange(32, dtype=np.uint64)
            bf.add_all_async(keys).result(timeout=WAIT_S)
            chaos.inject("dispatch", kind="latency", rate=1.0, seed=1, latency_s=0.5)
            t0 = time.monotonic()
            with pytest.raises(DeadlineExceededError):
                with client.op_deadline(100):
                    bf.contains_all_async(keys).result()
            assert time.monotonic() - t0 < WAIT_S
            chaos.clear()
            assert bf.contains_all(keys) == len(keys)  # recovers
        finally:
            chaos.clear()
            client.shutdown()

    def test_acked_writes_never_shed(self):
        """Under fault injection and deadlines, every write the caller saw
        acked is present afterwards (shedding is strictly pre-dispatch)."""
        client = make_client()
        try:
            bf = client.get_bloom_filter("acked")
            bf.try_init(50_000, 0.01)
            chaos.inject("dispatch", kind="error", rate=0.4, seed=7)
            acked, failed = [], 0
            for i in range(60):
                keys = np.arange(i * 8, i * 8 + 8, dtype=np.uint64)
                try:
                    with client.op_deadline(500):
                        fut = bf.add_all_async(keys)
                    fut.result()
                    acked.append(keys)
                except Exception:
                    failed += 1
            chaos.clear()
            assert acked and failed
            for keys in acked:
                assert bf.contains_all(keys) == len(keys), "acked write lost"
        finally:
            chaos.clear()
            client.shutdown()

    def test_pressure_sheds_deadline_calls_without_a_launch(self):
        client = make_client()
        try:
            bf = client.get_bloom_filter("press")
            bf.try_init(10_000, 0.01)
            ex = client._engine.executor
            launches = []
            orig = ex.bloom_mixed_keys_runs
            ex.bloom_mixed_keys_runs = lambda *a: launches.append(1) or orig(*a)
            chaos.inject("overload.pressure", kind="pressure", rate=1.0, latency_s=30.0)
            for i in range(20):
                with pytest.raises(DeadlineExceededError):
                    with client.op_deadline(50):
                        bf.add(i)
            assert not launches
            assert bf.add(10**6) is True and launches  # no deadline: flows
            obs = client._engine.obs
            assert obs.shed_ops.get(("admission",)) == 20
            assert obs.deadline_exceeded.get(("admission",)) == 20
        finally:
            chaos.clear()
            client.shutdown()

    def test_tenant_governor_sheds_burster_not_victim(self):
        client = make_client(tenant_rate_limit=1_000, tenant_burst_ops=500)
        try:
            victim = client.get_bloom_filter("victim")
            victim.try_init(10_000, 0.01)
            burster = client.get_bloom_filter("burster")
            burster.try_init(10_000, 0.01)
            keys = np.arange(32, dtype=np.uint64)
            victim.add_all_async(keys).result(timeout=WAIT_S)
            burst_shed = 0
            for _ in range(8):  # 8 x 1024 ops back to back >> the quota
                try:
                    burster.add_all_async(np.arange(1024, dtype=np.uint64)).result()
                except TenantThrottledError:
                    burst_shed += 1
                assert victim.contains_all_async(keys).result().all()
            assert burst_shed > 0
            assert client._engine.governor.stats()["throttled_ops"] > 0
            assert client._engine.obs.tenant_throttled.get(("burster",)) > 0
        finally:
            client.shutdown()

    def test_inflight_quota_released_on_completion(self):
        client = make_client(tenant_max_inflight=64)
        try:
            bf = client.get_bloom_filter("q")
            bf.try_init(10_000, 0.01)
            for i in range(20):  # each call's ops are released at resolve
                bf.add_all_async(np.arange(i * 64, (i + 1) * 64, dtype=np.uint64)).result()
            deadline = time.monotonic() + WAIT_S
            while client._engine.governor._inflight:
                assert time.monotonic() < deadline
                time.sleep(0.005)
        finally:
            client.shutdown()


class TestDirectDispatchDeadlines:
    def test_expired_deadline_sheds_before_direct_dispatch(self):
        client = make_client(coalesce=False)
        try:
            bf = client.get_bloom_filter("direct-dl")
            bf.try_init(10_000, 0.01)
            warm = np.arange(16, dtype=np.uint64)
            late = np.arange(100, 116, dtype=np.uint64)
            bf.add_all(warm)
            with overload.deadline_scope(at=time.monotonic() - 0.01):
                with pytest.raises(DeadlineExceededError) as ei:
                    bf.add_all(late)
            assert ei.value.stage == "direct"
            assert bf.contains_all(late) == 0
            assert bf.contains_all(warm) == len(warm)
            obs = client._engine.obs
            assert obs.deadline_exceeded.get(("direct",)) >= len(late)
            assert obs.shed_ops.get(("deadline",)) >= len(late)
            bf.add_all(late)
            assert bf.contains_all(late) == len(late)
        finally:
            client.shutdown()

    def test_direct_reads_and_k1_shed_too(self):
        client = make_client(coalesce=False)
        try:
            bf = client.get_bloom_filter("direct-dl-read")
            bf.try_init(10_000, 0.01)
            keys = np.arange(16, dtype=np.uint64)
            bf.add_all(keys)
            cms = client.get_count_min_sketch("direct-cms")
            cms.try_init(4, 256)
            with overload.deadline_scope(at=time.monotonic() - 0.01):
                with pytest.raises(DeadlineExceededError):
                    bf.contains_all(keys)
                with pytest.raises(DeadlineExceededError):
                    cms.add_all_seq(keys)
            assert cms.total_count() == 0  # never reached K1
        finally:
            client.shutdown()

    def test_row_maintenance_exempt_mid_compound_op(self):
        client = make_client(coalesce=False)
        try:
            bf = client.get_bloom_filter("direct-maint")
            bf.try_init(10_000, 0.01)
            bf.add_all(np.arange(8, dtype=np.uint64))
            with overload.deadline_scope(at=time.monotonic() - 0.01):
                assert client._engine.delete("direct-maint") is True
            bf2 = client.get_bloom_filter("direct-maint")
            bf2.try_init(10_000, 0.01)
            assert bf2.contains_all(np.arange(8, dtype=np.uint64)) == 0
        finally:
            client.shutdown()
