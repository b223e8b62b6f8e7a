"""The port's BatchCoalescer core: per-pool FIFO with merging, the drain
barrier, failure attribution, backpressure and shutdown."""

import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from redisson_tpu_torch.executor.coalescer import BatchCoalescer, HintedFuture  # noqa: E402
from redisson_tpu_torch.executor.failures import KernelExecutionError  # noqa: E402
from redisson_tpu_torch.executor.torch_executor import LazyResult  # noqa: E402


@pytest.fixture
def coalescer():
    c = BatchCoalescer(batch_window_us=50_000, max_batch=64, max_queued_ops=128)
    yield c
    c.shutdown()


def test_ops_of_one_pool_apply_in_order_and_merge(coalescer):
    launches = []
    state = []

    def dispatch(cols):
        launches.append(len(cols[0]))
        state.extend(cols[0].tolist())
        return LazyResult(np.asarray(cols[0]) * 2)

    futs = [coalescer.submit(("k",), dispatch, (np.arange(i * 4, i * 4 + 4),), 4,
                             pool_key="p") for i in range(10)]
    got = [HintedFuture(f, coalescer).result(5) for f in futs]
    assert state == list(range(40))  # arrival order, one pool
    assert [list(g) for g in got] == [[2 * x for x in range(i * 4, i * 4 + 4)]
                                      for i in range(10)]
    assert len(launches) < 10 and sum(launches) == 40  # submits coalesced


def test_failed_dispatch_attributes_each_op_range(coalescer):
    def boom(cols):
        raise RuntimeError("device gone")

    f1 = coalescer.submit(("bad",), boom, (np.zeros(3),), 3)
    f2 = coalescer.submit(("bad",), boom, (np.zeros(5),), 5)
    coalescer.flush_hint()
    with pytest.raises(KernelExecutionError) as e1:
        f1.result(5)
    with pytest.raises(KernelExecutionError) as e2:
        f2.result(5)
    assert (e1.value.op_start, e1.value.op_count) == (0, 3)
    assert (e2.value.op_start, e2.value.op_count) == (3, 5)
    # The launch slot came back: later work still flows.
    ok = coalescer.submit(("ok",), lambda cols: LazyResult(cols[0]), (np.ones(2),), 2)
    assert list(HintedFuture(ok, coalescer).result(5)) == [1, 1]


def test_drain_waits_for_prior_dispatches_and_backpressure_admits(coalescer):
    seen = []
    gate = threading.Event()

    def slow(cols):
        gate.wait(5)
        seen.append(len(cols[0]))
        return LazyResult(cols[0])

    futs = [coalescer.submit(("s",), slow, (np.zeros(60),), 60) for _ in range(2)]
    blocked = threading.Thread(  # 120 queued + 60 > 128: waits for the flush
        target=lambda: futs.append(coalescer.submit(("s",), slow, (np.zeros(60),), 60)))
    blocked.start()
    gate.set()
    blocked.join(5)
    assert not blocked.is_alive() and len(futs) == 3
    coalescer.drain(5)
    assert sum(seen) == 180
    assert all(len(HintedFuture(f, coalescer).result(5)) == 60 for f in futs)


def test_shutdown_refuses_new_work():
    c = BatchCoalescer(batch_window_us=100, max_batch=8)
    c.shutdown()
    with pytest.raises(RuntimeError):
        c.submit(("x",), lambda cols: None, (np.zeros(1),), 1)
