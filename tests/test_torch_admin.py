"""The port's admin surface — nodes and the failure monitor, the engine's
metrics and profiler, the Prometheus endpoint, ``Config`` JSON and the
JSON bucket — against the JAX package's.

* The JAX package's own tests run again on the port (``TestJsonBucket``,
  ``TestNodesGroup`` — one node per shard of an 8-shard engine included
  — and ``TestProfiler`` of ``test_wave4_objects.py``), rebound by
  ``port_class`` (see ``test_torch_grid_coordination.py``).
* The port's own cases: ``Metrics`` recorded at the coalescer's retire
  and at direct dispatch, the failure monitor's events, the ping's
  timeout on a wedged device, the profiler's refusal to trace a CUDA
  device without CUDA activity, the scrape endpoint, and the client's
  shutdown of the monitor and the endpoint.
* Differential traces: ``get_metrics`` keys, ``Config.to_json`` of the
  same settings and the nodes' ``info`` keys equal the JAX package's.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
import test_wave4_objects as _ref4  # noqa: E402
from redisson_tpu_torch.serve import metrics as port_metrics  # noqa: E402
from redisson_tpu_torch.serve import nodes as port_nodes  # noqa: E402
from test_torch_grid_coordination import (  # noqa: E402,F401
    _one_torch_thread,
    client,
    clients,
    port_class,
    wait_for,
)


class TestJsonBucket(port_class(_ref4.TestJsonBucket)):
    pass


class TestNodesGroup(port_class(_ref4.TestNodesGroup)):
    pass


class TestProfiler(port_class(_ref4.TestProfiler)):
    pass


# -- metrics ----------------------------------------------------------------------


def _bloom(c, name, n=1000):
    bf = c.get_bloom_filter(name)
    bf.try_init(n, 0.01)
    return bf


def test_coalescer_records_every_retired_op(client):
    m0 = client.get_metrics()
    bf = _bloom(client, "m-bf")
    keys = np.arange(300, dtype=np.uint64)
    bf.add_all(keys)
    bf.contains_all(keys[:100])
    bf.add_all_async(keys[:50]).result()
    m = client.get_metrics()
    assert m["ops_total"] - m0["ops_total"] == 450
    assert m["batches_total"] >= 3
    assert m["p99_flush_ms"] >= m["p50_flush_ms"] >= 0.0
    assert m["p99_wait_ms"] >= m["p50_wait_ms"] >= 0.0
    assert m["commands"] == {}


def test_direct_dispatch_records_once_per_outer_call():
    c = rt.create(rt.Config().use_gpu_sketch(device="cpu", coalesce=False,
                                             min_bucket=64))
    try:
        assert c._engine.coalescer is None
        assert c._engine.executor.metrics is c._engine.metrics
        bf = _bloom(c, "d-bf")
        before = c.get_metrics()
        bf.add_all(np.arange(200, dtype=np.uint64))
        bf.contains_all(np.arange(10, dtype=np.uint64))
        m = c.get_metrics()
        assert m["ops_total"] - before["ops_total"] == 210
        assert m["batches_total"] - before["batches_total"] == 2
        assert m["p50_wait_ms"] == 0.0  # nothing queued
    finally:
        c.shutdown()


def test_prewarm_scratch_launches_are_not_recorded():
    """The pre-warmer calls the lock-free bodies against scratch pools:
    they are no user ops and stay out of ops_total."""
    c = rt.create(rt.Config().use_gpu_sketch(device="cpu", coalesce=False,
                                             min_bucket=64, prewarm=True))
    try:
        _bloom(c, "pw-bf")
        assert c.prewarm_wait(60)
        assert c.get_metrics()["ops_total"] == 0
    finally:
        c.shutdown()


def test_metrics_reset_and_percentiles():
    m = port_metrics.Metrics()
    for i in range(1, 5):
        m.record_batch(nops=i, wait_s=i / 1000, flush_s=i / 100)
    s = m.snapshot()
    assert (s["ops_total"], s["batches_total"]) == (10, 4)
    assert s["mean_batch_occupancy"] == 2.5
    assert s["p50_wait_ms"] == pytest.approx(2.0)  # nearest rank
    assert s["p99_flush_ms"] == pytest.approx(40.0)
    m.reset()
    assert m.snapshot()["ops_total"] == 0


def test_get_metrics_flat_keys_match_the_jax_client(clients):
    """The whole key set, nested views (ops, commands, tenants, phases,
    slowlog_len, traces) included, equals the JAX client's."""
    jc, tc = clients
    assert set(tc.get_metrics()) == set(jc.get_metrics())


def test_render_prometheus_holds_both_halves(client):
    _bloom(client, "pr-bf").add_all(np.arange(5, dtype=np.uint64))
    text = client.render_prometheus()
    assert "# TYPE redisson_tpu_ops_total counter" in text
    assert "redisson_tpu_ops_total 5" in text
    assert text.endswith(client.obs.registry.render_prometheus())


def test_metrics_endpoint_serves_and_rebinds(client):
    srv = client.start_metrics_endpoint("127.0.0.1", 0)
    assert client.start_metrics_endpoint("127.0.0.1", 0) is srv
    with pytest.raises(RuntimeError, match="already running"):
        client.start_metrics_endpoint("127.0.0.1", srv.port + 1)
    _bloom(client, "ep-bf").add_all(np.arange(7, dtype=np.uint64))
    body = urllib.request.urlopen(
        f"http://127.0.0.1:{srv.port}/metrics", timeout=10).read().decode()
    assert "redisson_tpu_ops_total 7" in body
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/nope", timeout=10)
    assert ei.value.code == 404


def test_shutdown_stops_monitor_and_endpoint():
    c = rt.create(rt.Config().use_gpu_sketch(device="cpu"))
    srv = c.start_metrics_endpoint()
    mon = c.get_failure_monitor(interval_s=0.05)
    assert c.get_failure_monitor() is mon
    mon.start()
    c.shutdown()
    assert c.is_shutdown()
    assert mon._thread is None
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics", timeout=2)


# -- nodes --------------------------------------------------------------------------


def test_node_is_the_engine_device(client):
    nodes = client.get_nodes_group().get_nodes()
    assert len(nodes) == 1
    n = nodes[0]
    assert n._device == client._engine.executor.device
    assert n.address == "cpu:0"
    info = n.info()
    assert info["device_kind"] == "cpu" and info["shard"] == 0


def test_node_info_keys_match_the_jax_client(clients):
    jc, tc = clients
    ji = jc.get_nodes_group().get_nodes()[0].info()
    ti = tc.get_nodes_group().get_nodes()[0].info()
    assert set(ti) == set(ji) - {"bytes_in_use", "bytes_limit"}
    assert (ti["platform"], ti["device_kind"]) == (ji["platform"], ji["device_kind"])


def test_ping_times_out_on_a_wedged_device(client, monkeypatch):
    release = threading.Event()
    real_ones = torch.ones

    def wedged(*a, **k):
        release.wait(10)
        return real_ones(*a, **k)

    node = client.get_nodes_group().get_nodes()[0]
    monkeypatch.setattr(torch, "ones", wedged)
    t0 = time.monotonic()
    assert node.ping(timeout_seconds=0.1) is False
    assert time.monotonic() - t0 < 5
    # The parked probe is not stacked behind: still down, at once.
    assert node.ping(timeout_seconds=5) is False
    release.set()
    wait_for(lambda: not node._probe_thread.is_alive())
    monkeypatch.setattr(torch, "ones", real_ones)
    assert node.ping() is True


def test_failure_monitor_events_once_per_transition(client, monkeypatch):
    mon = client.get_failure_monitor()
    events = []
    mon.add_listener(events.append)
    assert mon.check_once() == [] and mon.down_shards() == set()
    monkeypatch.setattr(port_nodes.Node, "ping", lambda self, t=30.0: False)
    ev = mon.check_once()
    assert [type(e).__name__ for e in ev] == ["NodeDownEvent"]
    assert mon.check_once() == []  # still down: no second event
    assert mon.down_shards() == {0}
    monkeypatch.setattr(port_nodes.Node, "ping", lambda self, t=30.0: True)
    ev = mon.check_once()
    assert [type(e).__name__ for e in ev] == ["NodeUpEvent"]
    assert [type(e).__name__ for e in events] == ["NodeDownEvent", "NodeUpEvent"]
    assert ev[0].address == "cpu:0"


def test_failure_monitor_thread_sweeps_and_stops(client):
    mon = client.get_failure_monitor(interval_s=0.02)
    calls = []
    orig = mon.check_once
    mon.check_once = lambda: calls.append(1) or orig()
    mon.start()
    mon.start()  # already running: no second thread
    wait_for(lambda: len(calls) >= 3)
    mon.stop()
    assert mon._thread is None and mon.down_shards() == set()


# -- profiler ---------------------------------------------------------------------


def test_profiler_trace_holds_the_ops(tmp_path):
    """The trace holds the annotated region and the torch ops of the
    dispatch.  Host ops are recorded on the thread that started the
    trace, so this client dispatches directly (no coalescer thread); a
    card's kernels are recorded from every thread (chip_smoke 13f)."""
    c = rt.create(rt.Config().use_gpu_sketch(device="cpu", coalesce=False,
                                             min_bucket=64))
    try:
        prof = c.get_profiler()
        assert c.get_profiler() is prof
        assert prof.device == c._engine.executor.device
        bf = _bloom(c, "pf-bf")
        with prof.trace(str(tmp_path)) as p:
            assert p is prof
            with prof.annotate("probe-region"):
                bf.add_all(np.arange(100, dtype=np.uint64))
        assert prof.last_trace.startswith(str(tmp_path))
        with open(prof.last_trace) as f:
            events = json.load(f)["traceEvents"]
        names = {str(e.get("name")) for e in events}
        assert "probe-region" in names
        assert any(n.startswith("aten::") for n in names)
    finally:
        c.shutdown()


def test_profiler_refuses_cuda_without_cuda_activity(monkeypatch, tmp_path):
    prof = port_metrics.Profiler("cuda")
    monkeypatch.setattr(
        torch.profiler, "supported_activities",
        lambda: {torch.profiler.ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="no CUDA activity"):
        prof.start(str(tmp_path))
    assert prof._active is False  # a refused start leaves it idle


def test_profiler_stop_without_start_raises(client):
    with pytest.raises(RuntimeError, match="no active"):
        client.get_profiler().stop()


def test_device_memory_on_cpu_matches_the_jax_shape(clients):
    jc, tc = clients
    assert tc.get_profiler().device_memory() == {"cpu:0": {}}
    jm = jc.get_profiler().device_memory()
    assert "cpu:0" in jm and all(k.startswith("cpu:") for k in jm)


# -- Config JSON ------------------------------------------------------------------


def _settings(cfg, codec):
    cfg.set_codec(codec)
    cfg.threads = 7
    cfg.snapshot_dir = "/var/lib/rtpu"
    cfg.snapshot_interval_s = 30.0
    cfg.retry_attempts = 5
    cfg.retry_interval_ms = 250
    cfg.requirepass = "s3cret"
    cfg.resp_reactor_threads = 2
    return cfg


def test_config_json_round_trip_and_shared_keys():
    from redisson_tpu.codecs import LongCodec as JLong
    from redisson_tpu_torch.codecs import LongCodec as TLong

    jcfg = _settings(redisson_tpu.Config().use_tpu_sketch(batch_window_us=300), JLong())
    tcfg = _settings(rt.Config().use_gpu_sketch(device="cpu", batch_window_us=300), TLong())
    jd, td = json.loads(jcfg.to_json()), json.loads(tcfg.to_json())
    shared = set(td) - {"gpu_sketch"}
    assert shared <= set(jd)
    assert {k: td[k] for k in shared} == {k: jd[k] for k in shared}
    assert td["gpu_sketch"]["batch_window_us"] == jd["tpu_sketch"]["batch_window_us"]
    again = rt.Config.from_json(tcfg.to_json())
    assert again.to_dict() == tcfg.to_dict()
    assert type(again.codec).__name__ == "LongCodec"
    with pytest.raises(ValueError, match="unknown config key"):
        rt.Config.from_json(json.dumps({"no_such_key": 1}))
    with pytest.raises(json.JSONDecodeError):
        rt.Config.from_json("{")
