"""The port's distributed tracing and LATENCY monitor against the JAX
package's.

* ``tests/test_trace.py`` runs again on the port (``port_module`` of
  ``test_torch_observability.py``): the tracer core, the latency monitor,
  the engine stitching (direct-API traces, fused launches' parent links,
  dedup of coalesced submits), the RESP surface (TRACE, CONFIG,
  the one-shot RTPU.TRACE prelude and its passage over ASKING, SLOWLOG's
  trace ids, LATENCY, the fsync-stall event under chaos, MONITOR), the
  cluster client's CROSSSLOT guard, and the three-node scatter/gather
  trace (``slow``; its supervisor's nodes run with ``--device cpu``,
  ``cpu_builtins`` of ``test_torch_cluster.py``).
* Pure modules under an injected clock and seeded ids: a ``Tracer`` at
  sample rate 1.0 and a ``LatencyMonitor`` fed the same seeded inputs in
  both packages give equal snapshots.
* Port hooks the reference files reach only through cluster fixtures:
  the residency manager's ``residency:<kind>`` span, and WAIT's
  ``journal_fsync_fence`` child span.
"""

import random
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu_torch as rt  # noqa: E402
import test_trace as _ref  # noqa: E402
from redisson_tpu_torch.obs import trace as port_trace  # noqa: E402
from test_torch_cluster import cpu_builtins, port_namespace  # noqa: E402
from test_torch_observability import _Clock, port_module  # noqa: E402
from test_torch_grid_coordination import _one_torch_thread  # noqa: E402,F401

port_module(_ref, globals(), skip={"test_three_node_scatter_gather_yields_one_trace"})
test_three_node_scatter_gather_yields_one_trace = port_namespace(
    _ref, cpu_builtins)["test_three_node_scatter_gather_yields_one_trace"]


# -- pure modules under an injected clock -----------------------------------------


class _Os(types.ModuleType):
    """An ``os`` module whose urandom is a seeded stream."""

    def __init__(self, seed):
        super().__init__("os")
        self._rng = np.random.default_rng(seed)

    def urandom(self, n):
        return bytes(self._rng.integers(0, 256, n, dtype=np.uint8))


def _tracer_snapshot(mod, seed):
    clock = _Clock()
    saved = mod.time, mod.os
    mod.time, mod.os = clock, _Os(seed)
    rng = np.random.default_rng(seed + 100)
    t = mod.Tracer(sample_rate=1.0, max_spans=64)
    try:
        t._rng = random.Random(seed)
        for i in range(40):
            clock.t += float(rng.integers(1, 9)) / 1000
            root = t.maybe_start(f"req{i}")
            if root is None:  # the dice missed (rate 0.5 from i = 31)
                continue
            child = t.start_child(root, "child")
            child.annotate("n", int(rng.integers(0, 100)))
            clock.t += float(rng.integers(1, 9)) / 1000
            child.end(error=bool(i % 5 == 0))
            t.record_span(root.ctx(), "launch:bloom", clock.t, 0.002,
                          {"nops": i, "links": 1})
            if i % 7:
                root.end()
            else:
                root.abandon()
            if i == 30:
                t.set_sample_rate(0.5)
        return t.spans(), t.traces_json(), t.stats()
    finally:
        t.set_sample_rate(0.0)
        mod.time, mod.os = saved


def test_tracer_equals_the_jax_tracer():
    from redisson_tpu.obs import trace as jmod

    for seed in range(3):
        assert _tracer_snapshot(port_trace, seed) == _tracer_snapshot(jmod, seed)
    assert port_trace.ENABLED is False


def _latency_snapshot(mod, seed):
    clock = _Clock()
    mod.time, saved = clock, mod.time
    rng = np.random.default_rng(seed)
    try:
        lat = mod.LatencyMonitor(threshold_ms=5)
        events = ["command", "slow-launch", "fsync-stall", "breaker-open",
                  "reconcile", "full-resync"]
        for _ in range(600):
            clock.t += float(rng.integers(0, 3))
            lat.record(events[int(rng.integers(0, len(events)))],
                       float(rng.integers(0, 40)) + 0.5)
        lat.reset("reconcile")
        return lat.latest(), [lat.history(e) for e in events], \
            lat.doctor(), lat.stats()
    finally:
        mod.time = saved


def test_latency_monitor_equals_the_jax_monitor():
    from redisson_tpu.obs import latency as jmod
    from redisson_tpu_torch.obs import latency as tmod

    for seed in range(3):
        assert _latency_snapshot(tmod, seed) == _latency_snapshot(jmod, seed)


# -- port hooks -----------------------------------------------------------------


def _traced_client(tmp_path=None, **kw):
    cfg = rt.Config().use_gpu_sketch(device="cpu", min_bucket=64, **kw)
    cfg.trace_sample_rate = 1.0
    if tmp_path is not None:
        cfg.journal_dir = str(tmp_path / "journal")
        cfg.journal_fsync = "always"
    return rt.create(cfg)


def test_residency_transition_opens_a_span():
    cl = _traced_client()
    try:
        bf = cl.get_bloom_filter("res-bf")
        bf.try_init(1000, 0.01)
        bf.add_all(np.arange(10, dtype=np.uint64))
        assert cl._engine.residency.demote("res-bf")
        assert cl._engine.residency.promote("res-bf")
        assert bf.contains_all(np.arange(10, dtype=np.uint64)) == 10
        spans = cl.obs.trace.spans()
        by = {s["name"]: s for s in spans}
        for kind in ("demote", "promote"):
            s = by["residency:" + kind]
            assert s["attrs"]["object"] == "res-bf" and not s["error"]
        kinds = [e["kind"] for e in cl.obs.events.snapshot(kind="residency.")]
        assert kinds == ["residency.demote", "residency.promote"]
    finally:
        cl.obs.trace.set_sample_rate(0.0)
        cl.shutdown()


def test_traced_wait_records_the_fsync_fence(tmp_path):
    from redisson_tpu_torch.serve.resp import RespServer
    from redisson_tpu_torch.serve.wireutil import exchange
    import socket

    cl = _traced_client(tmp_path)
    srv = RespServer(cl)
    s = socket.create_connection((srv.host, srv.port))
    try:
        r = exchange(s, [("SET", "w", "1"), ("WAIT", "0", "1000")])
        assert r == [b"OK", 0]
        names = [sp["name"] for sp in cl.obs.trace.spans()]
        assert "journal_fsync_fence" in names and "resp:WAIT" in names
        fence = next(sp for sp in cl.obs.trace.spans()
                     if sp["name"] == "journal_fsync_fence")
        wait = next(sp for sp in cl.obs.trace.spans()
                    if sp["name"] == "resp:WAIT")
        assert fence["parent_id"] == wait["span_id"]
    finally:
        s.close()
        srv.close()
        cl.obs.trace.set_sample_rate(0.0)
        cl.shutdown()
