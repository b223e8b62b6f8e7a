"""The port's distributed tracing and LATENCY monitor against the JAX
package's.

* ``tests/test_trace.py`` runs again on the port (``port_module`` of
  ``test_torch_observability.py``; the two cases that look for the JAX
  launch phase ``device_dispatch`` in a launch span are written out as
  port cases of the same names, which look for the port's five phases):
  the tracer core, the latency monitor,
  the engine stitching (direct-API traces, fused launches' parent links,
  dedup of coalesced submits), the RESP surface (TRACE, CONFIG,
  the one-shot RTPU.TRACE prelude and its passage over ASKING, SLOWLOG's
  trace ids, LATENCY, the fsync-stall event under chaos, MONITOR), the
  cluster client's CROSSSLOT guard, and the three-node scatter/gather
  trace (``slow``; its supervisor's nodes run with ``--device cpu``).
* Pure modules under an injected clock and seeded ids: a ``Tracer`` at
  sample rate 1.0 and a ``LatencyMonitor`` fed the same seeded inputs in
  both packages give equal snapshots.
* Port hooks the reference files reach only through cluster fixtures:
  the residency manager's ``residency:<kind>`` span, and WAIT's
  ``journal_fsync_fence`` child span.
"""

import random
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu_torch as rt  # noqa: E402
import test_trace as _ref  # noqa: E402
from redisson_tpu_torch.obs import trace as port_trace  # noqa: E402
from test_torch_observability import _Clock, port_module  # noqa: E402
from test_torch_grid_coordination import _one_torch_thread  # noqa: E402,F401

from test_torch_observability import _JAX_LAUNCH_ADVICE, _PORT_LAUNCH_ADVICE  # noqa: E402
from redisson_tpu_torch.obs.spans import PHASES  # noqa: E402


# The reference's two cases that look for the JAX launch phase
# ``device_dispatch`` in a launch span are replaced below by port cases of
# the same names, which look for the port's five launch phases.
port_module(_ref, globals(), skip={"test_direct_api_trace_links_launch_phases",
                                   "test_three_node_scatter_gather_yields_one_trace"})


def test_direct_api_trace_links_launch_phases(traced_client):
    """The reference case on the port: every launch span of a direct-API
    trace keeps its parent link and carries the port's five phases."""
    cl = traced_client
    with cl.trace("batch") as span:
        assert span is not None
        bf = cl.get_bloom_filter("tr-bf")
        bf.try_init(10_000, 0.01)
        bf.add_all(np.arange(256, dtype=np.uint64))
    spans = cl.get_metrics()["traces"][span.trace_id]
    names = [s["name"] for s in spans]
    assert "batch" in names
    launches = [s for s in spans if s["name"].startswith("launch:")]
    assert launches, names
    for ls in launches:
        assert ls["parent_id"] == span.span_id  # parent link intact
        assert ls["attrs"]["links"] >= 1
        assert {p + "_us" for p in PHASES} <= set(ls["attrs"]), ls["attrs"]


def _slot_key(prefix, node_idx, n_nodes=3):
    """A key whose CRC16 slot lands in node ``node_idx``'s contiguous
    partition (the supervisor's even split)."""
    from redisson_tpu_torch.cluster.slots import NSLOTS, key_slot

    per = NSLOTS // n_nodes
    lo = node_idx * per
    hi = NSLOTS - 1 if node_idx == n_nodes - 1 else lo + per - 1
    for i in range(100_000):
        k = f"{prefix}-{i}".encode()
        if lo <= key_slot(k) <= hi:
            return k
    raise AssertionError("no key found for node partition")


@pytest.mark.slow
def test_three_node_scatter_gather_yields_one_trace():
    """The reference case on the port, its three nodes on the CPU: a
    3-node execute_many yields ONE trace whose spans cover the client
    legs, a serving span per node and the device launches, with parent
    links intact across the wire and the port's five phases on each
    launch span."""
    from redisson_tpu_torch.cluster.supervisor import ClusterSupervisor

    sup = ClusterSupervisor(n_nodes=3, device="cpu").start()
    tracer = port_trace.Tracer(sample_rate=1.0)
    try:
        client = sup.client(tracer=tracer)
        try:
            keys = [_slot_key("trace", i) for i in range(3)]
            for k in keys:
                r = client.execute("BF.RESERVE", k, "0.01", "1000")
                assert not isinstance(r, Exception), r
            tracer.reset()  # the batch below is the traced exemplar
            replies = client.execute_many(
                [["BF.ADD", k, b"item-%d" % i] for i, k in enumerate(keys * 4)])
            assert all(not isinstance(r, Exception) for r in replies)
            roots = [s for s in tracer.spans() if s["name"] == "client:execute_many"]
            assert roots, tracer.spans()
            tid = roots[-1]["trace_id"]
            # The per-node rings fill asynchronously (completer threads
            # finish launch spans): poll briefly.
            merged = []
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                merged = client.fleet_traces(tid).get(tid, [])
                names = [s["name"] for s in merged]
                if (sum(n.startswith("leg:") for n in names) >= 3
                        and names.count("resp:BF.ADD") >= 3
                        and any(n.startswith("launch:") for n in names)):
                    break
                time.sleep(0.2)
            root = next(s for s in merged if s["name"] == "client:execute_many")
            legs = [s for s in merged if s["name"].startswith("leg:")]
            ingresses = [s for s in merged if s["name"] == "resp:BF.ADD"]
            launches = [s for s in merged if s["name"].startswith("launch:")]
            assert len(legs) == 3, [s["name"] for s in merged]
            assert len(ingresses) >= 3
            assert launches
            assert {s["trace_id"] for s in merged} == {tid}  # one trace
            # leg -> root, ingress -> its leg, launch -> its ingress.
            leg_ids = {s["span_id"] for s in legs}
            assert all(leg["parent_id"] == root["span_id"] for leg in legs)
            assert all(ing["parent_id"] in leg_ids for ing in ingresses)
            assert len({ing["attrs"]["node"] for ing in ingresses}) == 3
            ingress_ids = {s["span_id"] for s in ingresses}
            for ls in launches:
                assert ls["parent_id"] in ingress_ids
                assert {p + "_us" for p in PHASES} <= set(ls["attrs"]), ls["attrs"]
        finally:
            client.close()
    finally:
        tracer.set_sample_rate(0.0)
        assert sup.shutdown()


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
        port = _latency_snapshot(tmod, seed)
        # The slow-launch advice names each package's launch phases.
        advice = _PORT_LAUNCH_ADVICE.decode()
        assert advice in port[2]
        port = port[:2] + (port[2].replace(advice, _JAX_LAUNCH_ADVICE.decode()),) + port[3:]
        assert port == _latency_snapshot(jmod, seed)


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
