"""The port's observability tier against the JAX package's: the labeled
registry, lifecycle spans, SLOWLOG, the direct-dispatch records, INFO
commandstats, the Prometheus exposition, and the new verbs, CONFIG keys
and INFO sections over the wire.

* ``tests/test_observability.py`` runs again on the port: ``port_module``
  rebinds every module-level test and fixture of a reference file
  (``port_case`` of ``test_torch_grid_coordination.py``), keeping its
  marks, so the two overhead guards keep their harness, their bounds and
  their ``slow`` mark.  Not collected, with the ROADMAP queue 1 item each
  waits for (``SKIPPED``):

  - ``test_sharded_direct_dispatch_records_ops_and_shards``: the sharded
    executor and ``rtpu_shard_ops`` (item 5);
  - ``test_device_memory_reports_all_devices``: one entry per device of
    the JAX CPU backend's 8-device mesh; the port's node list grows with
    the sharded mesh (item 5).  ``test_torch_admin.py::
    test_device_memory_on_cpu_matches_the_jax_shape`` holds the shape.

  ``test_metric_catalog_matches_doc`` is replaced by the port's own case
  of that name: the doc table's rows minus the families of modules not
  yet ported, plus the port-only families of README.md's "Port-only
  families and phases" section, exactly.  ``test_span_phase_sum_matches_
  end_to_end`` and ``test_prometheus_labels_and_types`` are replaced by
  port cases of those names: the port's launch has five phases
  (``slot_wait`` and ``enqueue`` where the JAX package has
  ``device_dispatch``).
* Pure modules under an injected clock: ``SlowLog`` and its argument
  truncation, fed the same seeded inputs in both packages, give equal
  snapshots.
* The wire both ways: a seeded session of every new verb, CONFIG key and
  INFO section against a JAX ``RespServer`` and a port ``RespServer`` on
  the CPU; replies byte-equal after masking times, durations, trace ids
  and the slowlog ids' start.
* The spans' phases sum to ``end_to_end`` on a CPU port client, and every
  K1 call is one dispatch record.
* The port-only records: every data call observes its three phases once;
  the launch timer's idle gaps go to the phase that held the launch (a
  caller's sleep to ``caller``, a slow staging to ``host_stage``) and
  their causes sum to each gap; no ``record_function`` is entered while
  no profiler records, and an all-threads profile shows ``rtpu:encode``,
  ``rtpu:submit`` and ``rtpu:stage`` on the threads that do the work;
  the added submit-path cost of a 1024-key call is bounded.
"""

import inspect
import json
import os
import re
import socket
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
import test_observability as _ref  # noqa: E402
from _pytest.fixtures import FixtureFunctionDefinition  # noqa: E402
from redisson_tpu_torch.obs import Observability  # noqa: E402
from redisson_tpu_torch.obs.spans import PHASES  # noqa: E402
from test_torch_grid_coordination import _one_torch_thread, port_case  # noqa: E402,F401


# -- running a reference file's module-level tests on the port ------------------


def port_test(fn):
    """``port_case(fn)`` keeping the reference function's marks."""
    new = port_case(fn)
    marks = getattr(fn, "pytestmark", None)
    if marks:
        new.pytestmark = list(marks)
    return new


def _port_fixture(fdef):
    fn = fdef._get_wrapped_function()
    m = fdef._fixture_function_marker
    return pytest.fixture(
        port_case(fn), scope=m.scope, params=m.params, autouse=m.autouse,
        ids=m.ids, name=fdef.name,
    )


def port_module(ref, ns: dict, skip=()) -> None:
    """Bind into ``ns`` every module-level fixture and test function of
    the reference module ``ref``, rebound to the port; tests named in
    ``skip`` are not collected."""
    for name, obj in vars(ref).items():
        if isinstance(obj, FixtureFunctionDefinition):
            ns[name] = _port_fixture(obj)
        elif (
            name.startswith("test_") and inspect.isfunction(obj)
            and obj.__module__ == ref.__name__ and name not in skip
        ):
            ns[name] = port_test(obj)


SKIPPED = {
    "test_device_memory_reports_all_devices":
        "replaced below by the port's case of the same name: the reference "
        "keys every JAX device, the port every distinct device of the mesh",
    "test_metric_catalog_matches_doc":
        "replaced below by the port's catalog case of the same name",
    "test_span_phase_sum_matches_end_to_end":
        "replaced below by the port's case of the same name: five phases",
    "test_prometheus_labels_and_types":
        "replaced below by the port's case of the same name: the port's "
        "phase labels",
}

port_module(_ref, globals(), skip=SKIPPED)


def test_span_phase_sum_matches_end_to_end(tpu_client):
    """The reference case on the port: the port's five launch phases
    partition the end-to-end latency."""
    bf = tpu_client.get_bloom_filter("span-bf")
    bf.try_init(10_000, 0.01)
    bf.add_all(np.arange(512, dtype=np.uint64))
    bf.contains_each(np.arange(512, dtype=np.uint64))
    spans = tpu_client.obs.spans.recent()
    assert spans, "coalesced launches must leave spans"
    for s in spans:
        phases = s.phases()
        assert set(phases) == set(PHASES)
        assert sum(phases.values()) == pytest.approx(
            s.end_to_end(), rel=1e-6, abs=1e-6
        )
        assert s.nops > 0 and not s.error
        assert s.device_s is not None and 0 < s.device_s <= s.end_to_end()
    snap = tpu_client.get_metrics()
    assert snap["ops"], snap
    assert any(
        st["ops"] >= 1024 and st["p99_ms"] > 0
        for st in snap["ops"].values()
    ), snap["ops"]
    assert snap["tenants"].get("span-bf", 0) >= 1024


def test_prometheus_labels_and_types(tpu_client):
    """The reference case on the port, with the port's phase labels and
    its four port-only families typed."""
    from redisson_tpu_torch.serve.resp import RespServer
    from test_resp_server import RespClient

    srv = RespServer(tpu_client)
    conn = RespClient(srv.host, srv.port)
    try:
        conn.cmd("SET", "k", "v")
        conn.cmd("GET", "k")
        bf = tpu_client.get_bloom_filter("prom-bf")
        bf.try_init(10_000, 0.01)
        bf.add_all(np.arange(256, dtype=np.uint64))
        bf.add_all(np.arange(256, 512, dtype=np.uint64))  # a gap between launches
        text = tpu_client.render_prometheus()
        assert "# TYPE rtpu_resp_commands_total counter" in text
        assert 'rtpu_resp_commands_total{cmd="GET"} 1' in text
        assert "# TYPE rtpu_tenant_ops_total counter" in text
        assert 'tenant="prom-bf"' in text
        assert "# TYPE rtpu_op_phase_seconds histogram" in text
        for phase in PHASES:
            assert f'phase="{phase}"' in text, phase
        assert "# TYPE rtpu_call_phase_seconds histogram" in text
        assert "# TYPE rtpu_launch_device_seconds histogram" in text
        assert "# TYPE rtpu_device_idle_seconds_total counter" in text
        assert "# TYPE rtpu_lane_staging_total counter" in text
        assert "# TYPE rtpu_coalescer_queued_ops gauge" in text
        assert "# TYPE rtpu_tenants gauge" in text
        assert 'rtpu_tenants{kind="bloom"} 1' in text
        assert "# TYPE rtpu_pool_rows gauge" in text
        assert "# TYPE redisson_tpu_ops_total counter" in text
    finally:
        conn.close()
        srv.close()


# Families of the JAX package's bundle that wait with their modules: none
# since the sharded executor brought ``rtpu_shard_ops_total``.
WAITING_FAMILIES: set = set()


def test_device_memory_reports_all_devices(monkeypatch):
    """One key per distinct device of the engine's mesh: eight logical
    shards on the CPU share one device, so one key — on one placement,
    and on four placements of the CPU (the enumeration replaced)."""
    from redisson_tpu_torch.executor import torch_executor
    from redisson_tpu_torch.serve.metrics import Profiler

    cl = rt.create(rt.Config().use_gpu_sketch(device="cpu", num_shards=8,
                                              min_bucket=64))
    try:
        _device_memory_case(cl, Profiler)
    finally:
        cl.shutdown()
    monkeypatch.setattr(torch_executor, "local_devices",
                        lambda d: [torch.device("cpu")] * 4)
    cl = rt.create(rt.Config().use_gpu_sketch(device="cpu", num_shards=8,
                                              min_bucket=64, device_indices=[0, 1, 2, 3]))
    try:
        assert len(cl._engine.executor.ctx.devices) == 4
        _device_memory_case(cl, Profiler)
    finally:
        cl.shutdown()


def _device_memory_case(cl, Profiler):
    devices = cl._engine.mesh_devices()
    assert len(devices) == 8
    mem = Profiler(devices[0], devices=devices).device_memory()
    assert isinstance(mem, dict)
    assert set(mem) == {"cpu:0"}
    assert cl.get_profiler().device_memory() == mem
    # The CPU reports no stats, so the gauge family is declared with
    # no sample.
    fam = cl.obs.registry.render_prometheus().splitlines()
    assert "# TYPE rtpu_device_memory_bytes gauge" in fam
    assert not [ln for ln in fam if ln.startswith("rtpu_device_memory_bytes")]


# The port's own families, which the JAX package does not have
# (README.md, "Port-only families and phases").
PORT_ONLY_FAMILIES = {
    "rtpu_call_phase_seconds", "rtpu_launch_device_seconds",
    "rtpu_device_idle_seconds_total", "rtpu_lane_staging_total",
    "rtpu_topk_offered_total", "rtpu_topk_prunes_total", "rtpu_topk_candidates",
}


def _doc_families(path: str = "docs/observability.md",
                  heading: str = "### Labeled registry") -> set:
    """The ``rtpu_`` names of the tables under ``heading`` in ``path``,
    up to the next second-level heading."""
    with open(os.path.join(os.path.dirname(__file__), "..", path)) as f:
        section = f.read().split(heading, 1)[1]
    section = section.split("\n## ", 1)[0]
    names = set()
    for line in section.splitlines():
        m = re.match(r"\|\s*`(rtpu_[a-z0-9_]+)`", line)
        if m:
            names.add(m.group(1))
    return names


def test_metric_catalog_matches_doc():
    """docs/observability.md's labeled-registry table, less the families
    of modules the port has not reached, with the table of README.md's
    port-only section, is exactly what a fully-featured port engine
    registers (coalescer, pre-warmer and journal gauges)."""
    port_only = _doc_families("README.md", "### Port-only families and phases")
    assert port_only == PORT_ONLY_FAMILIES
    doc = _doc_families() | port_only
    assert WAITING_FAMILIES <= doc
    cfg = rt.Config().use_gpu_sketch(device="cpu", min_bucket=64, prewarm=True)
    cl = rt.create(cfg)
    try:
        reg = cl.obs.registry
        registered = set(reg._families)
        registered |= {name for name, _, _, _ in reg._callbacks}
    finally:
        cl.shutdown()
    assert registered == doc - WAITING_FAMILIES, (
        sorted(registered ^ (doc - WAITING_FAMILIES))
    )


# The families of the tier's own modules (spans, trace, latency, events,
# loadmap, the dispatch records, and the port's call phases and launch
# times).
TIER_FAMILIES = {
    "rtpu_latency_events_total", "rtpu_trace_sampled_total",
    "rtpu_trace_spans_total", "rtpu_op_phase_seconds", "rtpu_op_seconds",
    "rtpu_ops_total", "rtpu_op_errors_total", "rtpu_tenant_ops_total",
    "rtpu_tenant_calls_total", "rtpu_dispatches_total",
    "rtpu_dispatch_ops_total", "rtpu_dispatch_enqueue_seconds",
    "rtpu_tenant_device_us_total", "rtpu_events_emitted_total",
    "rtpu_events_evicted_total", "rtpu_call_phase_seconds",
    "rtpu_launch_device_seconds", "rtpu_device_idle_seconds_total",
}


def test_families_match_the_jax_bundle():
    """Every family the port's bundle builds, but for exactly the seven
    port-only ones, has the JAX family's name, type and labels; the
    tier's own families its help text too."""
    from redisson_tpu.obs import Observability as JaxObs

    j, t = JaxObs().registry, Observability().registry
    assert TIER_FAMILIES <= set(t._families)
    assert set(t._families) - set(j._families) == PORT_ONLY_FAMILIES
    assert set(j._families) - set(t._families) <= WAITING_FAMILIES
    for name, fam in t._families.items():
        if name in PORT_ONLY_FAMILIES:
            continue
        jf = j._families[name]
        assert (fam.labelnames, type(fam).__name__) == (
            jf.labelnames, type(jf).__name__), name
        if name in TIER_FAMILIES:
            assert fam.help == jf.help, name
    jcb = {c[0]: c[1:] for c in j._callbacks}
    for name, *rest in t._callbacks:
        assert jcb[name][0] == rest[0], name


# -- pure modules under an injected clock ---------------------------------------


class _Clock(types.ModuleType):
    """A ``time`` module whose clocks advance only when told."""

    def __init__(self, t=1_700_000_000.0):
        super().__init__("time")
        self.t = t

    def time(self):
        return self.t

    def monotonic(self):
        return self.t

    def perf_counter(self):
        return self.t


def _slowlog_snapshot(mod, seed):
    rng = np.random.default_rng(seed)
    clock = _Clock()
    mod.time, saved = clock, mod.time
    try:
        sl = mod.SlowLog(max_len=16, threshold_us=500)
        for i in range(64):
            clock.t += float(rng.integers(1, 5))
            nargs = int(rng.integers(1, 40))
            args = [bytes(rng.integers(97, 123, int(rng.integers(0, 200)),
                                      dtype=np.uint8)) for _ in range(nargs)]
            sl.maybe_add(float(rng.integers(0, 1000)) / 1e6, args,
                         f"127.0.0.1:{i}", "cli" if i % 3 else "")
            if i == 40:
                sl.set_max_len(8)
            if i == 50:
                sl.set_threshold_us(100)
        return [
            (e.id, e.unix_ts, e.duration_us, e.args, e.client_addr,
             e.client_name, e.trace_id)
            for e in sl.entries()
        ], len(sl)
    finally:
        mod.time = saved


def test_slowlog_equals_the_jax_slowlog():
    from redisson_tpu.obs import slowlog as jmod
    from redisson_tpu_torch.obs import slowlog as tmod

    for seed in range(3):
        assert _slowlog_snapshot(tmod, seed) == _slowlog_snapshot(jmod, seed)


# -- spans and dispatch records on a CPU client ---------------------------------


def _cpu_client(**kw):
    kw.setdefault("min_bucket", 64)
    return rt.create(rt.Config().use_gpu_sketch(device="cpu", **kw))


def test_span_phases_partition_end_to_end_and_count_the_launches():
    cl = _cpu_client(batch_window_us=100)
    try:
        bf = cl.get_bloom_filter("sp")
        bf.try_init(100_000, 0.01)
        futs = [bf.add_all_async(np.arange(i * 4096, (i + 1) * 4096,
                                           dtype=np.uint64)) for i in range(4)]
        for f in futs:
            f.result()
        spans = cl.obs.spans.recent()
        assert spans
        for s in spans:
            ph = s.phases()
            assert set(ph) == {"coalesce_wait", "host_stage", "slot_wait",
                               "enqueue", "d2h_fetch"} == set(PHASES)
            assert abs(sum(ph.values()) - s.end_to_end()) < 1e-6
        hist = cl.obs.registry.family("rtpu_op_phase_seconds")
        counts = {lv: c.count for lv, c in hist.items()}
        ops = {lv[0] for lv in counts}
        for op in ops:
            n = [c for (o, ph), c in counts.items()
                 if o == op and ph == "enqueue"]
            assert n == [len(cl.obs.spans.recent(op))]
        assert cl.obs.tenant_stats()["sp"] == 4 * 4096
        assert sum(st["ops"] for st in cl.obs.op_stats().values()) == 4 * 4096
    finally:
        cl.shutdown()


def test_k1_calls_are_dispatch_records():
    """The sequential-CMS gate dispatches K1 directly: each chunk of
    ``add_all_seq`` is one ``rtpu_dispatches`` record of
    ``cms_update_estimate_seq``, carrying its ops."""
    cl = _cpu_client()
    try:
        cms = cl.get_count_min_sketch("k1")
        cms.try_init(4, 4096)
        eng = cl._engine
        eng._SEQ_CHUNK = chunk = 256
        n = 2 * chunk + 17
        keys = np.random.default_rng(0).integers(0, 1000, n, dtype=np.uint64)
        cms.add_all_seq(keys)
        d = cl.obs.registry.family("rtpu_dispatches_total")
        o = cl.obs.registry.family("rtpu_dispatch_ops_total")
        key = ("cms_update_estimate_seq",)
        assert dict(d.items())[key].value == 3
        assert dict(o.items())[key].value == n
    finally:
        cl.shutdown()


def test_get_metrics_nested_views_match_the_jax_client():
    jc = redisson_tpu.create(redisson_tpu.Config().use_tpu_sketch(min_bucket=64))
    tc = _cpu_client()
    try:
        for c in (jc, tc):
            bf = c.get_bloom_filter("gm")
            bf.try_init(10_000, 0.01)
            bf.add_all(np.arange(300, dtype=np.uint64))
        jm, tm = jc.get_metrics(), tc.get_metrics()
        assert set(tm) == set(jm)
        assert tm["tenants"] == jm["tenants"] == {"gm": 300}
        assert tm["slowlog_len"] == jm["slowlog_len"] == 0
        assert tm["traces"] == jm["traces"] == {}
        for op, st in tm["ops"].items():
            assert set(st) == set(next(iter(jm["ops"].values())))
        # The port's launch has its own five phases; each phase's view
        # carries the JAX view's fields.
        jfields = set(next(iter(next(iter(jm["phases"].values())).values())))
        for op, st in tm["phases"].items():
            assert set(st) == set(PHASES)
            assert all(set(v) == jfields for v in st.values())
    finally:
        tc.shutdown()
        jc.shutdown()


# -- the wire both ways -----------------------------------------------------------


def _read_reply(f):
    line = f.readline()
    t, rest = line[:1], line[1:-2]
    if t in (b"+", b"-"):
        return (t, rest)
    if t == b":":
        return int(rest)
    if t == b"$":
        n = int(rest)
        if n < 0:
            return None
        data = f.read(n + 2)[:-2]
        return data
    if t == b"*":
        n = int(rest)
        return None if n < 0 else [_read_reply(f) for _ in range(n)]
    raise AssertionError(line)


def _encode(cmd) -> bytes:
    out = b"*%d\r\n" % len(cmd)
    for a in cmd:
        a = a if isinstance(a, bytes) else str(a).encode()
        out += b"$%d\r\n%s\r\n" % (len(a), a)
    return out


_NUM = re.compile(rb"\d+(\.\d+)?")
_JAX_LAUNCH_ADVICE = (b"check rtpu_op_phase_seconds for the slow phase (coalesce_wait "
                      b"vs device_dispatch vs d2h_fetch) and the link-phase gauges")
_PORT_LAUNCH_ADVICE = (b"check rtpu_op_phase_seconds for the slow phase (coalesce_wait, "
                       b"host_stage, slot_wait, enqueue or d2h_fetch), "
                       b"rtpu_launch_device_seconds for the device's own time, and "
                       b"the link-phase gauges")


def _mask(cmd, reply, ids):
    """Times, durations, trace ids, addresses and the slowlog ids' start
    out of one reply, so the rest compares byte for byte."""
    if isinstance(reply, tuple):  # +simple / -error frames
        return reply
    name = cmd[0].upper()
    sub = cmd[1].upper() if len(cmd) > 1 else b""
    if name == b"SLOWLOG" and sub == b"GET":
        out = []
        for e in reply:
            out.append([e[0] - ids["slowlog0"], "ts", "us", e[3], "addr",
                        e[5]] + (["tid"] if len(e) == 7 else []))
        return out
    if name == b"TRACE" and sub == b"GET":
        docs = [json.loads(d) for d in reply]
        return [sorted((s["name"], s["error"], sorted(
            k for k in s["attrs"] if k not in ("node", "addr", "tick")))
            for s in d["spans"]) for d in docs]
    if name == b"EVENTS" and sub == b"GET":
        doc = json.loads(reply)
        for e in doc["events"]:
            e.pop("wall"), e.pop("mono")
        return doc
    if name == b"LATENCY" and sub in (b"LATEST", b"HISTORY"):
        # Which events met the 1 ms threshold, and how often, is timing:
        # the rows' shape is compared, and "command" must be there.
        if sub == b"LATEST" and reply:
            assert b"command" in [r[0] for r in reply]
        return sorted({tuple(type(x).__name__ for x in r) for r in reply})
    if name == b"LATENCY" and sub == b"DOCTOR":
        # The slow-launch advice names the phases of each package's
        # launch; the port's own advice stands in for the JAX one's.
        reply = reply.replace(_PORT_LAUNCH_ADVICE, _JAX_LAUNCH_ADVICE)
        return _NUM.sub(b"N", reply)
    if name == b"INFO":
        lines = []
        for ln in reply.split(b"\r\n"):
            k, _, v = ln.partition(b":")
            if k in (b"trace_spans", b"trace_traces", b"trace_sampled_total",
                     b"latency_events", b"latency_samples",
                     b"loadmap_bytes_out", b"loadmap_tenant_shares",
                     b"loadmap_device_us"):
                v = b"N"
            lines.append(k + b":" + v if _ else k)
        return b"\r\n".join(lines)
    return reply


def _wire_session():
    """Every new verb, CONFIG key and INFO section, in one seeded
    session (keys and counts from a numpy seed)."""
    rng = np.random.default_rng(11)
    keys = [b"k%d" % int(k) for k in rng.zipf(1.3, 64) % 50]
    cmds = [
        [b"SLOWLOG", b"LEN"], [b"SLOWLOG", b"HELP"],
        [b"CONFIG", b"GET", b"slowlog-*"],
        [b"CONFIG", b"GET", b"trace-sample-rate"],
        [b"CONFIG", b"GET", b"latency-monitor-threshold"],
        [b"CONFIG", b"GET", b"loadmap-*"],
        [b"CONFIG", b"SET", b"slowlog-max-len", b"-1"],
        [b"CONFIG", b"SET", b"trace-sample-rate", b"2"],
        [b"CONFIG", b"SET", b"latency-monitor-threshold", b"x"],
        [b"CONFIG", b"SET", b"loadmap-key-sample-rate", b"1.5"],
        [b"CONFIG", b"SET", b"loadmap-enabled", b"maybe"],
        [b"CONFIG", b"SET", b"slowlog-log-slower-than", b"0",
         b"slowlog-max-len", b"32"],
        [b"CONFIG", b"SET", b"loadmap-key-sample-rate", b"1"],
        [b"CONFIG", b"SET", b"latency-monitor-threshold", b"1"],
        [b"INFO", b"telemetry"], [b"INFO", b"events"],
        [b"TRACE", b"GET"], [b"TRACE", b"LEN"], [b"TRACE", b"HELP"],
        [b"TRACE", b"SAMPLE", b"7"], [b"TRACE"], [b"TRACE", b"NOPE"],
        [b"RTPU.TRACE", b"ab" * 16, b"cd" * 8], [b"SET", b"pre", b"v"],
        [b"RTPU.TRACE", b"x", b"y"], [b"RTPU.TRACE", b"ab" * 16],
        [b"CONFIG", b"SET", b"trace-sample-rate", b"1"],
        [b"BF.RESERVE", b"bf", b"0.01", b"1000"],
        [b"BF.MADD", b"bf"] + keys[:16],
        [b"TRACE", b"SAMPLE", b"0"],
        [b"CONFIG", b"GET", b"trace-sample-rate"],
    ]
    cmds += [[b"SET", k, b"v"] for k in keys]
    cmds += [
        [b"AUTH", b"hunter2"], [b"HELLO", b"2", b"AUTH", b"u", b"pw"],
        [b"MULTI"], [b"SET", b"m1", b"x"], [b"GET", b"m1"], [b"EXEC"],
        [b"SLOWLOG", b"GET", b"-1"], [b"SLOWLOG", b"GET", b"3"],
        [b"SLOWLOG", b"LEN"], [b"SLOWLOG", b"NOPE"], [b"SLOWLOG"],
        [b"HOTKEYS", b"5"], [b"HOTKEYS", b"x"], [b"HOTKEYS", b"-1"],
        [b"HOTKEYS"],
        [b"DEBUG", b"SLEEP", b"0.005"],
        [b"LATENCY", b"LATEST"], [b"LATENCY", b"HISTORY", b"command"],
        [b"LATENCY", b"HISTORY"], [b"LATENCY", b"HISTORY", b"absent"],
        [b"LATENCY", b"DOCTOR"], [b"LATENCY", b"HELP"], [b"LATENCY"],
        [b"LATENCY", b"NOPE"],
        [b"EVENTS", b"GET", b"2"], [b"EVENTS", b"GET", b"0", b"config."],
        [b"EVENTS", b"GET", b"0", b"config.set"],
        [b"EVENTS", b"GET", b"x"], [b"EVENTS", b"GET", b"-1"],
        [b"EVENTS", b"LEN"], [b"EVENTS", b"HELP"], [b"EVENTS"],
        [b"EVENTS", b"NOPE"],
        [b"INFO", b"loadstats"], [b"INFO", b"stats"],
        [b"SLOWLOG", b"RESET"], [b"SLOWLOG", b"LEN"],
        [b"LATENCY", b"RESET", b"command"], [b"LATENCY", b"RESET"],
        [b"EVENTS", b"RESET"], [b"EVENTS", b"LEN"], [b"TRACE", b"RESET"],
        [b"TRACE", b"LEN"], [b"WAIT", b"0", b"0"],
        [b"CONFIG", b"SET", b"slowlog-log-slower-than", b"-1"],
        [b"CONFIG", b"SET", b"latency-monitor-threshold", b"0"],
    ]
    return cmds


def _run_session(server, cmds):
    s = socket.create_connection((server.host, server.port))
    f = s.makefile("rb")
    try:
        out = []
        for c in cmds:
            s.sendall(_encode(c))
            out.append(_read_reply(f))
        return out
    finally:
        f.close()
        s.close()


def _masked(server, cmds):
    replies = _run_session(server, cmds)
    ids = {"slowlog0": min(
        (e[0] for c, r in zip(cmds, replies)
         if c[:2] == [b"SLOWLOG", b"GET"] and isinstance(r, list)
         for e in r), default=0)}
    return [_mask(c, r, ids) for c, r in zip(cmds, replies)]


def test_new_verbs_config_and_info_byte_equal_to_the_jax_server():
    from redisson_tpu.serve.resp import RespServer as JaxServer
    from redisson_tpu_torch.serve.resp import RespServer as PortServer

    cmds = _wire_session()
    jc = redisson_tpu.create(redisson_tpu.Config().use_tpu_sketch(min_bucket=64))
    tc = _cpu_client()
    js, ts = JaxServer(jc), PortServer(tc)
    try:
        got_j, got_t = _masked(js, cmds), _masked(ts, cmds)
    finally:
        ts.close()
        js.close()
        tc.shutdown()
        jc.shutdown()
    for c, a, b in zip(cmds, got_j, got_t):
        assert b == a, c
    # The session did reach the surfaces it compares.
    by = dict(zip((tuple(c[:2]) for c in cmds), got_t))
    assert by[(b"SLOWLOG", b"LEN")] == 1  # the RESET's own entry
    hot = by[(b"HOTKEYS", b"5")]
    assert hot and hot[0] == b"k1"


# -- chip_smoke.py phase 15 at a small size on the CPU ----------------------------


@pytest.fixture
def p15_cpu(monkeypatch):
    import chip_smoke as cs

    monkeypatch.setattr(cs, "P15_DEVICE", "cpu")
    monkeypatch.setattr(cs, "P15", dict(
        cs.P15, keys=1 << 14, chunk=1 << 12, capacity=20_000, contains=1 << 14,
        cms_events=1 << 13, d=4, w=4096, rounds=1, madd=64, madd_cmds=160,
        c6_batches=2, c6_depth=64))
    monkeypatch.setenv("RTPU_REQUIRE_NATIVE_RESP", "1")  # restored after
    return cs


def test_chip_smoke_phase_15_on_the_cpu(p15_cpu):
    """The card phase's checks at a small size on the CPU: spans and
    dispatch records (15a), the three arms (15b), and the verbs over the
    wire (15c) — the monitor, the slowlog, a sequential replay, a trace
    prelude, a breaker trip's LATENCY and EVENTS, HOTKEYS."""
    rng = np.random.default_rng(0)
    a = p15_cpu.p15a_spans(rng, "cpu")
    assert a["spans"] == a["launch_spans_in_trace"] == a["launches"] > 0
    assert a["k1_dispatch_ops"] == p15_cpu.P15["cms_events"]
    b = p15_cpu.p15b_overhead("cpu")
    assert set(b["keys_per_s"]) == {"A", "B", "C"}
    c = p15_cpu.p15c_wire(rng, "cpu", 0)
    assert c["monitor_cmds"] == 160 and c["fused_runs_attached"] == 0
    assert c["slowlog_len"] == 128 and c["replies_equal_replay"]
    assert c["events"][:2] == ["health.breaker.open", "health.breaker.close"]
    assert "breaker-open" in c["latency_latest"]
