"""The port's flight recorder (``obs/events.py``) and its emit points
against the JAX package's.

* ``tests/test_events.py`` runs again on the port (``port_class`` of
  ``test_torch_grid_coordination.py``): the ring's contract
  (``TestEventRing``), ``merge_timelines``, the LATENCY feeders, the
  breaker emits and the staleness gate (``TestControlPlaneEmits``), and
  the RESP surface (``TestEventsRespSurface``: EVENTS GET|LEN|RESET|HELP,
  INFO events, the WAIT fence timeout, the metric families).  The
  reference drives the last two on a two-node cluster fixture.  They run
  here twice: on ``cluster2``, two standalone port servers under the same
  names (A with a journal, so WAIT is a real fence), and on the
  reference's own two-node cluster rebound to the port
  (``port_namespace`` of ``test_torch_cluster.py``), where the door
  stamps its node id on the ring (``test_ring_is_node_stamped``, which
  the standalone pair only fakes, runs there alone).  The cluster
  client's fleet views, ``TestFleetEvents`` and
  ``TestFanoutDegradation``, run on that cluster too.
* Pure modules under an injected clock: seeded emit streams through the
  JAX and the port ``EventRing`` and ``merge_timelines`` give equal
  snapshots.
* Emit points of the port's replication hub and link
  (``repl.full_resync``, ``repl.partial_resync``, ``repl.link.down``, and
  the ``full-resync`` LATENCY event).  The residency ladder's events are
  held in ``test_torch_trace.py`` beside its spans.
"""

import inspect
import os
import shutil
import socket
import tempfile
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu_torch as rt  # noqa: E402
import test_events as _ref  # noqa: E402
from redisson_tpu_torch.serve.resp import RespServer  # noqa: E402
from redisson_tpu_torch.serve.wireutil import exchange  # noqa: E402
from test_torch_cluster import port_namespace  # noqa: E402
from test_torch_grid_coordination import _one_torch_thread, port_case  # noqa: E402,F401
from test_torch_observability import _Clock  # noqa: E402

# The reference file's wire helper, rebound too: its ``exchange`` (and so
# its ReplyError) must be the port's.
_port_raw = port_case(_ref._raw)


def _ported(ref, skip=()):
    """``port_class`` with the methods' ``_raw`` the port's."""
    ns = {"__module__": __name__}
    for klass in reversed(ref.__mro__[:-1]):
        for name, fn in vars(klass).items():
            if inspect.isfunction(fn):
                ns[name] = port_case(fn, _raw=_port_raw)
    for name in skip:
        ns[name] = None
    return type(ref.__name__, (ref,), ns)


class TestEventRing(_ported(_ref.TestEventRing)):
    pass


class TestMergeTimelines(_ported(_ref.TestMergeTimelines)):
    pass


class TestNewLatencyFeeders(_ported(_ref.TestNewLatencyFeeders)):
    pass


class TestControlPlaneEmits(_ported(_ref.TestControlPlaneEmits)):
    pass


class TestEventsRespSurface(_ported(
        _ref.TestEventsRespSurface, skip=("test_ring_is_node_stamped",))):
    pass


# The reference module rebound whole: its two-node cluster fixture runs on
# the port's door, and the classes below take it in place of the
# standalone pair.
_CLUSTER = port_namespace(_ref)
_cluster2_on_the_door = _CLUSTER["cluster2"]._get_wrapped_function()


class _OnCluster:
    @pytest.fixture()
    def cluster2(self):
        yield from _cluster2_on_the_door()


class TestEventsRespSurfaceOnCluster(_OnCluster, _CLUSTER["TestEventsRespSurface"]):
    pass


class TestFleetEvents(_OnCluster, _CLUSTER["TestFleetEvents"]):
    pass


class TestFanoutDegradation(_OnCluster, _CLUSTER["TestFanoutDegradation"]):
    pass


class _Standalone2:
    """Two standalone port servers named as the reference's cluster
    members: A journaled (WAIT is a real fence, the repl.wait.timeout
    path needs its hub), B plain."""

    def __init__(self):
        self._jdir = tempfile.mkdtemp(prefix="rtpu-events-")
        self.nodes = {}
        for nid in ("A", "B"):
            cfg = rt.Config().use_gpu_sketch(device="cpu", min_bucket=64)
            if nid == "A":
                cfg.journal_dir = os.path.join(self._jdir, "journal-a")
                cfg.journal_fsync = "no"
            client = rt.create(cfg)
            # The id the cluster door would stamp on its ring.
            client.obs.events.node = nid
            self.nodes[nid] = (client, RespServer(client))
        self.addr = {nid: (srv.host, srv.port)
                     for nid, (_, srv) in self.nodes.items()}

    def server(self, nid):
        return self.nodes[nid][1]

    def key_for(self, nid, prefix="k"):
        return f"{prefix}0"  # standalone: every slot is local

    def close(self):
        for client, server in self.nodes.values():
            server.close()
            client.shutdown()
        shutil.rmtree(self._jdir, ignore_errors=True)


@pytest.fixture()
def cluster2():
    c = _Standalone2()
    yield c
    c.close()


# -- pure modules under an injected clock ---------------------------------------


def _ring_snapshot(mod, seed):
    """A seeded emit stream through ``mod``'s EventRing (bounded, with a
    reset), then a merge of three nodes' rings."""
    clock = _Clock()
    mod.time, saved = clock, mod.time
    rng = np.random.default_rng(seed)
    kinds = sorted(mod.KINDS)
    try:
        rings = {}
        for node in ("n0", "n1", "n2"):
            ring = mod.EventRing(max_events=32)
            ring.node = node
            for i in range(100):
                clock.t += float(rng.integers(0, 3)) / 10
                ring.emit(kinds[int(rng.integers(0, len(kinds)))],
                          severity=mod.SEVERITIES[int(rng.integers(0, 3))],
                          i=i, slot=int(rng.integers(0, 16384)))
                if i == 60:
                    ring.reset()
            rings[node] = ring
        merged, gaps = mod.merge_timelines(
            {n: r.snapshot() for n, r in rings.items()})
        return ([r.stats() for r in rings.values()],
                [r.snapshot(count=5, kind="repl.") for r in rings.values()],
                merged, gaps)
    finally:
        mod.time = saved


def test_event_ring_and_merge_equal_the_jax_modules():
    from redisson_tpu.obs import events as jmod
    from redisson_tpu_torch.obs import events as tmod

    assert tmod.KINDS == jmod.KINDS and tmod.SEVERITIES == jmod.SEVERITIES
    for seed in range(3):
        assert _ring_snapshot(tmod, seed) == _ring_snapshot(jmod, seed)


# -- emit points of the port's modules -------------------------------------------


def _wait_for(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.01)


def test_replication_emits_resyncs_and_link_down(tmp_path):
    """A replica's first sync is a full resync on both sides (and a
    ``full-resync`` LATENCY sample on the replica); a reconnect with the
    remembered offset is a partial resync on both sides; the primary's
    loss is one ``repl.link.down``."""

    def node(name, **kw):
        cfg = rt.Config().use_gpu_sketch(device="cpu", min_bucket=64)
        cfg.journal_dir = str(tmp_path / name / "journal")
        cfg.snapshot_dir = str(tmp_path / name / "snap")
        cfg.journal_fsync = "no"
        cfg.latency_monitor_threshold_ms = kw.get("lat", 0)
        cl = rt.create(cfg)
        return cl, RespServer(cl)

    pc, ps = node("p")
    rc, rs = node("r", lat=1)
    try:
        s = socket.create_connection((ps.host, ps.port))
        exchange(s, [("SET", "a", "1"), ("WAIT", "0", "1000")])
        rs.start_replication_from(ps.host, ps.port)
        link = rs.replica_link
        # The link is up before the resync's event and LATENCY sample land.
        _wait_for(lambda: link.link_up and link.lag_ops() == 0
                  and rc.obs.latency.history("full-resync"))
        pk = [e["kind"] for e in pc.obs.events.snapshot(kind="repl.")]
        rk = [e["kind"] for e in rc.obs.events.snapshot(kind="repl.")]
        assert pk == ["repl.full_resync"] and rk == ["repl.full_resync"]
        assert rc.obs.latency.history("full-resync")
        # Drop the link's socket: the loop reconnects with its offset.
        _wait_for(lambda: link._sock is not None)
        link._sock.shutdown(socket.SHUT_RDWR)
        _wait_for(lambda: len(rc.obs.events.snapshot(
            kind="repl.partial_resync")) == 1)
        _wait_for(lambda: len(pc.obs.events.snapshot(
            kind="repl.partial_resync")) == 1)
        assert len(rc.obs.events.snapshot(kind="repl.link.down")) == 1
        s.close()
    finally:
        rs.close()
        rc.shutdown()
        ps.close()
        pc.shutdown()
