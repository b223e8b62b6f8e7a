"""``tests/test_witness.py`` on the port's lock-order witness
(``redisson_tpu_torch/analysis/witness.py``, rebound by
``port_namespace``): cycles across real threads, blocking-under-lock
probes, the ``allow_blocking`` scope, Condition and RLock bookkeeping,
and the engine's serving path run clean under it (the reference body's
``RedissonTpuClient`` is the port's client on the CPU).

Added for the port: the rebalancer's planner, agent (a heat-driven wave
that migrates hot slots between two in-process port nodes) and the fleet
doctor (a clean sweep with the canary) run with the port's witness
forced on and record no violation.

``tests/conftest.py`` drains only the JAX package's witness, so this
file drains the port's after every test in an autouse fixture of its
own and fails a test that left a violation behind.
"""

import builtins
import socket
import types

import pytest

torch = pytest.importorskip("torch")

import test_witness as _ref  # noqa: E402
from redisson_tpu_torch.analysis import witness as port_witness  # noqa: E402
from redisson_tpu_torch.client import RedissonTorchClient  # noqa: E402
from test_torch_cluster import port_namespace  # noqa: E402
from test_torch_grid_coordination import _one_torch_thread  # noqa: E402,F401
from test_torch_grid_coordination import _port_import  # noqa: E402


class _PortClientModule(types.ModuleType):
    """What ``from redisson_tpu.client import RedissonTpuClient`` gives a
    rebound body: the port's client class under the reference's name."""

    def __init__(self):
        super().__init__("redisson_tpu_torch.client")
        self.RedissonTpuClient = RedissonTorchClient


_PORT_CLIENT = _PortClientModule()


def _import(name, globals=None, locals=None, fromlist=(), level=0):
    if level == 0 and name == "redisson_tpu.client" and fromlist:
        return _PORT_CLIENT
    return _port_import(name, globals, locals, fromlist, level)


globals().update(port_namespace(_ref, dict(vars(builtins), __import__=_import)))

_ref_engine_paths = test_engine_paths_run_clean_under_witness  # noqa: F821


def test_engine_paths_run_clean_under_witness(forced_witness, tmp_path):
    """The reference body on the port's client, then a snapshot of a
    loaded filter (its capture holds the mirror, registry and dispatch
    locks in that order); the port's serving path really went through its
    named locks: the coalescer's queue, the engine's mirror lock and the
    tenant registry were acquired, with no violation."""
    import numpy as np

    import redisson_tpu_torch as rt

    _ref_engine_paths(forced_witness)
    client = rt.create(rt.Config().use_gpu_sketch(device="cpu", min_bucket=64))
    try:
        bf = client.get_bloom_filter("witness-snap")
        bf.try_init(10_000, 0.01)
        bf.add_all(np.arange(64, dtype=np.uint64))
        client.snapshot(str(tmp_path))
    finally:
        client.shutdown()
    assert port_witness.take_violations() == []
    names = port_witness.acquired_names()
    assert {"coalescer.queue", "engine.mirror", "tenancy.registry"} <= names, sorted(names)


def test_named_sites_hold_the_raw_lock_with_the_witness_off():
    """``named`` is the identity while ``RTPU_LOCK_WITNESS`` is unset: the
    port's named sites hold the plain ``threading`` lock of the
    reference's kind (the door's move guard stays re-entrant)."""
    if port_witness.enabled():
        pytest.skip("witness armed via RTPU_LOCK_WITNESS")
    import threading

    import redisson_tpu_torch as rt
    from redisson_tpu_torch.cluster.door import ClusterDoor
    from redisson_tpu_torch.serve.resp import RespServer

    lock, rlock = type(threading.Lock()), type(threading.RLock())
    for raw in (threading.Lock(), threading.RLock()):
        assert port_witness.named(raw, "x") is raw
    client = rt.create(rt.Config().use_gpu_sketch(device="cpu", min_bucket=64))
    server = RespServer(client, port=0)
    try:
        eng = client._engine
        assert type(eng._mirror_lock) is rlock
        assert type(eng.registry._lock) is rlock
        assert type(eng.coalescer._lock) is lock
        assert type(eng.coalescer._inflight_cv._lock) is lock
        assert type(eng.health._lock) is lock
        assert type(eng.topk._lock) is lock
        assert type(client._grid.lock) is rlock
        assert type(server._conn_lock) is lock and type(server._scan_lock) is lock
    finally:
        server.close()
        client.shutdown()
    assert "self.move_lock = _witness.named(threading.RLock()" in (
        open(ClusterDoor.__init__.__code__.co_filename).read())


@pytest.fixture(autouse=True)
def _port_witness_guard():
    yield
    if port_witness.active():
        vs = port_witness.take_violations()
        if vs:
            pytest.fail(
                "port lock-order witness found %d violation(s):\n\n%s"
                % (len(vs), "\n\n".join(v.format() for v in vs)),
                pytrace=False,
            )


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_rebalancer_and_doctor_run_clean_under_the_port_witness(forced_witness):
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.cluster.rebalancer import (
        Move,
        RebalanceAgent,
        RebalancePlanner,
    )
    from redisson_tpu_torch.cluster.slots import NSLOTS, key_slot
    from redisson_tpu_torch.obs.doctor import FleetDoctor
    from redisson_tpu_torch.serve.resp import RespServer
    from redisson_tpu_torch.serve.wireutil import exchange

    # The pure planner: a hot node sheds toward the cold one.
    planner = RebalancePlanner(threshold=1.3, warmup_ticks=1)
    for t in range(4):
        planner.observe({
            "A": {s: (100.0 * (t + 1), 0.0, 1) for s in range(4)},
            "B": {8192: (float(t), 0.0, 1)},
        }, now=float(t))
    owners = {s: "A" for s in range(4)}
    owners[8192] = "B"
    moves = planner.plan(owners, ["A", "B"], now=4.0)
    assert moves and all(isinstance(m, Move) and m.dst == "B" for m in moves)

    pa, pb = _free_port(), _free_port()
    topo = {"nodes": [
        {"id": "A", "host": "127.0.0.1", "port": pa, "slots": [[0, 8191]]},
        {"id": "B", "host": "127.0.0.1", "port": pb,
         "slots": [[8192, NSLOTS - 1]]},
    ]}
    nodes = {}
    try:
        for nid, port in (("A", pa), ("B", pb)):
            cfg = rt.Config().use_gpu_sketch(device="cpu", min_bucket=64)
            cfg.cluster_enabled = True
            cfg.cluster_topology = topo
            cfg.cluster_node_id = nid
            client = rt.create(cfg)
            nodes[nid] = (client, RespServer(client, port=port))
        srv = nodes["A"][1]
        agent = RebalanceAgent(srv, interval_s=60.0, pace_s=0.0,
                               cooldown_s=0.5)
        doctor = FleetDoctor(srv, interval_s=3600.0, canary=True)
        assert isinstance(agent._tick_lock, port_witness._WitnessLock)
        assert isinstance(doctor._tick_lock, port_witness._WitnessLock)
        hot, slots, i = [], set(), 0
        while len(hot) < 4:
            k = f"hot{i}"
            i += 1
            if key_slot(k) < 8192 and key_slot(k) not in slots:
                hot.append(k)
                slots.add(key_slot(k))
        sock = socket.create_connection(("127.0.0.1", pa), timeout=30)
        try:
            moved = 0
            for _ in range(8):
                exchange(sock, [[b"SET", k.encode(), b"v"]
                                for k in hot for _ in range(25)])
                (moved,) = exchange(sock, [[b"CLUSTER", b"REBALANCE",
                                            b"NOW"]])
                if moved:
                    break
            assert moved > 0, "no wave after 8 forced ticks"
            assert doctor.tick(force=True) == 0
            assert doctor.canary_failures == 0
        finally:
            sock.close()
    finally:
        for client, server in nodes.values():
            server.close()
            client.shutdown()
    vs = port_witness.take_violations()
    assert vs == [], "\n\n".join(v.format() for v in vs)


def test_reentry_and_try_lock_add_no_order_edge(forced_witness):
    """A re-entrant acquisition of an RLock this thread holds, and a
    try-lock, cannot wait: they add no edge (the door's move guard is
    re-entered by a script's redis.call under the grid lock).  A first
    blocking acquisition under another lock still does."""
    import threading

    outer = port_witness.named(threading.RLock(), "re.outer")
    inner = port_witness.named(threading.Lock(), "re.inner")
    other = port_witness.named(threading.Lock(), "re.other")
    with outer:
        with inner:
            with outer:  # re-entry: no inner -> outer edge
                pass
            assert other.acquire(blocking=False)  # try-lock: no inner -> other
            other.release()
    edges = set(port_witness.export_edges())
    assert ("re.outer", "re.inner") in edges
    assert ("re.inner", "re.outer") not in edges
    assert ("re.inner", "re.other") not in edges
    assert port_witness.take_violations() == []
    with inner:
        with other:  # a first blocking acquisition: an edge
            pass
    assert ("re.inner", "re.other") in set(port_witness.export_edges())
