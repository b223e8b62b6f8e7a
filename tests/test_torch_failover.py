"""The port's automatic failover against the JAX package's.

* ``tests/test_failover.py`` runs again on the port (``port_namespace``
  of ``test_torch_cluster.py``): failure detection, the election rules,
  the epoch-gated takeover slot math, and the kill -9 supervisor soak
  (``slow``; its three primaries and three replicas run with
  ``--device cpu``).
* A seeded differential: 500 random steps of pings, pongs, timeout
  checks, failure marks, elections, vote requests and takeover
  broadcasts, at 4 seeds, fed to the JAX ``FailoverState`` (over a JAX
  ``SlotMap``) and to the port's (over the port's): every decision,
  epoch, vote and slot owner equal at every step.
* The bus verbs over the wire: RTPU.CLUSTERPING, RTPU.FAILOVER.AUTH and
  RTPU.TAKEOVER on in-process port nodes with armed agents, and manual
  FAILOVER carrying the cluster epoch.
"""

import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu_torch as rt  # noqa: E402
import test_failover as _ref  # noqa: E402
from redisson_tpu.cluster.failover import FailoverState as JaxState  # noqa: E402
from redisson_tpu.cluster.slotmap import SlotMap as JaxSlotMap  # noqa: E402
from redisson_tpu_torch.analysis import witness as port_witness  # noqa: E402
from redisson_tpu_torch.cluster.failover import FailoverState  # noqa: E402
from redisson_tpu_torch.cluster.slotmap import SlotMap  # noqa: E402
from redisson_tpu_torch.cluster.slots import NSLOTS  # noqa: E402
from redisson_tpu_torch.serve.wireutil import exchange  # noqa: E402
from test_torch_cluster import cpu_builtins, port_namespace  # noqa: E402
from test_torch_grid_coordination import _one_torch_thread  # noqa: E402,F401


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


globals().update(port_namespace(_ref, cpu_builtins))


# -- the seeded differential ------------------------------------------------------


_IDS = ["A", "B", "C", "D", "R1", "R2", "R3"]


def _topology():
    nodes = [
        {"id": "A", "host": "h", "port": 1, "slots": [[0, 4095]]},
        {"id": "B", "host": "h", "port": 2, "slots": [[4096, 8191]]},
        {"id": "C", "host": "h", "port": 3, "slots": [[8192, 12287]]},
        {"id": "D", "host": "h", "port": 4, "slots": [[12288, NSLOTS - 1]]},
    ]
    for i, parent in enumerate(("A", "A", "B")):
        nodes.append({"id": f"R{i + 1}", "host": "r", "port": 10 + i,
                      "slots": [], "role": "replica", "replica_of": parent})
    return {"nodes": nodes}


def _step(rng, states, maps, clock):
    """One random step applied to every (state, slotmap) pair; the
    observable outcome of each."""
    kind = int(rng.integers(0, 8))
    a = _IDS[int(rng.integers(0, len(_IDS)))]
    b = _IDS[int(rng.integers(0, len(_IDS)))]
    epoch = int(rng.integers(0, 12))
    lo = int(rng.integers(0, NSLOTS))
    hi = min(NSLOTS - 1, lo + int(rng.integers(0, 6000)))
    claim = [[lo, hi]] if rng.integers(0, 2) else None
    clock[0] += float(rng.integers(0, 8)) / 4
    now = clock[0]
    out = []
    for st, sm in zip(states, maps):
        if kind == 0:
            r = st.note_ping(a, epoch, now)
        elif kind == 1:
            r = st.note_pong(a, now)
        elif kind == 2:
            r = sorted(st.check_timeouts(now))
        elif kind == 3:
            r = st.mark_failed(a)
        elif kind == 4:
            r = st.start_election()
        elif kind == 5:
            r = st.grant_vote(a, epoch, b)
        elif kind == 6:
            r = (sm.apply_takeover(b, a, epoch, slots=claim),
                 st.note_takeover(a, b, epoch))
        else:
            r = st.is_failed(a)
        out.append((kind, r, st.current_epoch, st.last_vote_epoch,
                    sorted(st.failed), st.majority(),
                    sm.owner(0), sm.owner(5000), sm.owner(9000),
                    sm.owner(NSLOTS - 1), sm.slot_epoch(0),
                    tuple(sm.primary_ids()), sm.role(a), sm.replica_of(a)))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_failover_state_steps_equal_the_jax_state(seed):
    rng = np.random.default_rng(seed)
    topo = _topology()
    maps = [JaxSlotMap.from_dict(topo), SlotMap.from_dict(topo)]
    me = _IDS[seed % len(_IDS)]
    states = [JaxState(me, maps[0], node_timeout=1.0),
              FailoverState(me, maps[1], node_timeout=1.0)]
    clock = [0.0]
    granted = 0
    for i in range(500):
        jax_out, port_out = _step(rng, states, maps, clock)
        assert jax_out == port_out, (seed, i, jax_out, port_out)
        granted += jax_out[0] == 5 and jax_out[1] is True
    assert maps[0].to_dict() == maps[1].to_dict()
    assert states[0].last_pong == states[1].last_pong
    assert granted > 0  # the walk reached real votes


# -- the bus verbs over the wire ----------------------------------------------------


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _req(addr, cmds):
    sock = socket.create_connection(addr, timeout=30)
    try:
        return exchange(sock, cmds)
    finally:
        sock.close()


def test_bus_verbs_on_armed_port_nodes():
    """Three primaries with armed agents (long ping interval: the test
    drives the bus by hand): CLUSTERPING learns epochs, a primary grants
    one vote per epoch for a failed peer's replica, and a TAKEOVER moves
    the claimed slots on every receiver, epoch-gated."""
    from redisson_tpu_torch.cluster.failover import FailoverAgent
    from redisson_tpu_torch.serve.resp import RespServer

    ports = [_free_port() for _ in range(4)]
    ids = ["P0", "P1", "P2", "R0"]
    per = NSLOTS // 3
    topo = {"nodes": [
        {"id": ids[i], "host": "127.0.0.1", "port": ports[i],
         "slots": [[i * per, NSLOTS - 1 if i == 2 else (i + 1) * per - 1]]}
        for i in range(3)
    ] + [{"id": "R0", "host": "127.0.0.1", "port": ports[3], "slots": [],
          "role": "replica", "replica_of": "P0"}]}
    nodes = []
    try:
        for nid, port in zip(ids[:3], ports):
            cfg = rt.Config().use_gpu_sketch(device="cpu", min_bucket=64)
            cfg.cluster_enabled = True
            cfg.cluster_topology = topo
            cfg.cluster_node_id = nid
            cl = rt.create(cfg)
            srv = RespServer(cl, port=port)
            FailoverAgent(srv, node_timeout_s=1.0, ping_interval_s=3600.0)
            nodes.append((cl, srv))
        addr = [("127.0.0.1", p) for p in ports]
        pong = _req(addr[1], [["RTPU.CLUSTERPING", "P2", "7"]])[0]
        assert pong == [b"PONG", b"P1", 7, 0, b"master"]
        # P1 still sees P0 alive: no vote for its replica.
        assert _req(addr[1], [["RTPU.FAILOVER.AUTH", "R0", "8", "P0"]]) == [0]
        nodes[1][1].failover.state.mark_failed("P0")
        assert _req(addr[1], [["RTPU.FAILOVER.AUTH", "R0", "8", "P0"],
                              ["RTPU.FAILOVER.AUTH", "R0", "8", "P0"],
                              ["RTPU.FAILOVER.AUTH", "P2", "9", "P0"]]) == [1, 0, 0]
        assert [e["kind"] for e in nodes[1][0].obs.events.snapshot(kind="failover.")] \
            == ["failover.vote"]
        spec = f"0-{per - 1}"
        for i in (1, 2):
            assert _req(addr[i], [["RTPU.TAKEOVER", "R0", "P0", "8", spec],
                                  ["RTPU.TAKEOVER", "P2", "P0", "3", spec]]) == [per, 0]
            sm = nodes[i][1].cluster.slotmap
            assert sm.owner(0) == "R0" and sm.role("P0") == "replica"
            assert nodes[i][1].failover.state.current_epoch == 8
        (shards,) = _req(addr[2], [["CLUSTER", "SHARDS"]])
        owners = {bytes(s[3][0][1]): s[1] for s in shards}
        assert owners[b"R0"] == [0, per - 1] and owners[b"P0"] == []
    finally:
        for cl, srv in nodes:
            srv.close()
            cl.shutdown()


def test_manual_failover_carries_the_cluster_epoch(tmp_path):
    """FAILOVER on a cluster replica with an agent promotes it one epoch
    past the cluster's; INFO replication then reports the master role and
    the replicated write is in the promoted keyspace."""
    from redisson_tpu_torch.cluster.failover import FailoverAgent
    from redisson_tpu_torch.serve.resp import RespServer

    pp, rp = _free_port(), _free_port()
    topo = {"nodes": [
        {"id": "P", "host": "127.0.0.1", "port": pp, "slots": [[0, NSLOTS - 1]]},
        {"id": "R", "host": "127.0.0.1", "port": rp, "slots": [],
         "role": "replica", "replica_of": "P"},
    ]}
    made = []
    try:
        for nid, port in (("P", pp), ("R", rp)):
            cfg = rt.Config().use_gpu_sketch(device="cpu", min_bucket=64)
            cfg.cluster_enabled = True
            cfg.cluster_topology = topo
            cfg.cluster_node_id = nid
            cfg.journal_dir = str(tmp_path / nid / "journal")
            cfg.snapshot_dir = str(tmp_path / nid / "snap")
            cfg.journal_fsync = "no"
            cl = rt.create(cfg)
            srv = RespServer(cl, port=port)
            FailoverAgent(srv, node_timeout_s=1.0, ping_interval_s=3600.0)
            made.append((cl, srv))
        (_, psrv), (_, rsrv) = made
        assert _req(("127.0.0.1", pp), [["SET", "k", "v"]]) == [b"OK"]
        link = rsrv.start_replication_from("127.0.0.1", pp)
        assert link.repl_ident == "R"
        deadline = time.monotonic() + 20
        while not (link.link_up and link.lag_ops() == 0):
            assert time.monotonic() < deadline, "replica never caught up"
            time.sleep(0.05)
        rsrv.failover.state.note_ping("P", 4)
        assert _req(("127.0.0.1", rp), [["FAILOVER"]]) == [b"OK"]
        assert rsrv._promote_epoch == 5
        (info,) = _req(("127.0.0.1", rp), [["INFO", "replication"]])
        assert b"role:master" in info
        # A manual FAILOVER promotes without a takeover broadcast (as in
        # the JAX package): the slot still routes to P, and the promoted
        # keyspace holds the replicated write.
        (moved,) = _req(("127.0.0.1", rp), [["GET", "k"]])
        assert moved.code == "MOVED" and str(moved).endswith(":%d" % pp)
        assert rsrv._exists_any("k")
    finally:
        for cl, srv in made:
            srv.close()
            cl.shutdown()
