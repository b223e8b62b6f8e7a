"""The port's rebalancer and fleet doctor against the JAX package's.

* The planner: one seeded sequence of per-node CLUSTER LOADMAP payloads
  (three nodes, zipf heat and device time, a node that drops out, a
  drain and an undrain) goes through each package's agent scrape and
  planner at the same ``now`` values; every scrape, plan, smoothed heat
  and planner state is equal.
* The wire: an armed JAX node and an armed port node (a rebalance agent
  and a fleet doctor on node A of a two-node fleet, driven by NOW) answer
  a seeded session of CLUSTER REBALANCE STATUS|PAUSE|RESUME|DRAIN|
  UNDRAIN|NOW, CLUSTER DOCTOR STATUS|NOW|PAUSE|RESUME, INFO rebalance|
  doctor and CONFIG GET|SET rebalance-* with equal replies.  Masked: the
  nodes' ports, and in CLUSTER DOCTOR STATUS the sweep's duration
  (``last_sweep_ms``) — the node ids are the topology's on both fleets.
* A mixed fleet: node A a JAX server, node B a port server; the port's
  agent on B drives waves by NOW and moves a hot Bloom slot from the JAX
  node to the port node, whose row then equals the golden filter of the
  keys added, with the DUMP byte-equal across the move.
"""

import json
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
from redisson_tpu.cluster import rebalancer as jax_rb  # noqa: E402
from redisson_tpu.cluster.slotmap import SlotMap as JaxSlotMap  # noqa: E402
from redisson_tpu_torch.cluster import rebalancer as port_rb  # noqa: E402
from redisson_tpu_torch.cluster.slotmap import SlotMap as PortSlotMap  # noqa: E402
from redisson_tpu_torch.cluster.slots import NSLOTS, key_slot  # noqa: E402
from redisson_tpu_torch.serve.wireutil import exchange  # noqa: E402
from test_torch_grid_coordination import _one_torch_thread  # noqa: E402,F401

_FIELDS = ["ops", "reads", "writes", "bytes_in", "bytes_out", "shed",
           "device_us", "keys"]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _req(addr, cmds, timeout=30.0):
    sock = socket.create_connection(addr, timeout=timeout)
    try:
        return exchange(sock, cmds)
    finally:
        sock.close()


# -- the planner on one seeded scrape sequence ----------------------------------


_TOPO3 = {"nodes": [
    {"id": "A", "host": "h", "port": 1, "slots": [[0, 15]]},
    {"id": "B", "host": "h", "port": 2, "slots": [[16, 31]]},
    {"id": "C", "host": "h", "port": 3, "slots": [[32, 47]]},
]}


def _bare_agent(mod, slotmap_cls, payloads):
    """An agent of ``mod`` without a server: its slot map and a ``_call``
    answering CLUSTER LOADMAP from ``payloads`` (None = unreachable)."""
    agent = mod.RebalanceAgent.__new__(mod.RebalanceAgent)
    agent.slotmap = slotmap_cls.from_dict(_TOPO3)
    agent._call = lambda nid, *cmd: payloads.get(nid)
    return agent


def _planner_state(p) -> str:
    return json.dumps({
        "heat": sorted(p.heat.items()), "slot_keys": sorted(p.slot_keys.items()),
        "ticks": p.ticks, "last_ratio": p.last_ratio,
        "last_loads": sorted(p.last_loads.items()),
        "draining": sorted(p.draining),
    })


def test_planner_plans_equal_the_jax_planner():
    rng = np.random.default_rng(1414)
    owners = {s: "ABC"[s // 16] for s in range(48)}
    cum = {s: [0, 0.0] for s in range(48)}
    payloads: dict = {}
    agents = [_bare_agent(jax_rb, JaxSlotMap, payloads),
              _bare_agent(port_rb, PortSlotMap, payloads)]
    kw = dict(threshold=1.3, max_moves=4, cooldown_s=5.0, min_heat=1.0,
              warmup_ticks=3)
    planners = [jax_rb.RebalancePlanner(**kw), port_rb.RebalancePlanner(**kw)]
    moved = 0
    for tick in range(60):
        now = 0.5 * tick
        # Zipf heat over the slots (node A's run hot), device time on a
        # third of them, one key or more per slot.
        hits = rng.zipf(1.3, 400) % 48
        for s in hits:
            cum[int(s)][0] += 1
            if s % 3 == 0:
                cum[int(s)][1] += float(rng.integers(50, 500))
        payloads.clear()
        for nid in "ABC":
            if nid == "C" and 20 <= tick < 24:
                continue  # C unreachable for four scrapes
            slots = {str(s): [cum[s][0], 0, 0, 0, 0, 0, round(cum[s][1], 1),
                              1 + s % 5]
                     for s, o in owners.items() if o == nid}
            payloads[nid] = json.dumps({"fields": _FIELDS, "slots": slots,
                                        "node": nid}).encode()
        if tick == 30:
            for p in planners:
                p.drain("B")
        if tick == 34:
            for p in planners:
                p.undrain("B")
        scrapes = [a._scrape() for a in agents]
        assert scrapes[0] == scrapes[1], tick
        per_node, down = scrapes[1]
        plans = []
        for p in planners:
            p.observe(per_node, now)
            plans.append(p.plan(owners, ["A", "B", "C"], down, now))
        assert [tuple(m) for m in plans[0]] == [tuple(m) for m in plans[1]], tick
        assert _planner_state(planners[0]) == _planner_state(planners[1]), tick
        for mv in plans[1]:
            owners[mv.slot] = mv.dst
            moved += 1
            for p in planners:
                p.note_moved(mv.slot, now)
    assert moved > 0, "the sequence never planned a move"


# -- the armed surfaces over the wire ----------------------------------------------


def _fleet(package: str):
    pa, pb = _free_port(), _free_port()
    topo = {"nodes": [
        {"id": "A", "host": "127.0.0.1", "port": pa, "slots": [[0, 8191]]},
        {"id": "B", "host": "127.0.0.1", "port": pb,
         "slots": [[8192, NSLOTS - 1]]},
    ]}
    nodes = []
    for nid, port in (("A", pa), ("B", pb)):
        if package == "jax":
            from redisson_tpu.serve.resp import RespServer

            cfg = redisson_tpu.Config().use_tpu_sketch(min_bucket=64)
            make = redisson_tpu.create
        else:
            from redisson_tpu_torch.serve.resp import RespServer

            cfg = rt.Config().use_gpu_sketch(device="cpu", min_bucket=64)
            make = rt.create
        cfg.cluster_enabled = True
        cfg.cluster_topology = topo
        cfg.cluster_node_id = nid
        client = make(cfg)
        nodes.append((client, RespServer(client, port=port)))
    return nodes, [("127.0.0.1", pa), ("127.0.0.1", pb)]


def _armed_session(package: str) -> list:
    if package == "jax":
        from redisson_tpu.cluster.rebalancer import RebalanceAgent
        from redisson_tpu.obs.doctor import FleetDoctor
    else:
        from redisson_tpu_torch.cluster.rebalancer import RebalanceAgent
        from redisson_tpu_torch.obs.doctor import FleetDoctor
    nodes, (a, b) = _fleet(package)
    try:
        srv = nodes[0][1]
        RebalanceAgent(srv, interval_s=60.0, threshold=1.3, max_moves=8,
                       pace_s=0.0, cooldown_s=15.0)
        FleetDoctor(srv, interval_s=3600.0, stuck_slot_s=30.0, canary=True)
        hot = []
        i = 0
        while len(hot) < 3:
            k = f"dk{i}"
            i += 1
            if key_slot(k) < 8192 and key_slot(k) not in {key_slot(h) for h in hot}:
                hot.append(k)
        out = []
        out += _req(a, [["CLUSTER", "REBALANCE", "STATUS"],
                        ["CLUSTER", "DOCTOR", "STATUS"],
                        ["INFO", "rebalance"], ["INFO", "doctor"],
                        ["CONFIG", "GET", "rebalance-*"],
                        ["CONFIG", "SET", "rebalance-threshold", "0.5"],
                        ["CONFIG", "SET", "rebalance-max-moves", "0"],
                        ["CONFIG", "SET", "rebalance-pace-ms", "x"],
                        ["CONFIG", "SET", "rebalance-max-moves", "4",
                         "rebalance-cooldown-ms", "20000"],
                        ["CONFIG", "GET", "rebalance-*"],
                        ["CLUSTER", "REBALANCE", "PAUSE"],
                        ["CLUSTER", "REBALANCE", "STATUS"],
                        ["CLUSTER", "REBALANCE", "RESUME"],
                        ["CLUSTER", "REBALANCE", "DRAIN", "B"],
                        ["CLUSTER", "REBALANCE", "STATUS"],
                        ["CLUSTER", "REBALANCE", "UNDRAIN", "B"],
                        ["CLUSTER", "REBALANCE", "DRAIN"],
                        ["CLUSTER", "REBALANCE", "BOGUS"],
                        ["CLUSTER", "DOCTOR", "BOGUS"],
                        ["CLUSTER", "DOCTOR", "PAUSE"],
                        ["INFO", "doctor"],
                        ["CLUSTER", "DOCTOR", "RESUME"]])
        # Host-side traffic only (SET: no device time), so both nodes'
        # heat is ops alone and the waves agree.
        for _ in range(6):
            _req(a, [["SET", k, "v"] for k in hot for _ in range(20)])
            out += _req(a, [["CLUSTER", "REBALANCE", "NOW"],
                            ["CLUSTER", "DOCTOR", "NOW"]])
        out += _req(a, [["CLUSTER", "REBALANCE", "STATUS"],
                        ["CLUSTER", "DOCTOR", "STATUS"],
                        ["INFO", "rebalance"], ["INFO", "doctor"]])
        out += _req(b, [["CLUSTER", "REBALANCE", "STATUS"],
                        ["CLUSTER", "DOCTOR", "STATUS"],
                        ["CLUSTER", "DOCTOR", "NOW"], ["INFO", "rebalance"],
                        ["CONFIG", "GET", "rebalance-*"]])
        out += _req(b, [["GET", k] for k in hot])
        return _masked(out, [a[1], b[1]])
    finally:
        for client, server in nodes:
            server.close()
            client.shutdown()


def _masked(replies, ports) -> list:
    out = []
    for r in replies:
        if isinstance(r, (bytes, bytearray)) and r[:1] == b"{":
            d = json.loads(r)
            d.pop("last_sweep_ms", None)
            r = json.dumps(d, sort_keys=True).encode()
        if isinstance(r, Exception):
            r = ("error", str(r).encode())
        if isinstance(r, (bytes, bytearray)):
            for i, p in enumerate(ports):
                r = r.replace(b"%d" % p, b"PORT%d" % i)
        elif isinstance(r, tuple):
            for i, p in enumerate(ports):
                r = (r[0], r[1].replace(b"%d" % p, b"PORT%d" % i))
        out.append(r)
    return out


def test_armed_surfaces_equal_the_jax_node():
    jax, port = _armed_session("jax"), _armed_session("port")
    assert len(jax) == len(port)
    for i, (j, t) in enumerate(zip(jax, port)):
        assert j == t, (i, j, t)
    # The session really armed both agents and ran a wave.
    status = json.loads(port[-12])
    assert status["enabled"] and status["waves"] >= 1 and status["slots_moved"] >= 1


# -- a mixed fleet: the port's agent moves a hot slot off a JAX node ---------------


def test_port_agent_moves_a_hot_bloom_slot_from_a_jax_node():
    from redisson_tpu.serve.resp import RespServer as JaxServer
    from redisson_tpu_torch import codecs
    from redisson_tpu_torch.cluster.rebalancer import RebalanceAgent
    from redisson_tpu_torch.ops import golden
    from redisson_tpu_torch.serve.resp import RespServer
    from redisson_tpu_torch.utils import hashing

    pa, pb = _free_port(), _free_port()
    topo = {"nodes": [
        {"id": "A", "host": "127.0.0.1", "port": pa, "slots": [[0, 8191]]},
        {"id": "B", "host": "127.0.0.1", "port": pb,
         "slots": [[8192, NSLOTS - 1]]},
    ]}
    jcfg = redisson_tpu.Config().use_tpu_sketch(min_bucket=64)
    tcfg = rt.Config().use_gpu_sketch(device="cpu", min_bucket=64)
    nodes = []
    for nid, port, cfg, make, server in (("A", pa, jcfg, redisson_tpu.create, JaxServer),
                                         ("B", pb, tcfg, rt.create, RespServer)):
        cfg.cluster_enabled = True
        cfg.cluster_topology = topo
        cfg.cluster_node_id = nid
        client = make(cfg)
        nodes.append((client, server(client, port=port)))
    a, b = ("127.0.0.1", pa), ("127.0.0.1", pb)
    try:
        agent = RebalanceAgent(nodes[1][1], interval_s=60.0, pace_s=0.0,
                               cooldown_s=15.0)
        tags, i = [], 0
        while len(tags) < 3:
            t = "{hb%d}" % i
            i += 1
            if key_slot(t) < 8192 and key_slot(t) not in {key_slot(x) for x in tags}:
                tags.append(t)
        assert _req(a, [["BF.RESERVE", t + "bf", "0.01", "20000"] for t in tags]) == [b"OK"] * 3
        rng = np.random.default_rng(3)
        added = {t: [] for t in tags}
        moved = 0
        for _ in range(10):
            cmds = []
            for t in tags:
                items = [b"k%d" % v for v in rng.integers(0, 1 << 40, 64)]
                added[t] += items
                cmds += [["BF.MADD", t + "bf"] + items] * 2
            assert all(not isinstance(r, Exception) for r in _req(a, cmds))
            moved = agent.tick(force=True)
            if moved:
                break
        assert moved >= 1, "no wave moved a hot slot"
        ma, mb = nodes[0][1].cluster.slotmap, nodes[1][1].cluster.slotmap
        gone = [t for t in tags if ma.owner(key_slot(t)) == "B"]
        assert gone and all(mb.owner(key_slot(t)) == "B" for t in gone)
        st = agent.status()
        # Keyless commands (the agent's own scrapes) warm slot 0, which a
        # wave may move too: every hot tag that moved is checked below.
        assert st["slots_moved"] >= len(gone) and st["failures"] == 0, st
        port_client = nodes[1][0]
        eng = port_client._engine
        eng._drain()
        for t in gone:
            name = t + "bf"
            e = eng.registry.lookup(name)
            row = eng.executor.read_row(e.pool, e.row)
            bf = port_client.get_bloom_filter(name)
            m, k = bf.get_size(), bf.get_hash_iterations()
            h1, h2 = hashing.km_reduce_mod(*hashing.hash128_np(
                *codecs.encode_batch(port_client.config.codec, added[t])), m)
            g = golden.GoldenBloomFilter(m, k)
            g.bits[g._indexes(h1, h2).reshape(-1)] = True
            gbits = np.zeros(row.shape[0] * 32, bool)
            gbits[:m] = g.bits
            want = np.packbits(gbits, bitorder="little").view(np.uint32)
            assert np.array_equal(np.asarray(row).view(np.uint32), want), name
            assert _req(b, [["BF.MEXISTS", name] + added[t]]) == [[1] * len(added[t])]
            assert _req(a, [["CLUSTER", "COUNTKEYSINSLOT", str(key_slot(t))]]) == [0]
    finally:
        for client, server in nodes:
            server.close()
            client.shutdown()


# -- chip_smoke.py's phase 18 at a small size -----------------------------------


def test_chip_smoke_phase_18_on_the_cpu(monkeypatch):
    """The card phase's checks on the CPU: three armed in-process nodes,
    traffic windows until a NOW-driven wave moves hot slots off node A
    (the ratio falls, every slot moved once, every acked key reads back,
    moved rows equal golden, DUMPs byte-equal, zero doctor findings),
    then a stuck migration raised and cleared (18c).  18b's K1 launches
    need the card (``tests/test_torch_gpu.py``)."""
    import chip_smoke as cs

    monkeypatch.setattr(cs, "P18_DEVICE", "cpu")
    monkeypatch.setattr(cs, "P18", dict(
        cs.P18, capacity=60_000, cms_w=4096, madd=256, hot_madd=8, cold_madd=1,
        hot_incr=2, incr_draws=64))
    rng = np.random.default_rng(0)
    nodes, ids, addrs, cuts = cs.p18_fleet()
    try:
        a, owners, moved_hot, hot = cs.p18a_wave(nodes, ids, addrs, cuts, rng)
        assert a["ratio_before"] > 1.3 and a["ratio_after"] < a["ratio_before"]
        assert a["windows_to_first_wave"] == 3 and a["hot_slots_moved"] >= 1
        assert a["moved_rows_equal_golden"] and a["quiet_dumps_equal"]
        c = cs.p18c_doctor(nodes, ids, addrs, owners, hot)
        assert c["stuck_raised"] and c["stuck_cleared"]
        assert set(c["canary_rtt_ms"]) == set(ids)
    finally:
        cs.p18_close(nodes)
