"""The port's cluster mode against the JAX package's: slot math, the slot
map, the door's redirect protocol, the routing client, live slot
migration and the subprocess supervisor.

* ``tests/test_cluster.py`` runs again on the port: ``port_namespace``
  rebinds the whole reference module — its tests, its ``cluster2``
  fixture and the ``_Cluster2``, ``_FakeNode`` and ``_raw`` helpers —
  so every helper reaches the port's server, client and wire codec.  The
  supervisor test keeps its ``slow`` mark and runs its three nodes with
  ``--device cpu`` (``cpu_builtins``: the reference body's
  ``ClusterSupervisor`` is the port's with the CPU as its default).
* A mixed fleet: node A a JAX ``RespServer``, node B a port
  ``RespServer``, splitting the slots at 8192.  A slot seeded with a
  Bloom filter, an HLL, a BitSet, a CMS, a top-K and strings moves A -> B
  and back with ``migrate_slot``; every DUMP stays byte-equal, every read
  equals the golden model, and the key counts follow the slot.
* A seeded session of CLUSTER SLOTS|SHARDS|NODES|KEYSLOT|INFO|MYID,
  redirects, CROSSSLOT, ASKING, MIGRATE and INFO cluster on a two-node
  JAX fleet and on a two-node port fleet: replies byte-equal after
  masking the ports.
* The entry point: ``ClusterSupervisor(n_nodes=2, device="cpu")`` boots
  two ``python -m redisson_tpu_torch --cluster`` nodes, routes through
  ``connect_cluster``, moves a slot holding a Bloom filter, reads it back
  on the target and shuts down with no process left; a ``cuda`` node
  without a card exits 2 and the supervisor names it.
* A key on the HOST tier of the residency ladder migrates with its
  truth (its DUMP is the row's, not the empty device row).
"""

import builtins
import inspect
import socket
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
import test_cluster as _ref  # noqa: E402
from _pytest.fixtures import FixtureFunctionDefinition  # noqa: E402
from redisson_tpu_torch.analysis import witness as port_witness  # noqa: E402
from redisson_tpu_torch.cluster import supervisor as port_supervisor  # noqa: E402
from redisson_tpu_torch.cluster.slots import NSLOTS, key_slot  # noqa: E402
from redisson_tpu_torch.serve.wireutil import exchange  # noqa: E402
from test_torch_grid_coordination import (  # noqa: E402,F401
    _BUILTINS,
    _one_torch_thread,
    _port_import,
    _port_value,
)


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


# -- running a reference module's tests, fixtures and helpers on the port -----


def _fixture(fdef, fn):
    m = fdef._fixture_function_marker
    return pytest.fixture(fn, scope=m.scope, params=m.params,
                          autouse=m.autouse, ids=m.ids, name=fdef.name)


def port_namespace(ref, builtins_=None, skip=(), extra=None,
                   export=()) -> dict:
    """The reference module ``ref`` rebound to the port as one namespace:
    every function, fixture and class the module defines is rebuilt over
    ONE shared globals dict whose JAX-package values are the port's, so
    helpers calling helpers stay on the port.  Classes become subclasses
    whose methods (and fixtures) are rebound; marks are kept.  ``extra``
    replaces globals (a helper the module imports from another reference
    module, already rebound).  Returns the tests, ``Test*`` classes and
    fixtures to bind into a test module, plus the rebound helpers named
    in ``export`` (``skip`` names are left out)."""
    g = {k: _port_value(v) for k, v in vars(ref).items()}
    g.update(extra or {})
    g["__builtins__"] = builtins_ or _BUILTINS

    def func(f):
        closure = f.__closure__
        inner = getattr(f, "__wrapped__", None)
        if inspect.isfunction(inner) and "fn" in f.__code__.co_freevars:
            # A decorator's wrapper (``schedule_test``) closes over the
            # reference body as ``fn``: rebind that body too, or the
            # wrapper would run the JAX package's code.
            i = f.__code__.co_freevars.index("fn")
            closure = (closure[:i] + (types.CellType(func(inner)),)
                       + closure[i + 1:])
        new = types.FunctionType(f.__code__, g, f.__name__, f.__defaults__,
                                 closure)
        new.__kwdefaults__ = f.__kwdefaults__
        new.__doc__ = f.__doc__
        new.__qualname__ = f.__qualname__
        marks = getattr(f, "pytestmark", None)
        if marks:
            new.pytestmark = list(marks)
        return new

    def member(v):
        if isinstance(v, FixtureFunctionDefinition):
            return _fixture(v, func(v._get_wrapped_function()))
        if inspect.isfunction(v):
            return func(v)
        return None

    out = {}
    for name, obj in vars(ref).items():
        if name in (extra or {}):
            continue
        if isinstance(obj, FixtureFunctionDefinition):
            g[name] = out[name] = member(obj)
        elif inspect.isfunction(obj) and obj.__module__ == ref.__name__:
            g[name] = func(obj)
            if name.startswith("test_"):
                out[name] = g[name]
        elif inspect.isclass(obj) and obj.__module__ == ref.__name__:
            bases = tuple(_port_value(b) for b in obj.__bases__)
            if bases != obj.__bases__:
                # Derived from a JAX-package class (a mutation of the
                # shipped code): rebuilt whole over the port's base.
                ns = {k: v for k, v in vars(obj).items()
                      if k not in ("__dict__", "__weakref__")}
                ns["__module__"] = __name__
                for k, v in vars(obj).items():
                    new = member(v)
                    if new is not None:
                        ns[k] = new
                cls = g[name] = type(name, bases, ns)
                for k, v in ns.items():
                    # Zero-argument super() reads the ``__class__`` cell:
                    # point it at the rebuilt class.
                    if (inspect.isfunction(v)
                            and "__class__" in v.__code__.co_freevars):
                        i = v.__code__.co_freevars.index("__class__")
                        cells = (v.__closure__[:i] + (types.CellType(cls),)
                                 + v.__closure__[i + 1:])
                        fixed = types.FunctionType(
                            v.__code__, g, v.__name__, v.__defaults__, cells)
                        fixed.__kwdefaults__ = v.__kwdefaults__
                        fixed.__qualname__ = v.__qualname__
                        setattr(cls, k, fixed)
                if name.startswith("Test"):
                    out[name] = g[name]
                continue
            ns = {"__module__": __name__}
            for k, v in vars(obj).items():
                new = member(v)
                if new is not None:
                    ns[k] = new
            g[name] = type(name, (obj,), ns)
            if name.startswith("Test"):
                out[name] = g[name]
    for name in export:
        out[name] = g[name]
    for name in skip:
        out.pop(name, None)
    return out


class CpuClusterSupervisor(port_supervisor.ClusterSupervisor):
    """The port's supervisor as a reference body builds the JAX one: the
    CPU by default, ``platform=`` read as ``device=``."""

    def __init__(self, *args, platform=None, device="cpu", **kwargs):
        super().__init__(*args, device=platform or device, **kwargs)


class _CpuSupervisorModule(types.ModuleType):
    def __init__(self):
        super().__init__("redisson_tpu_torch.cluster.supervisor")
        self.ClusterSupervisor = CpuClusterSupervisor

    def __getattr__(self, item):
        return getattr(port_supervisor, item)


_CPU_SUPERVISOR = _CpuSupervisorModule()


def _cpu_import(name, globals=None, locals=None, fromlist=(), level=0):
    if level == 0 and name == "redisson_tpu.cluster.supervisor" and fromlist:
        return _CPU_SUPERVISOR
    return _port_import(name, globals, locals, fromlist, level)


# Builtins whose ``import`` gives a reference body the CPU supervisor.
cpu_builtins = dict(vars(builtins), __import__=_cpu_import)

globals().update(port_namespace(_ref, cpu_builtins))


# -- helpers --------------------------------------------------------------------


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


def _raw_bytes(addr, cmds, timeout=30.0) -> list:
    """The raw reply frames of ``cmds`` (one pipelined write)."""
    from redisson_tpu_torch.serve.wireutil import decode_reply, wire_command

    sock = socket.create_connection(addr, timeout=timeout)
    try:
        sock.sendall(b"".join(wire_command(c) for c in cmds))
        buf, out, pos = b"", [], 0
        while len(out) < len(cmds):
            chunk = sock.recv(1 << 16)
            assert chunk, "server closed early"
            buf += chunk
            while len(out) < len(cmds):
                try:
                    _, end = decode_reply(buf, pos)
                except (IndexError, ValueError):
                    break
                out.append(buf[pos:end])
                pos = end
        return out
    finally:
        sock.close()


def _topology(pa, pb):
    return {"nodes": [
        {"id": "A", "host": "127.0.0.1", "port": pa, "slots": [[0, 8191]]},
        {"id": "B", "host": "127.0.0.1", "port": pb,
         "slots": [[8192, NSLOTS - 1]]},
    ]}


def _jax_node(topo, nid, port, sketch=True):
    from redisson_tpu.serve.resp import RespServer as JaxServer

    cfg = redisson_tpu.Config()
    if sketch:
        cfg.use_tpu_sketch(min_bucket=64)
    cfg.cluster_enabled = True
    cfg.cluster_topology = topo
    cfg.cluster_node_id = nid
    client = redisson_tpu.create(cfg)
    return client, JaxServer(client, port=port)


def _port_node(topo, nid, port, **kw):
    from redisson_tpu_torch.serve.resp import RespServer

    cfg = rt.Config().use_gpu_sketch(device="cpu", min_bucket=64, **kw)
    cfg.cluster_enabled = True
    cfg.cluster_topology = topo
    cfg.cluster_node_id = nid
    client = rt.create(cfg)
    return client, RespServer(client, port=port)


def _close(nodes):
    for client, server in nodes:
        server.close()
        client.shutdown()


# -- a mixed fleet: a JAX node and a port node move a slot both ways ----------


_TAG = "{mix}"


def _seed_cmds(rng) -> tuple:
    """Commands seeding one slot with every sketch kind and strings, and
    the golden model of what they wrote."""
    items = [b"i%d" % v for v in rng.integers(0, 1 << 30, 300)]
    hll = [b"h%d" % v for v in rng.integers(0, 1 << 30, 2000)]
    bits = sorted({int(v) for v in rng.integers(0, 1 << 16, 200)})
    events = [b"e%d" % v for v in (rng.zipf(1.2, 400) % 50)]
    strings = {f"{_TAG}s{i}": "v%d" % rng.integers(0, 1 << 30) for i in range(20)}
    cmds = [["BF.RESERVE", _TAG + "bf", "0.01", "10000"],
            ["BF.MADD", _TAG + "bf"] + items,
            ["PFADD", _TAG + "hll"] + hll]
    cmds += [["SETBIT", _TAG + "bits", str(b), "1"] for b in bits]
    cmds += [["CMS.INITBYDIM", _TAG + "cms", "256", "4"]]
    cmds += [["CMS.INCRBY", _TAG + "cms"] + [x for e in events[i:i + 50] for x in (e, b"1")]
             for i in range(0, len(events), 50)]
    cmds += [["TOPK.RESERVE", _TAG + "topk", "5", "256", "4", "0.9"],
             ["TOPK.ADD", _TAG + "topk"] + events]
    cmds += [["SET", k, v] for k, v in strings.items()]
    counts = {}
    for e in events:
        counts[e] = counts.get(e, 0) + 1
    golden = {"items": items, "hll_n": len(set(hll)), "bits": bits,
              "counts": counts, "strings": strings}
    return cmds, golden


_NAMES = ("bf", "hll", "bits", "cms", "topk")


def _reads(addr, golden) -> list:
    probe = sorted(golden["counts"])
    return _req(addr, [
        ["BF.MEXISTS", _TAG + "bf"] + golden["items"],
        ["PFCOUNT", _TAG + "hll"],
        ["BITCOUNT", _TAG + "bits"],
        ["CMS.QUERY", _TAG + "cms"] + probe,
        ["TOPK.LIST", _TAG + "topk"],
    ] + [["GET", k] for k in golden["strings"]])


def test_mixed_fleet_moves_every_sketch_kind_both_ways():
    from redisson_tpu_torch.cluster.supervisor import migrate_slot

    slot = key_slot(_TAG)
    pa, pb = _free_port(), _free_port()
    topo = _topology(pa, pb)
    nodes = {"A": _jax_node(topo, "A", pa), "B": _port_node(topo, "B", pb)}
    addr = {"A": ("127.0.0.1", pa), "B": ("127.0.0.1", pb)}
    src = "A" if slot < 8192 else "B"
    dst = "B" if src == "A" else "A"
    try:
        cmds, golden = _seed_cmds(np.random.default_rng(13))
        replies = _req(addr[src], cmds)
        assert not [r for r in replies if isinstance(r, Exception)], replies
        keys = [_TAG + n for n in _NAMES] + list(golden["strings"])
        dumps = _req(addr[src], [["DUMP", k] for k in keys])
        before = _reads(addr[src], golden)
        # The golden model: every loaded item present, the exact bit
        # count, the strings, CMS estimates at least the true counts.
        assert all(before[0])
        assert before[2] == len(golden["bits"])
        assert before[5:] == [v.encode() for v in golden["strings"].values()]
        probe = sorted(golden["counts"])
        assert all(est >= golden["counts"][e] for e, est in zip(probe, before[3]))
        assert abs(before[1] - golden["hll_n"]) <= 0.05 * golden["hll_n"]
        n = len(keys)
        for a, b in ((src, dst), (dst, src)):
            moved = migrate_slot(slot, addr[a], addr[b], notify=addr.values())
            assert moved == n
            assert _req(addr[b], [["DUMP", k] for k in keys]) == dumps
            assert _reads(addr[b], golden) == before
            for x, want in ((a, 0), (b, n)):
                assert _req(addr[x], [["CLUSTER", "COUNTKEYSINSLOT", str(slot)],
                                      ["DEBUG", "COUNTKEYSINSLOT", str(slot)]]) == [want, want]
            (moved_reply,) = _req(addr[a], [["GET", keys[-1]]])
            assert moved_reply.code == "MOVED"
    finally:
        _close(nodes.values())


# -- one seeded session, byte-equal on a JAX and a port fleet --------------------


def _session(rng, addr) -> list:
    """CLUSTER verbs, redirects, CROSSSLOT, ASKING and MIGRATE against a
    two-node fleet (``addr`` maps A and B); every reply's raw bytes."""
    from redisson_tpu_torch.cluster.supervisor import migrate_slot

    a, b = addr["A"], addr["B"]
    out = []
    keys = ["sk%d" % v for v in rng.integers(0, 1 << 20, 24)]
    for k in keys:
        home = a if key_slot(k) < 8192 else b
        away = b if home == a else a
        out += _raw_bytes(home, [["SET", k, "v" + k]])
        out += _raw_bytes(away, [["GET", k], ["SET", k, "x"]])
    out += _raw_bytes(a, [
        ["CLUSTER", "MYID"], ["CLUSTER", "SLOTS"], ["CLUSTER", "SHARDS"],
        ["CLUSTER", "NODES"], ["CLUSTER", "INFO"], ["CLUSTER", "MIGRATIONS"],
        ["CLUSTER", "KEYSLOT", "{user:1}.x"], ["CLUSTER", "KEYSLOT", keys[0]],
        ["MSET", keys[0], "1", keys[1], "2"], ["MSET", "{t}a", "1", "{t}b", "2"],
        ["CLUSTER", "NOPE"], ["CLUSTER", "SETSLOT", "5"],
        ["CLUSTER", "REBALANCE"], ["CLUSTER", "REBALANCE", "PAUSE"],
    ])
    tag = "{sess}"
    slot = key_slot(tag)
    home, away = (a, b) if slot < 8192 else (b, a)
    out += _raw_bytes(home, [["SET", tag + "k", "1"], ["RPUSH", tag + "l", "x"]])
    out += _raw_bytes(home, [["CLUSTER", "MIGRATABLE", str(slot)]])
    out += _raw_bytes(home, [["DEL", tag + "l"]])
    out += _raw_bytes(away, [
        ["CLUSTER", "SETSLOT", str(slot), "IMPORTING", "A" if home == a else "B"],
        ["ASKING"], ["SET", tag + "j", "2"], ["GET", tag + "j"],
        ["ASKING"], ["PING"], ["GET", tag + "j"],
        ["CLUSTER", "SETSLOT", str(slot), "STABLE"],
        ["ASKING"], ["DEL", tag + "j"],
    ])
    migrate_slot(slot, home, away, notify=addr.values())
    out += _raw_bytes(home, [["GET", tag + "k"], ["CLUSTER", "COUNTKEYSINSLOT", str(slot)],
                             ["INFO", "cluster"]])
    out += _raw_bytes(away, [["GET", tag + "k"], ["CLUSTER", "GETKEYSINSLOT", str(slot), "10"],
                             ["INFO", "cluster"], ["CLUSTER", "SLOTS"], ["CLUSTER", "NODES"],
                             ["CLUSTER", "MEET", "C", "127.0.0.1", "1"],
                             ["CLUSTER", "SHARDS"]])
    return out


def _masked(frames, ports) -> list:
    out = []
    for f in frames:
        for i, p in enumerate(ports):
            f = f.replace(b"%d" % p, b"PORT%d" % i)
        out.append(f)
    return out


def test_cluster_session_is_byte_equal_to_the_jax_fleet():
    replies = {}
    for name, make in (("jax", lambda t, n, p: _jax_node(t, n, p, sketch=False)),
                       ("port", _port_node)):
        pa, pb = _free_port(), _free_port()
        # The masks keep frame lengths only for ports of one width.
        assert len(str(pa)) == len(str(pb)) == 5
        topo = _topology(pa, pb)
        nodes = [make(topo, "A", pa), make(topo, "B", pb)]
        try:
            frames = _session(np.random.default_rng(7),
                              {"A": ("127.0.0.1", pa), "B": ("127.0.0.1", pb)})
        finally:
            _close(nodes)
        replies[name] = _masked(frames, (pa, pb))
    assert len(replies["jax"]) == len(replies["port"])
    for i, (j, p) in enumerate(zip(replies["jax"], replies["port"])):
        assert j == p, (i, j[:300], p[:300])


# -- the residency ladder: a HOST-tier key migrates with its truth ---------------


def test_host_tier_key_migrates_with_its_truth():
    from redisson_tpu_torch.cluster.supervisor import migrate_slot

    tag = "{tier}"
    slot = key_slot(tag)
    pa, pb = _free_port(), _free_port()
    topo = _topology(pa, pb)
    nodes = {"A": _port_node(topo, "A", pa), "B": _port_node(topo, "B", pb)}
    addr = {"A": ("127.0.0.1", pa), "B": ("127.0.0.1", pb)}
    src = "A" if slot < 8192 else "B"
    dst = "B" if src == "A" else "A"
    try:
        items = ["t%d" % i for i in range(64)]
        _req(addr[src], [["BF.RESERVE", tag + "bf", "0.01", "1000"],
                         ["BF.MADD", tag + "bf"] + items,
                         ["PFADD", tag + "hll"] + items])
        want = _req(addr[src], [["DUMP", tag + "bf"], ["DUMP", tag + "hll"]])
        assert _req(addr[src], [["DEBUG", "RESIDENCY", "DEMOTE", tag + "bf"],
                                ["DEBUG", "RESIDENCY", "DEMOTE", tag + "hll"]]) == [1, 1]
        assert _req(addr[src], [["OBJECT", "ENCODING", tag + "bf"]]) == [b"host"]
        assert migrate_slot(slot, addr[src], addr[dst], notify=addr.values()) == 2
        assert _req(addr[dst], [["DUMP", tag + "bf"], ["DUMP", tag + "hll"]]) == want
        assert _req(addr[dst], [["BF.MEXISTS", tag + "bf"] + items])[0] == [1] * 64
    finally:
        _close(nodes.values())


# -- the entry point through the supervisor ---------------------------------------


def test_supervisor_entry_point_moves_a_bloom_slot():
    """Two ``python -m redisson_tpu_torch --cluster --device cpu`` nodes:
    route through ``connect_cluster``, move a slot holding a Bloom filter,
    read it back on the target, and shut down with no process left."""
    from redisson_tpu_torch.cluster.supervisor import ClusterSupervisor

    sup = ClusterSupervisor(n_nodes=2, device="cpu", startup_timeout_s=45.0)
    procs = []
    try:
        sup.start()
        with sup._lock:
            procs = list(sup._procs)
        cc = rt.connect_cluster([sup.addrs[0]], timeout_s=20.0)
        try:
            keys = ["ep%d" % i for i in range(32)]
            assert cc.execute_many([("SET", k, k) for k in keys]) == [b"OK"] * 32
            assert cc.stats["scatter_legs"] == 2
            tag = "{epbf}"
            slot = key_slot(tag)
            src = 0 if slot < NSLOTS // 2 else 1
            assert cc.execute("BF.RESERVE", tag + "bf", "0.01", "1000") == b"OK"
            items = ["x%d" % i for i in range(50)]
            assert cc.execute("BF.MADD", tag + "bf", *items) == [1] * 50
            assert sup.migrate_slot(slot, 1 - src) == 1
            (flags,) = _req(sup.addrs[1 - src], [["BF.MEXISTS", tag + "bf"] + items])
            assert flags == [1] * 50
            (moved,) = _req(sup.addrs[src], [["BF.EXISTS", tag + "bf", "x0"]])
            assert moved.code == "MOVED"
            assert cc.execute_many([("GET", k) for k in keys]) == [k.encode() for k in keys]
        finally:
            cc.close()
    finally:
        clean = sup.shutdown(timeout_s=20.0)
    assert clean
    assert procs and all(p.poll() is not None for p in procs)


def test_cuda_node_without_a_card_is_named(monkeypatch):
    """A ``--device cuda`` node on a host without a card exits 2, and
    the supervisor's start names it — never a quiet CPU node."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the node would start")
    from redisson_tpu_torch.cluster.supervisor import ClusterSupervisor

    sup = ClusterSupervisor(n_nodes=1, device="cuda", startup_timeout_s=45.0)
    try:
        with pytest.raises(RuntimeError) as ei:
            sup.start()
    finally:
        sup.shutdown(timeout_s=10.0)
    msg = str(ei.value)
    assert "rc=2" in msg and "no CUDA device" in msg and "node-0-" in msg


def test_cluster_flags_need_cluster():
    """A --cluster-* flag without --cluster is refused before anything
    serves."""
    from redisson_tpu_torch import __main__ as entry

    with pytest.raises(SystemExit) as ei:
        entry.main(["--cluster-slots", "0-10", "--device", "cpu", "--port", "0"])
    assert ei.value.code == 2


def test_connect_cluster_is_exported():
    from redisson_tpu_torch.client import connect_cluster
    from redisson_tpu_torch.cluster import ClusterClient, migrate_slots_bulk

    assert "connect_cluster" in rt.__all__
    assert rt.connect_cluster.__doc__ and connect_cluster.__doc__
    assert ClusterClient.__module__ == "redisson_tpu_torch.cluster.client"
    assert migrate_slots_bulk.__module__ == "redisson_tpu_torch.cluster.supervisor"


def test_eval_on_a_migrating_slot_does_not_deadlock():
    """An EVAL whose key sits in a MIGRATING slot runs under the move
    guard, and its redis.call of that key routes through the door again
    on the same thread: the guard is re-entrant, so it answers (the JAX
    package's plain lock hangs here, ROADMAP queue 3)."""
    from redisson_tpu_torch.serve.resp import RespServer

    pa, pb = _free_port(), _free_port()
    topo = {"nodes": [
        {"id": "A", "host": "127.0.0.1", "port": pa, "slots": [[0, NSLOTS - 1]]},
        {"id": "B", "host": "127.0.0.1", "port": pb, "slots": []},
    ]}
    cfg = rt.Config().use_gpu_sketch(device="cpu", min_bucket=64)
    cfg.cluster_enabled = True
    cfg.cluster_topology = topo
    cfg.cluster_node_id = "A"
    client = rt.create(cfg)
    server = RespServer(client, port=pa, enable_python_scripts=True)
    try:
        slot = key_slot("{ev}k")
        assert _req(("127.0.0.1", pa), [
            ["SET", "{ev}k", "1"],
            ["CLUSTER", "SETSLOT", str(slot), "MIGRATING", "B"],
            ["EVAL", "redis.call('SET', KEYS[0], ARGV[0])", "1", "{ev}k", "2"],
            ["EVAL", "redis.call('GET', KEYS[0])", "1", "{ev}k"],
        ], timeout=10.0) == [b"OK", b"OK", b"OK", b"2"]
    finally:
        server.close()
        client.shutdown()


def test_script_undeclared_key_on_a_migrating_slot_does_not_deadlock():
    """The old order: a script holds the grid lock (Lua atomicity) and its
    redis.call of an undeclared key in a MIGRATING slot waited for the
    move guard, while a MIGRATE holding the guard waits for the grid lock
    to read the key (grid.store -> cluster.move -> grid.store, the cycle
    the armed witness reports).  Here the guard is held by another thread,
    as the migration pump holds it: the script now only tries the guard
    and answers TRYAGAIN, and the grid lock is free again at once; once
    the guard is free the same script runs."""
    import threading

    from redisson_tpu_torch.serve.resp import RespServer
    from redisson_tpu_torch.serve.wireutil import ReplyError

    pa, pb = _free_port(), _free_port()
    topo = {"nodes": [
        {"id": "A", "host": "127.0.0.1", "port": pa, "slots": [[0, NSLOTS - 1]]},
        {"id": "B", "host": "127.0.0.1", "port": pb, "slots": []},
    ]}
    cfg = rt.Config().use_gpu_sketch(device="cpu", min_bucket=64)
    cfg.cluster_enabled = True
    cfg.cluster_topology = topo
    cfg.cluster_node_id = "A"
    client = rt.create(cfg)
    server = RespServer(client, port=pa, enable_python_scripts=True)
    script = ["EVAL", "redis.call('GET', '{un}k')", "0"]
    try:
        slot = key_slot("{un}k")
        assert _req(("127.0.0.1", pa), [
            ["SET", "{un}k", "1"],
            ["CLUSTER", "SETSLOT", str(slot), "MIGRATING", "B"],
        ]) == [b"OK", b"OK"]
        held, done = threading.Event(), threading.Event()

        def pump():  # the migration pump's hold of the guard
            with server.cluster.move_lock:
                held.set()
                done.wait(30)

        th = threading.Thread(target=pump)
        th.start()
        try:
            assert held.wait(10)
            (r,) = _req(("127.0.0.1", pa), [script], timeout=10.0)
            assert isinstance(r, ReplyError) and "TRYAGAIN" in str(r), r
            assert client._grid.lock.acquire(timeout=5), "the script kept the grid lock"
            client._grid.lock.release()
        finally:
            done.set()
            th.join()
        assert _req(("127.0.0.1", pa), [script], timeout=10.0) == [b"1"]
    finally:
        server.close()
        client.shutdown()


def _abandon(client):
    """Drop a client without its shutdown snapshot (a kill -9): the
    journal tail is what the next boot recovers."""
    eng = client._engine
    j, eng.journal = eng.journal, None
    if j is not None:
        j.close()
    eng.config.snapshot_dir = client.config.snapshot_dir = None
    client.shutdown()


def test_a_move_is_journaled_on_both_sides(tmp_path):
    """The target's RESTORE and the source's delete are journaled like any
    write: a source that crashes after the move recovers without the
    moved keys, and the target's replica receives them through the
    replication stream."""
    from redisson_tpu_torch.cluster.supervisor import migrate_slot
    from redisson_tpu_torch.serve.resp import RespServer

    tag = "{jmv}"
    slot = key_slot(tag)
    pa, pb = _free_port(), _free_port()
    topo = _topology(pa, pb)
    src, dst = ("A", "B") if slot < 8192 else ("B", "A")
    addr = {"A": ("127.0.0.1", pa), "B": ("127.0.0.1", pb)}

    def node(nid, port, name=None):
        cfg = rt.Config().use_gpu_sketch(device="cpu", min_bucket=64)
        cfg.cluster_enabled = True
        cfg.cluster_topology = topo
        cfg.cluster_node_id = nid
        cfg.journal_dir = str(tmp_path / (name or nid) / "journal")
        cfg.snapshot_dir = str(tmp_path / (name or nid) / "snap")
        cfg.journal_fsync = "always"
        cl = rt.create(cfg)
        return cl, RespServer(cl, port=port)

    nodes = {nid: node(nid, addr[nid][1]) for nid in ("A", "B")}
    replica = node(dst, _free_port(), name="replica")
    try:
        keys = [tag + "s", tag + "bf", tag + "hll"]
        assert _req(addr[src], [["SET", keys[0], "v"],
                                ["BF.RESERVE", keys[1], "0.01", "1000"],
                                ["BF.ADD", keys[1], "x"], ["PFADD", keys[2], "a"]]) \
            == [b"OK", b"OK", 1, 1]
        link = replica[1].start_replication_from(*addr[dst])
        assert migrate_slot(slot, addr[src], addr[dst], notify=addr.values()) == 3
        assert _req(addr[dst], [["WAIT", "1", "10000"]]) == [1]
        assert all(replica[1]._exists_any(k) for k in keys)
        for k in keys:
            assert replica[1]._dump_payload(k) == nodes[dst][1]._dump_payload(k)
        assert link.lag_ops() == 0
        # kill -9 of the source, then a reboot from its journal.
        cl, srv = nodes.pop(src)
        srv.close()
        _abandon(cl)
        cl, srv = nodes[src] = node(src, addr[src][1])
        assert not any(srv._exists_any(k) for k in keys)
        assert _req(addr[src], [["DEBUG", "COUNTKEYSINSLOT", str(slot)]]) == [0]
    finally:
        for cl, srv in list(nodes.values()) + [replica]:
            srv.close()
            cl.shutdown()


def test_frontdoor_workers_of_a_cluster_node_redirect_after_the_handoff():
    """Two nodes of two front-door workers each: whichever worker a
    connection lands on, a key of the other node answers the same -MOVED
    (judged by the owning worker's door after the in-node handoff), and
    the node's own keys serve from every worker."""
    from redisson_tpu_torch.cluster.supervisor import ClusterSupervisor

    sup = ClusterSupervisor(n_nodes=2, device="cpu", frontdoor_processes=2,
                            startup_timeout_s=45.0)
    try:
        sup.start()
        mine = [k for k in ("fw%d" % i for i in range(200))
                if key_slot(k) < NSLOTS // 2][:24]
        theirs = [k for k in ("fw%d" % i for i in range(200))
                  if key_slot(k) >= NSLOTS // 2][:24]
        for _ in range(4):  # several connections: they land on both workers
            got = _req(sup.addrs[0], [["SET", k, k] for k in mine]
                       + [["GET", k] for k in mine] + [["GET", k] for k in theirs])
            assert got[:48] == [b"OK"] * 24 + [k.encode() for k in mine]
            for k, r in zip(theirs, got[48:]):
                assert str(r) == "MOVED %d %s:%d" % ((key_slot(k),) + tuple(sup.addrs[1]))
        (info,) = _req(sup.addrs[0], [["INFO", "cluster"]])
        assert b"cluster_enabled:1" in info
    finally:
        assert sup.shutdown(timeout_s=20.0)
