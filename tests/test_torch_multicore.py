"""The per-core front door on the port against the JAX package's.

* The JAX package's ``tests/test_multicore.py`` runs again on the port
  (``port_module``): the pure units (worker_of_slot, worker_tag,
  device_slice, the reuseport probe) with their parametrisation, and the
  in-process pair — two port ``RespServer``s (``device="cpu"``) on one
  SO_REUSEPORT port — with every ``test_pair_*``.  Replaced by port cases
  of the same name: ``test_resolve_device_slice_fake_devices`` and
  ``test_executor_pins_device_slice`` (the JAX device enumeration becomes
  ``worker_device``'s ``cuda:<i>`` pinning under a fake card count) and
  ``test_effective_processes_fallback_logs_and_degrades`` (the port logs
  as ``redisson_tpu_torch.frontdoor``).  The forked suite
  (``test_multicore_node_k2_smoke``, the K=4 differential soak, the chaos
  soak) runs with ``MulticoreNode(..., device="cpu")`` and stays ``slow``.
* Each command list of the pair tests goes to a JAX pair and a port pair
  from a connection landed on worker 0: equal reply bytes.
* A fused run never carries a key a sibling owns, on the reactor and on
  the thread-per-connection path (the JAX package's thread path fuses a
  pipelined sibling run locally: ROADMAP queue 3).
* Script and function registries reach every worker; a script's
  redis.call never takes a handoff leg.
* A forked K=2 node from the entry point (``python -m redisson_tpu_torch
  --frontdoor-processes 2 --device cpu``) serves keyless, forwarded and
  split commands, exits 0 on SIGTERM and leaves no worker behind; a
  worker asked for ``cuda`` on a machine without a card exits non-zero
  and the node reports it.
"""

import logging
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

import pytest

torch = pytest.importorskip("torch")

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
import test_multicore as _ref  # noqa: E402
from redisson_tpu import chaos as jax_chaos  # noqa: E402
from redisson_tpu.serve.resp import RespServer as JaxRespServer  # noqa: E402
from redisson_tpu_torch import chaos  # noqa: E402
from redisson_tpu_torch.serve import multicore, wireutil  # noqa: E402
from redisson_tpu_torch.serve.multicore import (  # noqa: E402
    MulticoreNode,
    effective_processes,
    worker_device,
    worker_tag,
)
from redisson_tpu_torch.serve.resp import RespServer  # noqa: E402
from test_torch_grid_coordination import _one_torch_thread, port_case  # noqa: E402,F401
from test_torch_observability import port_module  # noqa: E402

SKIPPED = {
    "test_resolve_device_slice_fake_devices":
        "replaced below by the port's cuda:<i> case of the same name",
    "test_executor_pins_device_slice":
        "replaced below by the port's cuda:<i> case of the same name",
    "test_effective_processes_fallback_logs_and_degrades":
        "replaced below: the port's logger is redisson_tpu_torch.frontdoor",
    "test_multicore_node_k2_smoke": "rebound below with device='cpu'",
    "test_differential_soak_k4_byte_identical": "rebound below with device='cpu'",
    "test_chaos_soak_handoff_legs_fail_clean": "rebound below with device='cpu'",
}

port_module(_ref, globals(), skip=SKIPPED)

NW = 2


def _key(w, suffix, nworkers=NW):
    return ("{%s}%s" % (worker_tag(w, nworkers), suffix)).encode()


# -- the forked suite, rebound with device="cpu" (slow, as in the reference) ----


def _cpu_node(nworkers, platform="cpu", **kw):
    return MulticoreNode(nworkers, device=platform, **kw)


def _forked(name):
    fn = getattr(_ref, name)
    new = port_case(fn, MulticoreNode=_cpu_node)
    new.pytestmark = list(fn.pytestmark)
    return new


test_multicore_node_k2_smoke = _forked("test_multicore_node_k2_smoke")
test_differential_soak_k4_byte_identical = _forked(
    "test_differential_soak_k4_byte_identical")
test_chaos_soak_handoff_legs_fail_clean = _forked(
    "test_chaos_soak_handoff_legs_fail_clean")


# -- device pinning and the fallback, the port's cases ---------------------------


def test_resolve_device_slice_fake_devices():
    """Each worker of K takes the first card of its contiguous 1/K slice
    of a node's cards; with fewer cards than workers every worker keeps
    the default card, and a CPU or explicit device is never rewritten."""
    assert [worker_device("cuda", i, 4, 8) for i in range(4)] == [
        "cuda:0", "cuda:2", "cuda:4", "cuda:6"]
    assert [worker_device("cuda", i, 3, 8) for i in range(3)] == [
        "cuda:0", "cuda:2", "cuda:5"]
    assert worker_device("cuda", 3, 4, 1) == "cuda"
    assert worker_device("cuda", 1, 4, 0) == "cuda"
    assert worker_device("cpu", 1, 2, 8) == "cpu"
    assert worker_device("cuda:3", 0, 2, 8) == "cuda:3"


def test_executor_pins_device_slice(monkeypatch):
    """An executor built for worker 1 of 2 on a (faked) 4-card node holds
    exactly cuda:2; with no card at all, construction raises."""
    from redisson_tpu_torch.executor.torch_executor import TorchCommandExecutor

    cfg = rt.Config().use_gpu_sketch(device=worker_device("cuda", 1, 2, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchCommandExecutor(cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    ex = TorchCommandExecutor(cfg)
    assert ex.device == torch.device("cuda", 2)


def test_effective_processes_fallback_logs_and_degrades(monkeypatch, caplog):
    monkeypatch.setattr(multicore, "reuseport_available", lambda: False)
    with caplog.at_level(logging.INFO, logger="redisson_tpu_torch.frontdoor"):
        assert effective_processes(4) == 1
    msgs = [r for r in caplog.records if "SO_REUSEPORT" in r.getMessage()]
    assert msgs, "fallback must log an INFO frontdoor line"
    assert msgs[0].levelno == logging.INFO
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="redisson_tpu_torch.frontdoor"):
        assert effective_processes(1) == 1
        assert effective_processes(None) == 1
    assert not caplog.records


# -- JAX pair vs port pair, byte for byte ----------------------------------------


def _make_pair(make_client, server_cls, rundir, reactor=True):
    servers, clients = [], []
    port = 0
    for i in range(NW):
        client = make_client(i)
        client.config.frontdoor_workers = NW
        client.config.frontdoor_index = i
        client.config.frontdoor_dir = rundir
        client.config.resp_reactor = reactor
        clients.append(client)
        servers.append(server_cls(client, host="127.0.0.1", port=port,
                                  enable_python_scripts=True))
        port = servers[-1].port
    return servers, clients


def _close_pair(servers, clients):
    for s in servers:
        s.close()
    for c in clients:
        c.shutdown()


def _jax_client(i):
    return redisson_tpu.create(redisson_tpu.Config().use_tpu_sketch(min_bucket=64))


def _port_client(i):
    return rt.create(rt.Config().use_gpu_sketch(device="cpu", min_bucket=64))


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    jax_pair = _make_pair(_jax_client, JaxRespServer,
                          str(tmp_path_factory.mktemp("jax-fd")))
    port_pair = _make_pair(_port_client, RespServer,
                           str(tmp_path_factory.mktemp("port-fd")))
    yield jax_pair[0], port_pair[0]
    _close_pair(*port_pair)
    _close_pair(*jax_pair)


def _landed(sock) -> int:
    info = wireutil.exchange(sock, [[b"INFO", b"frontdoor"]])[0].decode()
    return int(info.split("frontdoor_worker_index:")[1].split()[0])


def _tcp_on(servers, w):
    """A TCP connection the kernel landed on worker ``w``."""
    for _ in range(200):
        s = socket.create_connection(("127.0.0.1", servers[0].port))
        s.settimeout(30)
        if _landed(s) == w:
            return s
        s.close()
    raise AssertionError(f"no connection landed on worker {w}")


def _frames(sock, cmds):
    return _ref._ask(sock, cmds)


# The pair tests' command lists, from a connection landed on worker 0 (so
# the "other" worker is 1 on both pairs).  KEYS replies are compared as
# sets: concatenation order follows the landing worker.
PAIR_SESSIONS = {
    "forward": [
        [b"SET", _key(0, "fwd"), b"local"], [b"SET", _key(1, "fwd"), b"remote"],
        [b"GET", _key(0, "fwd")], [b"GET", _key(1, "fwd")],
    ],
    "split": [
        [b"MSET", _key(0, "sp0"), b"a", _key(1, "sp1"), b"b", _key(0, "sp2"), b"c"],
        [b"MGET", _key(0, "sp0"), _key(1, "sp1"), _key(0, "sp2"), b"{missing}nope"],
        [b"EXISTS", _key(0, "sp0"), _key(1, "sp1"), _key(0, "sp2")],
        [b"DEL", _key(0, "sp0"), _key(1, "sp1")],
        [b"MGET", _key(0, "sp0"), _key(1, "sp1"), _key(0, "sp2")],
        [b"DEL", _key(0, "sp2")],
    ],
    "fanout": [
        [b"FLUSHALL"], [b"SET", _key(0, "fan0"), b"x"], [b"SET", _key(1, "fan1"), b"y"],
        [b"DBSIZE"], [b"FLUSHALL"], [b"DBSIZE"],
    ],
    "crossslot": [
        [b"SET", _key(0, "ren"), b"v"], [b"RENAME", _key(0, "ren"), _key(1, "ren")],
        [b"RENAME", _key(0, "ren"), _key(0, "ren2")], [b"DEL", _key(0, "ren2")],
    ],
    "multi": [
        [b"MULTI"], [b"SET", _key(1, "tx"), b"txv"], [b"GET", _key(1, "tx")],
        [b"EXEC"], [b"DEL", _key(1, "tx")],
    ],
    "publish": [[b"PUBLISH", b"mc-none", b"x"]],
    "sketches": [
        [b"BF.RESERVE", _key(1, "bf"), b"0.01", b"1000"],
        [b"BF.MADD", _key(1, "bf"), b"a", b"b", b"c"],
        [b"BF.MEXISTS", _key(1, "bf"), b"a", b"zz"],
        [b"CMS.INITBYDIM", _key(1, "cms"), b"256", b"4"],
        [b"CMS.INCRBY", _key(1, "cms"), b"a", b"3"],
        [b"CMS.QUERY", _key(1, "cms"), b"a", b"b"],
        [b"DEL", _key(1, "bf"), _key(1, "cms")],
    ],
}


@pytest.mark.parametrize("session", sorted(PAIR_SESSIONS))
def test_pair_replies_equal_the_jax_pair(pairs, session):
    cmds = PAIR_SESSIONS[session]
    got = []
    for servers in pairs:
        s = _tcp_on(servers, 0)
        try:
            got.append(_frames(s, cmds))
        finally:
            s.close()
    assert got[1] == got[0]


def test_pair_keys_and_chaos_equal_the_jax_pair(pairs):
    """KEYS (as a set) across both workers, and the HANDOFFBROKEN frame of
    an injected leg fault, equal on both pairs."""
    got = []
    for servers, ch in zip(pairs, (jax_chaos, chaos)):
        s = _tcp_on(servers, 0)
        try:
            _frames(s, [[b"FLUSHALL"], [b"SET", _key(0, "k0"), b"x"],
                        [b"SET", _key(1, "k1"), b"y"]])
            keys = sorted(wireutil.exchange(s, [[b"KEYS", b"*"]])[0])
            ch.inject("handoff.leg", kind="error", rate=1.0, seed=3)
            try:
                broken = _frames(s, [[b"GET", _key(1, "k1")]])
            finally:
                ch.clear()
            after = _frames(s, [[b"GET", _key(1, "k1")], [b"FLUSHALL"]])
            got.append((keys, broken, after))
        finally:
            s.close()
    assert got[1] == got[0]
    assert got[1][1][0].startswith(b"-HANDOFFBROKEN in-node forward leg to worker 1")


# -- fusion never carries a sibling's key ----------------------------------------


@pytest.fixture(params=["reactor", "thread"])
def port_pair(request, tmp_path):
    servers, clients = _make_pair(_port_client, RespServer, str(tmp_path),
                                  reactor=request.param == "reactor")
    yield servers, clients
    _close_pair(servers, clients)


def test_fused_runs_never_carry_a_siblings_key(port_pair):
    """One pipelined window of a sibling's Bloom run, GETs mixing both
    workers' keys and a local Bloom run: every reply right, each filter
    only in its owner's engine, and the sibling's items only there."""
    servers, clients = port_pair
    s = _tcp_on(servers, 0)
    try:
        mine, theirs = _key(0, "bf"), _key(1, "bf")
        assert _frames(s, [
            [b"BF.RESERVE", mine, b"0.01", b"1000"],
            [b"BF.RESERVE", theirs, b"0.01", b"1000"],
            [b"SET", _key(0, "s"), b"m"], [b"SET", _key(1, "s"), b"t"],
        ]) == [b"+OK\r\n"] * 4
        window = (
            [[b"BF.ADD", theirs, b"t%d" % i] for i in range(4)]
            + [[b"GET", _key(0, "s")], [b"GET", _key(1, "s")],
               [b"GET", _key(0, "s")], [b"MGET", _key(1, "s"), _key(1, "s")]]
            + [[b"BF.ADD", mine, b"m%d" % i] for i in range(4)]
            + [[b"BF.EXISTS", theirs, b"t0"], [b"BF.EXISTS", theirs, b"m0"],
               [b"BF.EXISTS", mine, b"m0"], [b"BF.EXISTS", mine, b"t0"]]
        )
        assert _frames(s, window) == (
            [b":1\r\n"] * 4
            + [b"$1\r\nm\r\n", b"$1\r\nt\r\n", b"$1\r\nm\r\n",
               b"*2\r\n$1\r\nt\r\n$1\r\nt\r\n"]
            + [b":1\r\n"] * 4
            + [b":1\r\n", b":0\r\n", b":1\r\n", b":0\r\n"]
        )
        local, sib = clients
        assert local._engine.registry.lookup(theirs.decode()) is None
        assert sib._engine.registry.lookup(mine.decode()) is None
        t_items = [b"t%d" % i for i in range(4)]
        assert sib.get_bloom_filter(theirs.decode()).contains_each(t_items).all()
        assert not local.get_bloom_filter(mine.decode()).contains_each(t_items).any()
    finally:
        s.close()


# -- scripting across the workers --------------------------------------------------


def test_script_registries_reach_every_worker(port_pair):
    """SCRIPT LOAD and FUNCTION LOAD land on both workers, so an EVALSHA or
    FCALL handed to its keys' owner finds them; a script's redis.call of
    a sibling's key is refused, not handed off under the grid lock."""
    servers, _clients = port_pair
    s = _tcp_on(servers, 0)
    try:
        sha = wireutil.exchange(s, [[b"SCRIPT", b"LOAD", b"redis.call('GET', KEYS[0])"]])[0]
        lib = (b"#!python name=g\ndef g(keys, args):\n"
               b"    return redis.call('GET', keys[0])\nregister_function('g', g)\n")
        assert _frames(s, [
            [b"SET", _key(1, "x"), b"v1"], [b"FUNCTION", b"LOAD", lib],
            [b"EVALSHA", sha, b"1", _key(1, "x")], [b"FCALL", b"g", b"1", _key(1, "x")],
            [b"EVAL", b"redis.call('GET', ARGV[0])", b"0", _key(1, "x")],
            [b"SCRIPT", b"FLUSH"], [b"EVALSHA", sha, b"1", _key(1, "x")],
            [b"FUNCTION", b"FLUSH"], [b"FCALL", b"g", b"1", _key(1, "x")],
        ]) == [
            b"+OK\r\n", b"$1\r\ng\r\n", b"$2\r\nv1\r\n", b"$2\r\nv1\r\n",
            b"-CROSSSLOT Keys in request don't hash to the same front-door "
            b"worker (use hash tags to co-locate them)\r\n",
            b"+OK\r\n", b"-NOSCRIPT No matching script. Please use EVAL.\r\n",
            b"+OK\r\n",
            b"-ERR Function not found (\"Function not found: 'g'\")\r\n",
        ]
    finally:
        s.close()


# -- the entry point: a forked K=2 node --------------------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _workers_on(port: int) -> list:
    """Pids of live front-door worker processes serving ``port``."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        if b"--frontdoor-index" in argv and str(port).encode() in argv:
            out.append(int(pid))
    return out


def _env():
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_entry_point_k2_node_on_the_cpu():
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "redisson_tpu_torch", "--frontdoor-processes",
         "2", "--device", "cpu", "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=_env(),
    )
    try:
        deadline = time.monotonic() + 50
        s = None
        while s is None:
            assert proc.poll() is None, proc.stdout.read().decode()
            assert time.monotonic() < deadline, "node never served"
            try:
                s = socket.create_connection(("127.0.0.1", port), timeout=30)
                wireutil.exchange(s, [[b"PING"]])
            except OSError:
                s = None
                time.sleep(0.1)
        me = _landed(s)
        other = 1 - me
        assert len(_workers_on(port)) == 2
        assert wireutil.exchange(s, [
            [b"PING"], [b"SET", _key(other, "a"), b"va"],
            [b"SET", _key(me, "b"), b"vb"], [b"GET", _key(other, "a")],
            [b"MGET", _key(other, "a"), _key(me, "b")],
        ]) == [b"PONG", b"OK", b"OK", b"va", [b"va", b"vb"]]
        info = wireutil.exchange(s, [[b"INFO", b"frontdoor"]])[0].decode()
        assert "frontdoor_processes:2" in info
        assert "frontdoor_handoffs_forward:2" in info
        assert "frontdoor_handoffs_split:1" in info
        s.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    deadline = time.monotonic() + 10
    while _workers_on(port):
        assert time.monotonic() < deadline, "a front-door worker outlived the node"
        time.sleep(0.05)


def test_cuda_worker_without_a_card_fails_the_node():
    """``device="cuda"`` where torch sees no card: each worker exits with
    code 2 and startup raises with the worker's log named — no worker
    quietly serves from the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the worker would start on it")
    rundir = tempfile.mkdtemp(prefix="rtpu-fd-test-")
    try:
        with pytest.raises(RuntimeError, match=r"exited rc=2 during startup; see .*worker0\.log"):
            MulticoreNode(2, device="cuda", rundir=rundir, env_extra=_env())
        with open(os.path.join(rundir, "worker0.log")) as f:
            assert "no CUDA device" in f.read()
    finally:
        import shutil

        shutil.rmtree(rundir, ignore_errors=True)


def test_frontdoor_processes_one_is_the_single_door():
    """K=1 (the default) never spawns workers: the entry point serves
    in-process, and its gauges read one process at index 0."""
    client = _port_client(0)
    server = RespServer(client)
    try:
        assert server.multicore is None
        assert client.obs.frontdoor_processes.get() == 1.0
        s = socket.create_connection((server.host, server.port))
        info = wireutil.exchange(s, [[b"INFO", b"frontdoor"]])[0].decode()
        s.close()
        assert "frontdoor_processes:1" in info
        assert "frontdoor_worker_index:0" in info
        assert "frontdoor_handoffs_forward" not in info
    finally:
        server.close()
        client.shutdown()


def test_pair_gauges_read_k(pairs):
    _jax, port = pairs
    for i, srv in enumerate(port):
        assert srv.obs.frontdoor_processes.get() == float(NW)
        assert srv.obs.frontdoor_worker_index.get() == float(i)

