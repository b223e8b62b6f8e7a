"""``python -m redisson_tpu_torch`` — the standalone-server deployment shape
of the port (the counterpart of ``tests/test_server_cli.py``).

Boots a real subprocess with ``--device cpu``, drives it over TCP,
restarts it on the same snapshot directory and requires every acked
write back (the server drains its connections before the final snapshot,
sketches and ``grid_store.bin`` alike).  A snapshot directory written by
a JAX client boots in the port's server with every read equal to the JAX
server's.  Without ``--device cpu`` the server refuses to start where
there is no card; and neither the server's modules nor the scripts
import jax or the JAX package.
"""

import os
import re
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import redisson_tpu  # noqa: E402
from redisson_tpu.serve.resp import RespServer as JaxRespServer  # noqa: E402
from redisson_tpu_torch.serve.wireutil import exchange  # noqa: E402

REPO = Path(__file__).parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(port, snap_dir, *extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "redisson_tpu_torch", "--port", str(port),
         "--snapshot-dir", str(snap_dir), *extra],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
    )


def _connect(port, proc, deadline_s=90.0):
    t0 = time.monotonic()
    while True:
        try:
            return socket.create_connection(("127.0.0.1", port), timeout=60)
        except OSError:
            if proc.poll() is not None:
                raise AssertionError(proc.communicate()[0][-2000:])
            if time.monotonic() - t0 > deadline_s:
                raise
            time.sleep(0.2)


def _stop(proc):
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=120)
    return proc.returncode, out


def _cmds(*cmds):
    return [[a if isinstance(a, bytes) else str(a).encode() for a in c] for c in cmds]


def test_standalone_server_round_trip(tmp_path):
    port = _free_port()
    proc = _spawn(port, tmp_path / "snap", "--device", "cpu")
    try:
        s = _connect(port, proc)
        assert exchange(s, _cmds(
            ["PING"], ["SET", "cli-k", "v"], ["INCR", "cli-n"],
            ["BF.RESERVE", "cli-bf", "0.01", "1000"], ["BF.ADD", "cli-bf", "alpha"],
            ["BF.EXISTS", "cli-bf", "alpha"], ["PFADD", "cli-h", "a", "b"],
            ["SETBIT", "cli-bs", "9", "1"],
            ["CMS.INITBYDIM", "cli-cms", "256", "4"], ["CMS.INCRBY", "cli-cms", "x", "3"],
            ["TOPK.RESERVE", "cli-tk", "2"], ["TOPK.ADD", "cli-tk", "a", "a", "b"],
        )) == [b"PONG", b"OK", 1, b"OK", 1, 1, 1, 0, b"OK", [3], b"OK",
               [None, None, None]]
        info = exchange(s, [[b"INFO", b"server"]])[0]
        assert b"rtpu_device:cpu" in info
        s.close()
        # Graceful shutdown drains connections, then snapshots.
        rc, out = _stop(proc)
        assert rc == 0, out[-2000:]
        assert sorted(os.listdir(tmp_path / "snap")) == [
            "grid_store.bin", "sketch_meta.json", "sketch_pools.npz"]
        port2 = _free_port()
        proc2 = _spawn(port2, tmp_path / "snap", "--device", "cpu")
        try:
            s2 = _connect(port2, proc2)
            assert exchange(s2, _cmds(
                ["BF.EXISTS", "cli-bf", "alpha"], ["BF.EXISTS", "cli-bf", "nope"],
                ["GET", "cli-k"], ["GET", "cli-n"], ["PFCOUNT", "cli-h"],
                ["GETBIT", "cli-bs", "9"], ["CMS.QUERY", "cli-cms", "x"],
                ["TOPK.LIST", "cli-tk"],
            )) == [1, 0, b"v", b"1", 2, 1, [3], [b"a", b"b"]]
            s2.close()
        finally:
            rc2, _ = _stop(proc2)
            assert rc2 == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)


_JAX_READS = _cmds(
    ["GET", "j-str"], ["GET", "j-cnt"], ["BF.EXISTS", "j-bf", "in"],
    ["BF.MEXISTS", "j-bf", "in", "out", "in2"], ["PFCOUNT", "j-h"],
    ["GETBIT", "j-bs", "1000"], ["GETBIT", "j-bs", "7"], ["BITCOUNT", "j-bs"],
    ["CMS.QUERY", "j-cms", "a", "b", "zz"], ["TOPK.LIST", "j-tk", "WITHCOUNT"],
    ["TYPE", "j-lst"], ["DBSIZE"], ["EXISTS", "j-map", "j-str", "j-bf"],
)


def test_jax_snapshot_dir_boots_in_the_port_server(tmp_path):
    """A JAX client's snapshot directory (sketch pools, registry and
    grid_store.bin with strings and lists/maps) boots in the port's
    server; every read equals the JAX server's on the same directory."""
    sdir = tmp_path / "jsnap"
    cfg = redisson_tpu.Config().use_tpu_sketch(min_bucket=64)
    cfg.snapshot_dir = str(sdir)
    jc = redisson_tpu.create(cfg)
    js = JaxRespServer(jc)
    try:
        s = socket.create_connection((js.host, js.port))
        exchange(s, _cmds(
            ["SET", "j-str", "hello"], ["INCRBY", "j-cnt", "7"],
            ["BF.RESERVE", "j-bf", "0.01", "2000"], ["BF.MADD", "j-bf", "in", "in2"],
            ["PFADD", "j-h", "a", "b", "c"], ["SETBIT", "j-bs", "1000", "1"],
            ["CMS.INITBYDIM", "j-cms", "512", "4"], ["CMS.INCRBY", "j-cms", "a", "4", "b", "1"],
            ["TOPK.RESERVE", "j-tk", "2"], ["TOPK.ADD", "j-tk", "x", "y", "x"],
            ["RPUSH", "j-lst", "1", "2"], ["HSET", "j-map", "f", "v"],
        ))
        want = exchange(s, _JAX_READS)
        s.close()
    finally:
        js.close()
        jc.shutdown()  # the final snapshot
    assert {"grid_store.bin", "sketch_meta.json", "sketch_pools.npz"} <= set(os.listdir(sdir))
    port = _free_port()
    proc = _spawn(port, sdir, "--device", "cpu")
    try:
        s = _connect(port, proc)
        got = exchange(s, _JAX_READS)
        s.close()
    finally:
        rc, out = _stop(proc)
    assert rc == 0, out[-2000:]
    assert [repr(x) for x in got] == [repr(x) for x in want]
    assert want[0] == b"hello" and want[2] == 1 and want[10] == b"list"


def test_refuses_to_start_without_a_card():
    """Without ``--device cpu`` the server needs a card: here (no CUDA)
    it exits non-zero, and says why, before binding anything."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "redisson_tpu_torch", "--port", str(_free_port())],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


# Each tier of the import test runs in a subprocess of its own, with jax
# and the JAX package blocked, so a failure names its tier.
_BLOCK = (
    "import sys\n"
    "sys.modules['jax'] = None\n"
    "sys.modules['redisson_tpu'] = None\n"
    "import redisson_tpu_torch as rt\n"
)

_TIERS = {
    "imports": (
        "import chip_smoke, profile_port, compare_rates\n"
        "from redisson_tpu_torch import __main__ as m\n"
        "from redisson_tpu_torch.serve import reactor, native_codec\n"
        "from redisson_tpu_torch.serve.resp import RespServer\n"
        "from redisson_tpu_torch.serve.wireutil import exchange\n"
        "from redisson_tpu_torch.serve import TopicCmsBridge\n"
        "from redisson_tpu_torch.grid import (topics, maps, multimaps, collections,"
        " queues, streams, geo, timeseries, locks, services, cron, jcache,"
        " local_cached_map)\n"
        "from redisson_tpu_torch import integrations, reactive\n"
        "from redisson_tpu_torch.serve import nodes, metrics\n"
        "from redisson_tpu_torch.obs import promhttp\n"
        "from redisson_tpu_torch.obs import spans, slowlog, latency, trace, events, loadmap\n"
        "from redisson_tpu_torch.durability import journal, recovery, replication, replica\n"
        "from redisson_tpu_torch.chaos import crashchild\n"
        "from redisson_tpu_torch.serve import multicore\n"
        "from redisson_tpu_torch.obs import federate, doctor\n"
        "from redisson_tpu_torch.cluster import (slotmap, slotindex, door, client,"
        " supervisor, failover, rebalancer)\n"
        "from redisson_tpu_torch.analysis import witness, explorer, netsim\n"
        "from redisson_tpu_torch.analysis import rtpulint, lockgraph\n"
        "from redisson_tpu_torch.analysis import __main__ as analysis_cli\n"
        "from redisson_tpu_torch.parallel import mesh\n"
        "from redisson_tpu_torch.executor import sharded_executor\n"
    ),
    # The sharded executor and the mesh: an 8-shard client, a replicated
    # filter, a live reshard to 4 and a snapshot restored onto 1 shard.
    "sharded": (
        "import tempfile\n"
        "import numpy as np\n"
        "c = rt.create(rt.Config().use_gpu_sketch(device='cpu', num_shards=8))\n"
        "assert type(c._engine.executor).__name__ == 'ShardedTorchCommandExecutor'\n"
        "bf = c.get_bloom_filter('f'); bf.try_init(1000, 0.01)\n"
        "bf.add_all(np.arange(100, dtype=np.uint64)); assert bf.set_replicated()\n"
        "assert c.change_topology(4) and len(c.get_nodes_group().get_nodes()) == 4\n"
        "d = tempfile.mkdtemp(); c._engine.snapshot(d); c.shutdown()\n"
        "c2 = rt.create(rt.Config().use_gpu_sketch(device='cpu'))\n"
        "assert c2._engine.restore_snapshot(d)\n"
        "assert c2.get_bloom_filter('f').contains_all(np.arange(100, dtype=np.uint64)) == 100\n"
        "c2.shutdown()\n"
    ),
    "analysis": (
        # Naming a lock loads the witness alone, never the analyser.
        "from redisson_tpu_torch.serve.resp import RespServer\n"
        "from redisson_tpu_torch.cluster import door, rebalancer\n"
        "loaded = [m for m in ('rtpulint', 'lockgraph', 'explorer')\n"
        "          if 'redisson_tpu_torch.analysis.' + m in sys.modules]\n"
        "assert not loaded, loaded\n"
        "from redisson_tpu_torch.analysis import __main__ as cli\n"
        "assert cli.main(['--rule', 'RT010', '--rule', 'RT001',"
        " 'redisson_tpu_torch/cluster']) == 0\n"
    ),
    "journal": (
        "import tempfile\n"
        "d = tempfile.mkdtemp()\n"
        "def jc():\n"
        "    cfg = rt.Config().use_gpu_sketch(device='cpu')\n"
        "    cfg.journal_dir = d; cfg.journal_fsync = 'always'\n"
        "    return rt.create(cfg)\n"
        "c1 = jc(); h = c1.get_hyper_log_log('h'); h.add_all(['a', 'b', 'c'])\n"
        "c1._engine.journal.close(); c1._engine.journal = None; c1.shutdown()\n"
        "c2 = jc(); assert c2.get_hyper_log_log('h').count() == 3; c2.shutdown()\n"
    ),
    # Every keyed command is sampled into the loadmap (rate 1), so
    # HOTKEYS has a fixed answer: ``a`` (SET, INCR, GET) the hottest.
    "server": (
        "import socket, asyncio\n"
        "import numpy as np\n"
        "from redisson_tpu_torch.serve.resp import RespServer\n"
        "from redisson_tpu_torch.serve.wireutil import exchange\n"
        "from redisson_tpu_torch.serve import TopicCmsBridge\n"
        "cfg = rt.Config().use_gpu_sketch(device='cpu')\n"
        "cfg.loadmap_key_sample_rate = 1.0\n"
        "c = rt.create(cfg)\n"
        "srv = RespServer(c)\n"
        "s = socket.create_connection((srv.host, srv.port))\n"
        "r = exchange(s, [[b'SET', b'a', b'1'], [b'INCR', b'a'], [b'BF.RESERVE', b'f', b'0.01', b'10'],"
        " [b'BF.ADD', b'f', b'x'], [b'GET', b'a'], [b'RPUSH', b'l', b'x'], [b'XADD', b's', b'1-1',"
        " b'f', b'v'], [b'GEOADD', b'g', b'1', b'2', b'm'], [b'PUBLISH', b'ch', b'm']])\n"
        "assert r == [b'OK', 2, b'OK', 1, b'2', 1, b'1-1', 1, 0], r\n"
        "cms = c.get_count_min_sketch('cms'); cms.try_init(4, 1024)\n"
        "b = TopicCmsBridge(c, 't', 'cms'); c.get_topic('t').publish(np.arange(9, dtype=np.uint64))\n"
        "b.close(); assert b.events_ingested == 9 and cms.total_count() == 9\n"
        "lk = c.get_lock('lk'); lk.lock(); lk.unlock()\n"
        "ex = c.get_executor_service('ex'); ex.register_workers(1)\n"
        "assert ex.submit(cms.total_count).result(30) == 9; ex.shutdown()\n"
        "assert c.get_nodes_group().ping_all() and c.get_metrics()['ops_total'] > 0\n"
        "assert asyncio.run(c.reactive().get_bucket('rx').get()) is None\n"
        "r = exchange(s, [[b'CONFIG', b'SET', b'slowlog-log-slower-than', b'0'],"
        " [b'TRACE', b'SAMPLE', b'1'], [b'PING'], [b'SLOWLOG', b'LEN'], [b'TRACE', b'LEN'],"
        " [b'TRACE', b'SAMPLE', b'0'], [b'HOTKEYS'], [b'EVENTS', b'LEN']])\n"
        "assert r[3] >= 2 and r[4] >= 1 and r[7] >= 1, r\n"
        "assert r[6][0] == b'a' and {b'f', b'l', b'g'} <= set(r[6][::2]), r\n"
        "s.close(); srv.close(); c.shutdown()\n"
    ),
    "scripting": (
        "import socket\n"
        "from redisson_tpu_torch.serve.resp import RespServer\n"
        "from redisson_tpu_torch.serve.wireutil import exchange\n"
        "c = rt.create(rt.Config().use_gpu_sketch(device='cpu'))\n"
        "srv = RespServer(c, enable_python_scripts=True)\n"
        "s = socket.create_connection((srv.host, srv.port))\n"
        "r = exchange(s, [[b'BF.RESERVE', b'f', b'0.01', b'10'], [b'BF.ADD', b'f', b'x'],"
        " [b'EVAL', b\"redis.call('BF.MADD', KEYS[0], *ARGV)\", b'1', b'f', b'x', b'y']])\n"
        "assert r == [b'OK', 1, [0, 1]], r\n"
        "s.close(); srv.close(); c.shutdown()\n"
    ),
    # A cluster-mode node with its failover agent, an armed rebalancer
    # and an armed fleet doctor (neither thread-started: NOW drives
    # them), routed through connect_cluster.
    "cluster": (
        "import json\n"
        "from redisson_tpu_torch.serve.resp import RespServer\n"
        "from redisson_tpu_torch.cluster import failover, rebalancer\n"
        "from redisson_tpu_torch.obs import doctor\n"
        "cfg = rt.Config().use_gpu_sketch(device='cpu'); cfg.cluster_enabled = True\n"
        "cfg.cluster_slots = '0-16383'; c = rt.create(cfg); srv = RespServer(c)\n"
        "failover.FailoverAgent(srv, node_timeout_s=1.0).start()\n"
        "rebalancer.RebalanceAgent(srv); doctor.FleetDoctor(srv)\n"
        "cc = rt.connect_cluster([(srv.host, srv.port)])\n"
        "assert cc.execute_many([('SET', 'k%d' % i, 'v') for i in range(8)]) == [b'OK'] * 8\n"
        "assert cc.execute('CLUSTER', 'COUNTKEYSINSLOT', '0') == 0\n"
        "assert b'cluster_my_slots:16384' in cc.execute('CLUSTER', 'INFO')\n"
        "st = json.loads(cc.execute('CLUSTER', 'REBALANCE', 'STATUS'))\n"
        "assert st['enabled'] and st['is_coordinator'], st\n"
        "assert cc.execute('CLUSTER', 'REBALANCE', 'NOW') == 0\n"
        "assert cc.execute('CLUSTER', 'DOCTOR', 'NOW') == 0\n"
        "assert b'No active findings' in cc.execute('CLUSTER', 'DOCTOR')\n"
        "cc.close(); srv.close(); c.shutdown()\n"
    ),
}


def test_server_modules_import_neither_jax_nor_the_reference():
    """The front door, the reactor, the grid families, the coordination
    and services half (locks, services, cron, LocalCachedMap, JCache, the
    integrations, the reactive facade, nodes, metrics and the scrape
    endpoint), the ingest bridge, the durability tier (the journal,
    recovery, the replication hub and link, the crash child), the
    observability tier (spans, slowlog, latency, trace, events, loadmap —
    driven over the wire: SLOWLOG, TRACE, HOTKEYS, EVENTS), scripting
    (an EVAL through redis.call), the per-core front door and metrics
    federation, the cluster (slot map, slot index, door, routing client,
    supervisor, failover, the rebalancer and the fleet doctor — a
    cluster-mode node with its failover agent, an armed rebalancer and
    an armed doctor routed through connect_cluster), the analysis tools
    (the lock-order witness, the schedule explorer, netsim, the analyser,
    the lock graph and their CLI, which gates the cluster tier; a serving
    module that names its locks loads none of the analysers), the sharded
    executor and the mesh (an 8-shard client resharded live and restored
    onto one shard), the entry
    point and the scripts load with jax and redisson_tpu blocked and
    serve on the CPU — a journaled client recovers its tail; no module of
    the port, nor chip_smoke.py, profile_port.py or compare_rates.py, has
    an import of either.  Each tier runs in a subprocess of its own (all
    started together), and a failure names its tier."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = {
        tier: subprocess.Popen(
            [sys.executable, "-c", _BLOCK + code], cwd=str(REPO), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for tier, code in _TIERS.items()
    }
    failed = {}
    for tier, proc in procs.items():
        try:
            _out, err = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            _out, err = proc.communicate()
            failed[tier] = "timed out after 120 s\n" + err
            continue
        if proc.returncode != 0:
            failed[tier] = err
    assert not failed, "\n".join(
        f"--- tier {tier} ---\n{err}" for tier, err in failed.items()
    )
    pat = re.compile(r"^\s*(import|from)\s+(jax|redisson_tpu)(\.|\s|$)", re.M)
    files = list((REPO / "redisson_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "profile_port.py", REPO / "compare_rates.py"]
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders
