"""The port's replication stream against the JAX package's.

* The JAX package's ``tests/test_repl_stream.py`` classes run again on a
  port pair (``port_case`` rebinds their bodies, the ``ReplPair`` helper
  and the module helpers to the port, on the CPU): FULLRESYNC bootstrap,
  live streaming of sketch rows and the grid keyspace, partial resync
  after a link drop, the PSYNC ladder, the WAIT replica-ack fence, INFO
  replication and HELLO roles, -READONLY and -STALEREAD, and FAILOVER.
  Nothing is skipped (the link-fault soak keeps its ``chaos``/``slow``
  marks, as in the JAX package).
* Cross-package pairs over loopback in one process: a port replica of a
  JAX primary, and a JAX replica of a port primary, converge to
  byte-equal rows and grid values, and keep converging over the live
  stream.
"""

import inspect
import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
import test_repl_stream as _ref  # noqa: E402
from redisson_tpu.codecs import LongCodec as JaxLongCodec  # noqa: E402
from redisson_tpu.serve.resp import RespServer as JaxServer  # noqa: E402
from redisson_tpu_torch import chaos  # noqa: E402
from redisson_tpu_torch.codecs import LongCodec  # noqa: E402
from redisson_tpu_torch.serve.resp import RespServer as PortServer  # noqa: E402
from redisson_tpu_torch.serve.wireutil import exchange  # noqa: E402
from test_torch_grid_coordination import port_case  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the JAX package's replication tests on a port pair --------------------------

_make_cfg = port_case(_ref.make_cfg)
_HELPERS = dict(make_cfg=_make_cfg, engine_rows=port_case(_ref.engine_rows))
PortReplPair = type("ReplPair", (), {
    name: port_case(fn, **_HELPERS)
    for name, fn in vars(_ref.ReplPair).items() if inspect.isfunction(fn)
})
_HELPERS["seed_primary"] = port_case(_ref.seed_primary)


@pytest.fixture
def pair(tmp_path):
    chaos.clear()
    p = PortReplPair(tmp_path)
    yield p
    chaos.clear()
    p.close()


def _port_repl_class(ref):
    ns = {"__module__": __name__}
    for name, fn in vars(ref).items():
        if inspect.isfunction(fn):
            ns[name] = port_case(fn, **_HELPERS)
    return type(ref.__name__, (ref,), ns)


TestBootstrapAndStream = _port_repl_class(_ref.TestBootstrapAndStream)
TestResyncLadder = _port_repl_class(_ref.TestResyncLadder)
TestFencesAndInfo = _port_repl_class(_ref.TestFencesAndInfo)
TestPromotion = _port_repl_class(_ref.TestPromotion)
TestLinkFaultSoak = _port_repl_class(_ref.TestLinkFaultSoak)


def test_pair_runs_on_the_port(pair):
    assert type(pair.primary._engine).__module__.startswith("redisson_tpu_torch")
    assert isinstance(pair.pserver, PortServer)


# -- cross-package pairs -----------------------------------------------------------


def _cfg(pkg, d, journal):
    if pkg == "port":
        cfg = rt.Config().set_codec(LongCodec()).use_gpu_sketch(device="cpu", min_bucket=64)
    else:
        cfg = redisson_tpu.Config().set_codec(JaxLongCodec()).use_tpu_sketch(min_bucket=64)
    cfg.snapshot_dir = str(d / "snap")
    if journal:
        cfg.journal_dir = str(d / "journal")
        cfg.journal_fsync = "no"
    return cfg


def _node(pkg, d, journal):
    client = (rt if pkg == "port" else redisson_tpu).create(_cfg(pkg, d, journal))
    server = (PortServer if pkg == "port" else JaxServer)(client, host="127.0.0.1", port=0)
    return client, server


def _rows(client) -> dict:
    eng = client._engine
    eng._drain()
    return {
        e.name: np.asarray(eng.executor.read_row(e.pool, e.row)).tobytes()
        for e in eng.registry.entries()
    }


def _cmds(server, cmds):
    s = socket.create_connection((server.host, server.port), timeout=10)
    try:
        return exchange(s, cmds)
    finally:
        s.close()


def _caught_up(primary, link, timeout_s=30.0):
    head = primary._engine.journal.last_seq()
    deadline = time.monotonic() + timeout_s
    while link.applied < head:
        assert time.monotonic() < deadline, (link.applied, head)
        time.sleep(0.02)


def _load(server, lo, hi):
    cmds = [("BF.MADD", "bf", *[str(i) for i in range(j, min(j + 50, hi))])
            for j in range(lo, hi, 50)]
    cmds += [("PFADD", "hll", *[str(i) for i in range(lo, hi, 3)]),
             ("SETBIT", "bits", str(lo % 4096 + 7), "1"),
             ("CMS.INCRBY", "cms", str(lo), "3", str(hi), "2"),
             ("HSET", "h", f"f{lo}", str(hi)),
             ("SET", f"k{lo}", str(hi))]
    _cmds(server, cmds)


@pytest.mark.parametrize("primary_pkg,replica_pkg", [("jax", "port"), ("port", "jax")])
def test_cross_package_replica_converges_byte_equal(tmp_path, primary_pkg, replica_pkg):
    pc, ps = _node(primary_pkg, tmp_path / "p", journal=True)
    rc = rs = None
    try:
        _cmds(ps, [("BF.RESERVE", "bf", "0.01", "20000"),
                   ("CMS.INITBYDIM", "cms", "512", "4")])
        _load(ps, 0, 600)
        rc, rs = _node(replica_pkg, tmp_path / "r", journal=False)
        link = rs.start_replication_from(ps.host, ps.port)
        _caught_up(pc, link)
        assert link.full_resyncs == 1
        _load(ps, 600, 1500)  # the live stream after the bootstrap cut
        assert _cmds(ps, [("WAIT", "1", "10000")]) == [1]
        _caught_up(pc, link)
        assert _rows(rc) == _rows(pc)
        for cmd in (("HGETALL", "h"), ("GET", "k600"), ("PFCOUNT", "hll"),
                    ("CMS.QUERY", "cms", "0", "600", "1500"), ("GETBIT", "bits", "7")):
            assert _cmds(rs, [cmd]) == _cmds(ps, [cmd]), cmd
    finally:
        if rs is not None:
            rs.close()
        ps.close()
        for c in (rc, pc):
            if c is not None:
                c.config.snapshot_dir = None
                c._engine.config.snapshot_dir = None
                c.shutdown()
