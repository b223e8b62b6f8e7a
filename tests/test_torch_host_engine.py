"""The port's host sketch engine (``Config().use_host_sketch()``) against
the JAX package.

The JAX package runs sketches on its ``HostSketchEngine`` (the golden
NumPy models) when ``use_tpu_sketch()`` is not called.  The port carries
the same engine and spells the choice ``use_host_sketch()``: a bare
``Config()`` still raises, and so does choosing both backends.

The reference's own tests run here on the port (``ref_case``): their
module globals and in-body imports are rebound to the port, where a bare
``Config()`` is the host engine and ``use_tpu_sketch(**kw)`` the card
engine on the CPU, exactly the JAX package's switch.

* ``tests/test_objects_e2e.py``: every test, its ``client`` fixture over
  ``["tpu", "host"]``.  None is left out.
* ``tests/test_fastpath.py``: the two client-level tests, which compare
  the fast and device-hash paths with the host engine (its kernel tests
  have port twins in ``tests/test_torch_hashed_bloom.py``).
* The host-engine cases of ``test_mailbox.py``, ``test_scan_chunking.py``
  (with the port's ``_SCAN_CHUNK`` patched small), ``test_nearcache.py``
  and ``test_grid_snapshot.py``.
* ``tests/test_review_regressions.py``: its ``client``-fixture tests on
  both engines and its four cases that compare the modes or the host
  engine's RESTORE checks.  Left out, with the reason:
  ``test_fast_add_drains_pending_coalesced_reads`` and
  ``test_concurrent_bitset_grow_no_double_free`` build only a card
  client (no host engine in them; ``tests/test_torch_grid_coordination.py``
  and ``tests/test_torch_bitset.py`` hold the card paths), and
  ``TestRound3AdviceFixes`` is rebound in
  ``tests/test_torch_grid_coordination.py``.

Added for the port: the choice of backend and its ``to_dict`` round
trip; the RESP wire table of ``tests/test_torch_resp_wire.py`` byte-equal
on a JAX and a port server over their host engines; DUMP bytes equal to
the JAX host engine's per kind; a dump of either port engine restored
into the other, answering alike.
"""

import builtins
import importlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
import test_fastpath as _ref_fast  # noqa: E402
import test_grid_snapshot as _ref_gsnap  # noqa: E402
import test_mailbox as _ref_mail  # noqa: E402
import test_nearcache as _ref_nc  # noqa: E402
import test_objects_e2e as _ref_e2e  # noqa: E402
import test_review_regressions as _ref_rev  # noqa: E402
import test_scan_chunking as _ref_scan  # noqa: E402
import test_torch_grid_coordination as _tgc  # noqa: E402
import test_torch_resp_wire as _wire  # noqa: E402
from redisson_tpu.serve.resp import RespServer as JaxRespServer  # noqa: E402
from redisson_tpu_torch.executor import torch_executor  # noqa: E402
from redisson_tpu_torch.objects.engines import HostSketchEngine  # noqa: E402
from redisson_tpu_torch.serve.resp import RespServer  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the reference's tests on the port, with the JAX package's switch ----------------


class RefConfig(rt.Config):
    """The port's Config as a reference body builds the JAX one: bare, the
    host engine is what ``create`` gives; ``use_tpu_sketch(**kw)`` is the
    card engine on the CPU."""

    def use_tpu_sketch(self, **kwargs):
        return self.use_gpu_sketch(device="cpu", **kwargs)


def ref_create(config=None):
    config = config if config is not None else RefConfig()
    if not (config.gpu_sketch.enabled or config.host_sketch):
        config.use_host_sketch()
    return rt.create(config)


class _RefPackage(types.ModuleType):
    def __init__(self):
        super().__init__("redisson_tpu_torch")
        self.create = ref_create
        self.Config = RefConfig

    def __getattr__(self, item):
        return getattr(rt, item)


class _RefConfigModule(types.ModuleType):
    def __init__(self):
        super().__init__("redisson_tpu_torch.config")
        self.Config = RefConfig

    def __getattr__(self, item):
        return getattr(importlib.import_module("redisson_tpu_torch.config"), item)


_PKG = _RefPackage()
_CONFIG = _RefConfigModule()


def _import(name, globals=None, locals=None, fromlist=(), level=0):
    if level == 0 and name == "redisson_tpu.config" and fromlist:
        return _CONFIG
    if level == 0 and _tgc._is_ref(name):
        mod = _tgc._port_import(name, globals, locals, fromlist, level)
        return _PKG if (name == "redisson_tpu" or not fromlist) else mod
    return builtins.__import__(name, globals, locals, fromlist, level)


_BUILTINS = dict(vars(builtins), __import__=_import)


def _value(v):
    if v is redisson_tpu:
        return _PKG
    if v is redisson_tpu.Config:
        return RefConfig
    if isinstance(v, types.ModuleType) and v.__name__ == "redisson_tpu.config":
        return _CONFIG
    return _tgc._port_value(v)


def ref_case(fn, **overrides):
    """``fn`` with its module globals and in-body imports of the JAX
    package bound to the port, bare ``Config()`` meaning the host
    engine."""
    g = {k: _value(v) for k, v in fn.__globals__.items()}
    g["__builtins__"] = _BUILTINS
    g.update(overrides)
    new = types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__, fn.__closure__)
    new.__kwdefaults__ = fn.__kwdefaults__
    new.__doc__ = fn.__doc__
    return new


@pytest.fixture(params=["tpu", "host"])
def client(request):
    """The reference's two-engine fixture on the port."""
    cfg = RefConfig()
    if request.param == "tpu":
        cfg.use_tpu_sketch(min_bucket=64)
    c = ref_create(cfg)
    yield c
    c.shutdown()


def _rebind(module, names):
    return {n: ref_case(getattr(module, n)) for n in names}


# tests/test_objects_e2e.py, every test.
_E2E = [n for n in vars(_ref_e2e) if n.startswith("test_")]
globals().update(_rebind(_ref_e2e, _E2E))

# tests/test_fastpath.py, the client-level tests (the kernel tests have
# port twins in test_torch_hashed_bloom.py).
globals().update(_rebind(_ref_fast, ["test_fast_mode_e2e_parity_with_host",
                                     "test_device_hash_path_matches_host_engine"]))

# The named host-engine cases of four more reference files.
test_contains_many_host_engine = ref_case(_ref_mail.test_contains_many_host_engine)
test_host_engine_shutdown_persists_grid = ref_case(
    _ref_gsnap.test_host_engine_shutdown_persists_grid)


class TestNearcacheRespSurface:
    test_host_engine_has_no_nearcache_keys = ref_case(
        _ref_nc.TestRespSurface.test_host_engine_has_no_nearcache_keys)


@pytest.fixture
def small_chunks(monkeypatch):
    """The port's pass size, patched small (the reference patches the
    JAX executor's)."""
    monkeypatch.setattr(torch_executor, "_SCAN_CHUNK", 1 << 12)


class TestScanChunkedBloom:
    @pytest.fixture
    def client(self):
        c = ref_create(RefConfig().use_tpu_sketch(
            min_bucket=64, exact_add_semantics=False, coalesce=False))
        yield c
        c.shutdown()

    test_contains_matches_host_engine_across_chunks = ref_case(
        _ref_scan.TestScanChunkedBloom.test_contains_matches_host_engine_across_chunks)


# tests/test_review_regressions.py: the client-fixture tests and the mode
# comparisons (see the module docstring for the three left out).
_REV = [n for n, f in vars(_ref_rev).items()
        if n.startswith("test_") and isinstance(f, types.FunctionType)
        and n not in ("test_fast_add_drains_pending_coalesced_reads",
                      "test_concurrent_bitset_grow_no_double_free")]
assert not set(_REV) & set(_E2E)
globals().update(_rebind(_ref_rev, _REV))


def test_every_rebound_body_builds_port_clients():
    """The rebinding really yields port clients on both sides of the
    switch."""
    h, t = ref_create(RefConfig()), ref_create(RefConfig().use_tpu_sketch(min_bucket=64))
    try:
        assert isinstance(h._engine, HostSketchEngine)
        assert type(t._engine).__name__ == "TorchSketchEngine"
    finally:
        h.shutdown()
        t.shutdown()


# -- choosing the backend ------------------------------------------------------------


def test_bare_config_raises_naming_both_choices():
    with pytest.raises(ValueError) as e:
        rt.create(rt.Config())
    assert "use_gpu_sketch()" in str(e.value) and "use_host_sketch()" in str(e.value)


def test_choosing_both_raises():
    with pytest.raises(ValueError, match="both"):
        rt.create(rt.Config().use_host_sketch().use_gpu_sketch(device="cpu"))


def test_use_host_sketch_gives_the_host_engine():
    c = rt.create(rt.Config().use_host_sketch())
    try:
        assert isinstance(c._engine, HostSketchEngine)
        assert c.prewarm_wait(0.1) is True
        assert c.get_nodes_group().get_nodes()[0].address == "cpu:0"
        assert "ops" in c.get_metrics()
        with pytest.raises(RuntimeError, match="card sketch engine"):
            c.change_topology(2)
    finally:
        c.shutdown()


def test_a_card_failure_never_selects_the_host_engine(monkeypatch):
    """Without a card the card engine refuses to start; nothing falls back
    to the host engine (building one here would raise the sentinel)."""
    import redisson_tpu_torch.client as client_mod

    class Sentinel(Exception):
        pass

    def refuse(*_a, **_k):
        raise Sentinel("the host engine was selected")

    monkeypatch.setattr(client_mod, "HostSketchEngine", refuse)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Exception) as e:
        rt.create(rt.Config().use_gpu_sketch(device="cuda"))
    assert not isinstance(e.value, Sentinel)


@pytest.mark.parametrize("host", [True, False])
def test_config_round_trip_keeps_the_choice(host):
    cfg = rt.Config().use_host_sketch() if host else rt.Config().use_gpu_sketch(
        device="cpu", min_bucket=128)
    d = cfg.to_dict()
    back = rt.Config.from_dict(d)
    assert back.host_sketch is host and back.gpu_sketch.enabled is (not host)
    assert rt.Config.from_json(cfg.to_json()).to_dict() == d
    with pytest.raises(ValueError, match="choose one"):
        rt.Config.from_dict({"host_sketch": True, "gpu_sketch": {"enabled": True}})


def test_snapshot_dir_warns_on_the_host_engine(tmp_path):
    cfg = rt.Config().use_host_sketch()
    cfg.snapshot_dir = str(tmp_path / "snap")
    with pytest.warns(UserWarning, match="no snapshotter"):
        c = rt.create(cfg)
    c.shutdown()


def test_get_sketch_names_by_kind():
    for cfg in (rt.Config().use_host_sketch(), rt.Config().use_gpu_sketch(device="cpu")):
        c = rt.create(cfg)
        try:
            c.get_bloom_filter("b").try_init(100, 0.01)
            c.get_hyper_log_log("h").add("x")
            assert sorted(c.get_sketch_names()) == ["b", "h"]
            assert c.get_sketch_names("bloom") == ["b"]
        finally:
            c.shutdown()


# -- the front door over the host engine -----------------------------------------------


@pytest.fixture(scope="module")
def host_servers():
    jc = redisson_tpu.create(redisson_tpu.Config())
    tc = rt.create(rt.Config().use_host_sketch())
    js, ts = JaxRespServer(jc), RespServer(tc)
    yield js, ts
    ts.close()
    js.close()
    tc.shutdown()
    jc.shutdown()


def test_wire_fixtures_byte_exact_on_host_engines(host_servers):
    js, ts = host_servers
    cmds = [c for c, _ in _wire.FIXTURES]
    _wire._check_table(_wire.FIXTURES, _wire._session(js, cmds), _wire._session(ts, cmds))


HOST_ADMIN = [
    [b"CONFIG", b"SET", b"nearcache", b"yes"],
    [b"CONFIG", b"GET", b"nearcache*"],
    [b"CONFIG", b"GET", b"append*"],
    [b"CONFIG", b"SET", b"appendonly", b"yes"],
    [b"CONFIG", b"GET", b"residency*"],
    [b"INFO", b"nearcache"],
    [b"INFO", b"persistence"],
    [b"WAIT", b"0", b"10"],
    [b"SAVE"],
    [b"BGREWRITEAOF"],
    [b"BF.RESERVE", b"hbf", b"0.01", b"1000"],
    [b"BF.MADD", b"hbf", b"a", b"b", b"a"],
    [b"BF.MEXISTS", b"hbf", b"a", b"z"],
    [b"TYPE", b"hbf"],
    [b"OBJECT", b"ENCODING", b"hbf"],
    [b"ROLE"],
    [b"DEL", b"hbf"],
]


def test_admin_replies_byte_equal_on_host_engines(host_servers):
    """The host engine has no near cache, journal, snapshotter or
    residency ladder: both servers refuse and omit alike."""
    js, ts = host_servers
    assert _wire._session(ts, HOST_ADMIN) == _wire._session(js, HOST_ADMIN)
    info = _wire._session(ts, [[b"INFO", b"server"]])[0]
    assert b"rtpu_device:host" in info


# -- DUMP / RESTORE ------------------------------------------------------------------


def _fill(c):
    """One object of each kind, the same ops on either engine."""
    bf = c.get_bloom_filter("d-bf")
    bf.try_init(5000, 0.01)
    bf.add_all([f"k{i}" for i in range(300)])
    h = c.get_hyper_log_log("d-hll")
    h.add_all([f"u{i}" for i in range(2000)])
    bs = c.get_bit_set("d-bs")
    bs.set_many(np.array([1, 5, 77, 1000]))
    cms = c.get_count_min_sketch("d-cms")
    cms.try_init(4, 1 << 10, track_top_k=3)
    cms.add_all(["hot"] * 20 + [f"c{i}" for i in range(50)])


def _answers(c, suffix=""):
    bf = c.get_bloom_filter("d-bf" + suffix)
    h = c.get_hyper_log_log("d-hll" + suffix)
    bs = c.get_bit_set("d-bs" + suffix)
    cms = c.get_count_min_sketch("d-cms" + suffix)
    return (
        np.asarray(bf.contains_each([f"k{i}" for i in range(400)])).tolist(),
        bf.count(), h.count(), bs.cardinality(), bs.length(),
        np.nonzero(bs.as_bit_array())[0].tolist(), bs.to_byte_array(),
        cms.estimate("hot"), cms.estimate("c3"), cms.top_k(1),
    )


_KINDS = ("d-bf", "d-hll", "d-bs", "d-cms")


def test_host_dumps_are_the_jax_host_engines_bytes():
    jc = redisson_tpu.create(redisson_tpu.Config())
    tc = rt.create(rt.Config().use_host_sketch())
    try:
        _fill(jc)
        _fill(tc)
        for name in _KINDS:
            assert tc._engine.dump(name) == jc._engine.dump(name), name
            # and the JAX host engine's dump restores into the port's
            tc._engine.restore(name + "-j", jc._engine.dump(name))
        assert _answers(tc, "-j") == _answers(tc)
    finally:
        tc.shutdown()
        jc.shutdown()


@pytest.mark.parametrize("direction", ["card-to-host", "host-to-card"])
def test_dump_of_either_engine_restores_into_the_other(direction):
    host = rt.create(rt.Config().use_host_sketch())
    card = rt.create(rt.Config().use_gpu_sketch(device="cpu", min_bucket=64))
    src, dst = (card, host) if direction == "card-to-host" else (host, card)
    try:
        _fill(src)
        for name in _KINDS:
            dst._engine.restore(name, src._engine.dump(name))
        assert _answers(dst) == _answers(src)
        with pytest.raises(ValueError, match="BUSYKEY"):
            dst._engine.restore("d-bf", src._engine.dump("d-bf"))
        # A round trip home gives the source engine's own bytes back.
        for name in _KINDS:
            src._engine.restore(name + "-rt", dst._engine.dump(name))
        assert _answers(src, "-rt") == _answers(src)
        if src is card:
            for name in ("d-bf", "d-hll", "d-cms"):
                eng = card._engine
                e1, e2 = eng.registry.lookup(name), eng.registry.lookup(name + "-rt")
                np.testing.assert_array_equal(eng.executor.read_row(e1.pool, e1.row),
                                              eng.executor.read_row(e2.pool, e2.row))
    finally:
        card.shutdown()
        host.shutdown()


def test_restore_of_a_forged_device_dump_is_refused_by_the_host_engine():
    card = rt.create(rt.Config().use_gpu_sketch(device="cpu", min_bucket=64))
    host = rt.create(rt.Config().use_host_sketch())
    try:
        card.get_bloom_filter("fb").try_init(1000, 0.01)
        blob = card._engine.dump("fb")
        with pytest.raises(ValueError):
            host._engine.restore("fb", blob[:-64])  # a truncated row
        assert not host._engine.exists("fb")
    finally:
        card.shutdown()
        host.shutdown()


def test_hashed_calls_agree_between_the_engines():
    """The engine-level hashed API of both port engines on the same
    (H1, H2): identical flags, sequential semantics."""
    from redisson_tpu_torch.utils import hashing

    keys = np.random.default_rng(3).integers(0, 1 << 40, 500).astype(np.uint64)
    keys[400:450] = keys[:50]
    H1, H2 = hashing.hash128_np(*hashing.encode_uint64_batch(keys))
    out = []
    for cfg in (rt.Config().use_host_sketch(), rt.Config().use_gpu_sketch(device="cpu")):
        c = rt.create(cfg)
        try:
            c.get_bloom_filter("hh").try_init(2000, 0.01)
            out.append((np.asarray(c._engine.bloom_add("hh", H1, H2).result()),
                        np.asarray(c._engine.bloom_contains("hh", H1[::-1], H2[::-1]).result())))
        finally:
            c.shutdown()
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    assert not out[0][0][400:450].any()

