"""Shards on several devices: the port's placements against the JAX
package's 8-device mesh (the 8 virtual CPU devices of
``tests/conftest.py``), exactly.

* Every builder of ``parallel/mesh.py``: the cases of
  ``tests/test_torch_parallel.py`` run again with the port's mesh laid
  on 2, 4 and 8 placements of the CPU (one parametrised test per
  builder); the state handed in is the same numpy-seeded ``[S, L]``
  array split into the placements' blocks, and the state coming out —
  the blocks concatenated — must be byte-equal to the JAX mesh's, every
  per-op result equal.
* The client at ``num_shards=8`` on 4 CPU placements (the device
  enumeration replaced by four entries of the CPU, ``device_indices``
  0..3) against a JAX client at 8 shards: the cases of
  ``tests/test_torch_sharded.py`` — per-op results, pool bytes, DUMP
  bytes, snapshots restored both ways onto 8, 4 and 1 shards, read
  replication, ``change_topology(8 -> 4 -> 1)``.
* The JAX package's ``test_resolve_device_slice_fake_devices`` and
  ``test_executor_pins_device_slice`` (``tests/test_multicore.py``),
  rebound on the port, beside the port's ``worker_device`` cases of
  ``tests/test_torch_multicore.py``; and a front-door worker on a faked
  8-card node building its mesh over its whole slice.
"""

import builtins
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import redisson_tpu_torch as rt  # noqa: E402
import test_multicore as _ref_multicore  # noqa: E402
import test_torch_parallel as _par  # noqa: E402
import test_torch_sharded as _sh  # noqa: E402
from redisson_tpu.parallel import mesh as jpm  # noqa: E402
from redisson_tpu_torch.executor import torch_executor  # noqa: E402
from redisson_tpu_torch.executor.sharded_executor import (  # noqa: E402
    ShardedTorchCommandExecutor,
)
from redisson_tpu_torch.parallel import mesh as tpm  # noqa: E402
from redisson_tpu_torch.serve.multicore import worker_device_indices  # noqa: E402

S = 8
PLACEMENTS = 4  # the client's placements
_LOCAL_DEVICES = torch_executor.local_devices  # the real enumeration


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rebound(fn, **overrides):
    """``fn`` with globals replaced (its parametrisation kept)."""
    g = dict(fn.__globals__)
    g.update(overrides)
    new = types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__,
                             fn.__closure__)
    new.__kwdefaults__ = fn.__kwdefaults__
    new.__doc__ = fn.__doc__
    new.pytestmark = list(getattr(fn, "pytestmark", []))
    return new


# -- the builders on 2, 4 and 8 placements ----------------------------------------


@pytest.fixture(scope="module", params=[2, 4, 8], ids=lambda d: f"{d}placements")
def tctx(request):
    ctx = tpm.MeshContext(devices=["cpu"] * request.param, n_shards=S)
    assert ctx.placed and len(ctx.devices) == request.param
    return ctx


@pytest.fixture(scope="module")
def jctx(tctx):
    assert len(jax.devices()) >= S, "conftest must force 8 cpu devices"
    ctx = jpm.MeshContext(n_shards=S)
    ctx.port = tctx  # the port mesh the state helpers place into
    return ctx


def _np(x):
    """Host copy of a result or a state of any form: placed states and
    per-placement results concatenate their blocks."""
    if isinstance(x, tpm.PlacedState):
        x = torch.cat(x.blocks)
    elif isinstance(x, tpm.Blocks):
        x = torch.cat(list(x))
    return _par._np(x)


def _states(jctx, local_len, dtype, seed, zero=False):
    js, ts = _par._states(jctx, local_len, dtype, seed, zero)
    ctx = jctx.port
    return js, tpm.PlacedState(ctx, [ts[sh.start : sh.stop].clone()
                                     for _, _, sh in ctx.placements()])


def _same_state(js, ts):
    assert isinstance(ts, tpm.PlacedState)
    np.testing.assert_array_equal(np.asarray(js), _np(ts))


_BUILDER_CASES = [name for name in dir(_par) if name.startswith("test_")]
for _name in _BUILDER_CASES:
    globals()[_name] = _rebound(getattr(_par, _name), _np=_np, _states=_states,
                                _same_state=_same_state)
del _name


def test_builder_cases_cover_every_builder():
    """Every builder of the mesh module is reached by a rebound case."""
    import inspect

    builders = {n for n, f in vars(tpm).items()
                if inspect.isfunction(f) and f.__module__ == tpm.__name__
                and n.startswith(("sharded_", "psharded_", "msharded_"))}
    used = set()
    for name in _BUILDER_CASES:
        used |= set(getattr(_par, name).__code__.co_names)
        for const in getattr(_par, name).__code__.co_consts:
            if isinstance(const, types.CodeType):
                used |= set(const.co_names)
    assert builders <= used, builders - used


# -- the client on 4 CPU placements against a JAX client at 8 shards ---------------


@pytest.fixture(scope="module")
def cpu_placements():
    """The local enumeration as four entries of the CPU: device_indices
    0..3 then names four placements on it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_executor, "local_devices",
                   lambda device: [torch.device("cpu")] * PLACEMENTS)
        yield


def port_client(num_shards=S, snapshot_dir=None, **kw):
    kw.setdefault("device_indices", list(range(PLACEMENTS)))
    return _sh.port_client(num_shards=num_shards, snapshot_dir=snapshot_dir, **kw)


@pytest.fixture(scope="module")
def streamed(cpu_placements):
    jc, tc = _sh.jax_client(), port_client()
    ctx = tc._engine.executor.ctx
    assert ctx.placed and len(ctx.devices) == PLACEMENTS and ctx.per == S // PLACEMENTS
    jout, tout = _sh._stream(jc), _sh._stream(tc)
    yield jc, tc, jout, tout
    jc.shutdown()
    tc.shutdown()


def test_pools_are_placed_blocks_with_every_shard_used(streamed):
    """The streamed client's pools are four ``[2, L]`` blocks, and every
    shard, on every placement, holds tenant data."""
    _, tc, _, _ = streamed
    eng = tc._engine
    assert {str(d) for d in eng.mesh_devices()} == {"cpu"} and len(eng.mesh_devices()) == S
    for pool in eng.registry.pools():
        st = pool.state
        assert isinstance(st, tpm.PlacedState) and len(st.blocks) == PLACEMENTS
        assert all(b.shape[0] == S // PLACEMENTS for b in st.blocks)
        assert tuple(st.shape) == tuple(eng.executor.state_to_host(pool).shape)
    nodes = tc.get_nodes_group().get_nodes()
    assert [n.shard for n in nodes] == list(range(S))
    assert all(n.info()["process_index"] == 0 for n in nodes)


# The streamed cases; the reshard case runs last (it reshards the clients).
_CLIENT_CASES = (
    "test_per_op_results_equal",
    "test_pool_arrays_byte_equal",
    "test_dump_bytes_equal",
    "test_layout_rule_places_every_row_as_both_executors_do",
    "test_snapshot_restores_across_packages_and_shards",
    "test_change_topology_matches_the_reference",
    "test_replicated_filter_rows_equal_across_packages",
    "test_copy_row_into_an_m_sharded_pool_matches_the_reference",
)


def _client_case(name):
    fn = _rebound(getattr(_sh, name), port_client=port_client)

    @functools.wraps(fn)
    def run(*args, **kwargs):
        kwargs.pop("cpu_placements")
        return fn(*args, **kwargs)

    # The enumeration stays replaced for the whole case (it builds and
    # reshards clients).
    import inspect

    sig = inspect.signature(fn)
    params = list(sig.parameters.values())
    params.append(inspect.Parameter("cpu_placements", inspect.Parameter.KEYWORD_ONLY))
    run.__signature__ = sig.replace(parameters=params)
    run.pytestmark = list(getattr(fn, "pytestmark", []))
    return run


for _name in _CLIENT_CASES:
    globals()[_name] = _client_case(_name)
del _name


def test_change_topology_takes_the_first_devices_of_the_slice(cpu_placements):
    """8 -> 2 keeps two placements (devices[:2]); 2 -> 1 the single
    device executor on the first; a count the slice cannot split raises
    and leaves the old topology."""
    with pytest.raises(ValueError, match="8 shards do not split evenly over 3 placements"):
        port_client(device_indices=[2, 0, 3])
    c = port_client(device_indices=[2, 0])
    try:
        bf = c.get_bloom_filter("t")
        bf.try_init(1000, 0.01)
        bf.add_all(np.arange(300, dtype=np.uint64))
        assert len(c._engine.executor.ctx.devices) == 2
        with pytest.raises(ValueError, match="3 shards do not split evenly over 2"):
            c.change_topology(3)
        assert c._engine.executor.S == S
        assert c.change_topology(2) is True
        ctx = c._engine.executor.ctx
        assert ctx.placed and len(ctx.devices) == 2 and ctx.per == 1
        assert c.change_topology(1) is True
        assert not isinstance(c._engine.executor, ShardedTorchCommandExecutor)
        assert bf.contains_all(np.arange(300, dtype=np.uint64)) == 300
    finally:
        c.shutdown()


def test_state_to_host_is_the_concatenated_blocks(cpu_placements):
    c = port_client(num_shards=4)
    try:
        hl = c.get_hyper_log_log("h")
        hl.add_all(np.arange(5000, dtype=np.uint64))
        entry = c._engine.registry.lookup("h")
        st = entry.pool.state
        host = c._engine.executor.state_to_host(entry.pool)
        np.testing.assert_array_equal(host, torch.cat(st.blocks).numpy())
        assert c._engine.executor.state_to_host(entry.pool).shape[0] == 4
    finally:
        c.shutdown()


# -- device slices: the reference's cases rebound, and the front-door worker -------


def _rebind_import(fn, mapping):
    """``fn`` whose in-body imports of the modules named in ``mapping``
    get the port's module instead."""

    def _import(name, globals=None, locals=None, fromlist=(), level=0):
        if level == 0 and name in mapping:
            return mapping[name]
        return builtins.__import__(name, globals, locals, fromlist, level)

    g = dict(fn.__globals__)
    g["__builtins__"] = dict(vars(builtins), __import__=_import)
    return types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__,
                              fn.__closure__)


test_resolve_device_slice_fake_devices = _rebind_import(
    _ref_multicore.test_resolve_device_slice_fake_devices,
    {"redisson_tpu.executor.tpu_executor": torch_executor},
)


def test_executor_pins_device_slice(monkeypatch):
    """The reference's case on the port: an executor built with
    device_indices holds exactly that slice of the (fake 8-card)
    enumeration, its first card as its single device; on four CPU
    entries the pinned client still serves traffic."""
    monkeypatch.setattr(torch_executor, "local_devices", _LOCAL_DEVICES)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    cfg = rt.Config().use_gpu_sketch(min_bucket=64, device_indices=[1, 3])
    ex = torch_executor.TorchCommandExecutor(cfg)
    assert ex.devices == [torch.device("cuda", 1), torch.device("cuda", 3)]
    assert ex.device == torch.device("cuda", 1)
    with pytest.raises(ValueError, match="repeated"):
        torch_executor.TorchCommandExecutor(
            rt.Config().use_gpu_sketch(device_indices=[2, 2]))
    monkeypatch.setattr(torch_executor, "local_devices",
                        lambda device: [torch.device("cpu")] * 4)
    client = rt.create(rt.Config().use_gpu_sketch(
        device="cpu", min_bucket=64, num_shards=2, device_indices=[1, 3]))
    try:
        assert len(client._engine.executor.ctx.devices) == 2
        bf = client.get_bloom_filter("pin-bf")
        bf.try_init(10_000, 0.01)
        keys = np.arange(64, dtype=np.uint64)
        bf.add_all(keys)
        assert bool(np.all(bf.contains_each(keys)))
    finally:
        client.shutdown()


def test_front_door_worker_meshes_over_its_whole_slice(monkeypatch):
    """Worker 1 of 2 on a faked 8-card node takes cards 4..7 as its
    device_indices: its sharded executor's mesh spans cuda:4..7 and its
    single-device executor holds cuda:4.  A CPU worker keeps the
    configured device; with no card the executor still refuses."""
    monkeypatch.setattr(torch_executor, "local_devices", _LOCAL_DEVICES)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    idx = worker_device_indices("cuda", 1, 2, torch.cuda.device_count())
    assert idx == [4, 5, 6, 7]
    assert worker_device_indices("cuda", 0, 2, 8) == [0, 1, 2, 3]
    assert worker_device_indices("cuda", 1, 4, 2) is None
    assert worker_device_indices("cpu", 1, 2, 8) is None
    assert worker_device_indices("cuda:3", 1, 2, 8) is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_executor.TorchCommandExecutor(rt.Config().use_gpu_sketch(device_indices=idx))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    single = torch_executor.TorchCommandExecutor(rt.Config().use_gpu_sketch(device_indices=idx))
    assert single.device == torch.device("cuda", 4)
    sharded = ShardedTorchCommandExecutor(
        rt.Config().use_gpu_sketch(device_indices=idx, num_shards=8))
    assert sharded.ctx.devices == [torch.device("cuda", i) for i in (4, 5, 6, 7)]
    assert [s for s, _ in sharded.ctx.local_shards()] == list(range(8))
    assert sharded.ctx.shard_device(5) == torch.device("cuda", 6)


def test_config_keys_round_trip():
    """The four keys travel through to_dict/from_dict as the JAX
    package's Config names them."""
    cfg = rt.Config().use_gpu_sketch(device="cpu", device_indices=[0],
                                     coordinator_address="127.0.0.1:1",
                                     num_processes=2, process_id=1)
    back = rt.Config.from_dict(cfg.to_dict())
    for key in ("device_indices", "coordinator_address", "num_processes", "process_id"):
        assert getattr(back.gpu_sketch, key) == getattr(cfg.gpu_sketch, key), key
    from redisson_tpu.config import TpuSketchConfig

    ref = TpuSketchConfig()
    for key in ("device_indices", "coordinator_address", "num_processes", "process_id"):
        assert getattr(ref, key) == getattr(rt.Config().gpu_sketch, key), key
