"""The port's load-attribution plane (``obs/loadmap.py``) against the JAX
package's.

* ``tests/test_loadmap.py`` runs again on the port (``port_module`` of
  ``test_torch_observability.py``): the decayed CMS, the space-saving
  top-k, the slot accounting and snapshot, the exact key counters, the
  tenant fold, the launch split, the bounded export, the RESP surface
  (HOTKEYS, INFO loadstats, the CONFIG keys, shed accounting), the
  exact key counters against ``DEBUG COUNTKEYSINSLOT``'s scan, the
  accounting-overhead guard (``slow``, harness and bound unchanged) and
  the three-node fleet load map with federation (``slow``; its
  supervisor's nodes run with ``--device cpu``, ``cpu_builtins`` of
  ``test_torch_cluster.py``).
* Pure modules under an injected clock: seeded key streams through the
  JAX and the port ``LoadMap``, ``DecayedCMS`` and ``SpaceSavingTopK``
  give equal snapshots (the same float arithmetic: ``==``).
* The engine path: launch device time reaches the tenant shares and
  ``rtpu_tenant_device_us``, and it is the spans' event-timed
  ``device_s``.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu_torch as rt  # noqa: E402
import test_loadmap as _ref  # noqa: E402
from redisson_tpu_torch.serve.resp import RespServer  # noqa: E402
from test_resp_server import RespClient  # noqa: E402
from test_torch_cluster import cpu_builtins, port_namespace  # noqa: E402
from test_torch_observability import port_module  # noqa: E402
from test_torch_grid_coordination import _one_torch_thread  # noqa: E402,F401

port_module(_ref, globals(),
            skip={"test_three_node_fleet_loadmap_latency_and_federation"})
test_three_node_fleet_loadmap_latency_and_federation = port_namespace(
    _ref, cpu_builtins)["test_three_node_fleet_loadmap_latency_and_federation"]


# -- pure modules under an injected clock ---------------------------------------


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _stream(seed, n=4000):
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(1.2, n) % 300
    return [b"key:%d" % int(r) for r in ranks], rng


def _loadmap_snapshot(mod, seed):
    clk = _Clock()
    keys, rng = _stream(seed)
    lm = mod.LoadMap(sample_rate=1.0, half_life_s=5.0, clock=clk,
                     max_tenants=8)
    lm.cluster = True
    for i in range(0, len(keys), 50):
        clk.t += float(rng.integers(0, 3))
        batch = keys[i:i + 50]
        lm.sample_keys(batch, int(rng.integers(1, 4)))
        for k in batch[:5]:
            lm.note_command(mod.key_slot(k), bool(rng.integers(0, 2)),
                            len(k) + 10, int(rng.integers(1, 64)))
        lm.note_key(batch[0].decode(), +1)
        lm.attribute_launch(
            "bloom_add",
            [(f"t{int(t)}", int(rng.integers(1, 100)))
             for t in rng.integers(0, 20, 3)],
            float(rng.integers(10, 500)),
        )
    return (lm.hot_keys(16), lm.top_slots(8), lm.totals(), lm.stats(),
            lm.tenant_shares(), lm.snapshot(), lm.sampled_keys(),
            lm.tracked_keys())


def test_loadmap_equals_the_jax_loadmap():
    from redisson_tpu.obs import loadmap as jmod
    from redisson_tpu_torch.obs import loadmap as tmod

    for seed in range(3):
        assert _loadmap_snapshot(tmod, seed) == _loadmap_snapshot(jmod, seed)


def _sketch_snapshot(mod, seed):
    clk = _Clock()
    keys, rng = _stream(seed)
    cms = mod.DecayedCMS(width=512, depth=4, half_life_s=3.0, clock=clk)
    tk = mod.SpaceSavingTopK(capacity=32)
    for i, k in enumerate(keys):
        if i % 100 == 0:
            clk.t += float(rng.integers(0, 4))
            f = cms.maybe_decay(clk.t)
            if f != 1.0:
                tk.scale(f)
        cms.add(k)
        tk.offer(k.decode(), cms.estimate(k))
    return ([cms.estimate(b"key:%d" % r) for r in range(300)],
            tk.top(32), len(tk))


def test_decayed_cms_and_topk_equal_the_jax_sketches():
    from redisson_tpu.obs import loadmap as jmod
    from redisson_tpu_torch.obs import loadmap as tmod

    for seed in range(3):
        assert _sketch_snapshot(tmod, seed) == _sketch_snapshot(jmod, seed)


# -- the engine path ----------------------------------------------------------------


def test_exact_key_counters_and_device_time_on_the_engine_path():
    cl = rt.create(rt.Config().use_gpu_sketch(device="cpu", min_bucket=64))
    srv = RespServer(cl)
    conn = RespClient(srv.host, srv.port)
    try:
        assert srv._loadmap_keys_exact
        conn.cmd("CMS.INITBYDIM", "sk0", "64", "2")
        conn.cmd("CMS.INCRBY", "sk0", "item", "1")
        conn.cmd("SET", "grid0", "v")
        info = conn.cmd("INFO", "loadstats").decode()
        assert "loadmap_keys_exact:1" in info
        assert "loadmap_keys:2" in info
        assert srv.loadmap.keys_in_slot(0) == 2
        conn.cmd("RENAME", "grid0", "grid1")
        assert srv.loadmap.keys_in_slot(0) == 2
        conn.cmd("DEL", "grid1")
        assert srv.loadmap.keys_in_slot(0) == 1
        conn.cmd("DEL", "sk0")
        assert srv.loadmap.keys_in_slot(0) == 0
        # Launch device time reaches the tenant shares (completer path).
        bf = cl.get_bloom_filter("bf-dev")
        bf.try_init(10_000, 0.01)
        bf.add_all(np.arange(2048, dtype=np.uint64))
        deadline = time.monotonic() + 10
        while not srv.loadmap.tenant_shares().get("bf-dev"):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        us = srv.loadmap.tenant_shares()["bf-dev"]["device_us"]
        assert us > 0
        fam = cl.obs.registry.family("rtpu_tenant_device_us_total")
        assert sum(c.value for (t, _op), c in fam.items()
                   if t == "bf-dev") == pytest.approx(us, abs=0.05)
        # The bill is the launches' own device time (event-timed; the
        # launch's host duration on the CPU), not the spans' host phases.
        spans = [s for s in cl.obs.spans.recent() if s.tenants]
        assert spans and all(s.device_s is not None for s in spans)
        dev = sum(s.device_s * 1e6 for s in spans
                  if any(t == "bf-dev" for t, _ in s.tenants))
        assert us == pytest.approx(dev, abs=0.05)  # shares round to 0.1 us
        assert dev < sum((s.phases()["enqueue"] + s.phases()["d2h_fetch"]) * 1e6
                         for s in spans if any(t == "bf-dev" for t, _ in s.tenants))
    finally:
        conn.close()
        srv.close()
        cl.shutdown()
