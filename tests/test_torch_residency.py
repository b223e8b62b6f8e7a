"""The port's residency ladder against the JAX package's.

Counterparts of ``tests/test_residency.py`` (without the RESP, grid and
journal cases): the heat tracker under an injected clock; DEVICE ⇄ HOST
⇄ DISK for every sketch kind; writes on every tier; demotion refused
while a breaker owns the kind; born-cold creation past the device budget
and heat promotion; the maintenance cycle (budget, spill, admission,
quarantine reclaim); chaos at ``storage.spill`` and ``storage.load``; a
torn blob refused; delete, rename and expiry dropping tier state; the
forced-transition differential soak against the golden engine; blob GC
sparing snapshot-referenced files.  Each test sends the same ops through
a port client (``device="cpu"``) and a JAX client (CPU backend) and holds
per-op results, tier states and state bytes equal.

New to the port: blob files are byte-identical across the packages, a
blob spilled by either loads in the other, and a snapshot with tenants
on all three tiers restores across the packages in both directions with
every tenant's bytes equal.

Waits poll with a deadline; nothing sleeps to let time pass (the heat
tracker's clock is injected).
"""

import os
import shutil
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
from redisson_tpu import chaos as jchaos  # noqa: E402
from redisson_tpu.codecs import LongCodec as JaxLongCodec  # noqa: E402
from redisson_tpu.storage import HeatTracker as JaxHeatTracker  # noqa: E402
from redisson_tpu_torch import chaos  # noqa: E402
from redisson_tpu_torch.chaos import FaultInjected  # noqa: E402
from redisson_tpu_torch.codecs import LongCodec  # noqa: E402
from redisson_tpu_torch.storage import (  # noqa: E402
    DEVICE,
    DISK,
    HOST,
    HeatTracker,
    ResidencyError,
)

DEADLINE_S = 5.0
KNOBS = dict(batch_window_us=100, min_bucket=64)
CHAOS = ((chaos, "torch"), (jchaos, "jax"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _chaos_off():
    for mod, _ in CHAOS:
        mod.clear()
        mod.reset_counts()
    yield
    for mod, _ in CHAOS:
        mod.clear()
        mod.reset_counts()


def make_client(blob_dir=None, snapshot_dir=None, **kw):
    kw = {**KNOBS, **kw}
    if blob_dir is not None:
        kw.setdefault("residency_dir", str(blob_dir))
    cfg = rt.Config().set_codec(LongCodec()).use_gpu_sketch(device="cpu", **kw)
    cfg.retry_attempts = 2
    cfg.retry_interval_ms = 5
    if snapshot_dir is not None:
        cfg.snapshot_dir = str(snapshot_dir)
    return rt.create(cfg)


def make_jax_client(blob_dir=None, snapshot_dir=None, **kw):
    kw = {**KNOBS, **kw}
    if blob_dir is not None:
        kw.setdefault("residency_dir", str(blob_dir))
    cfg = redisson_tpu.Config().set_codec(JaxLongCodec()).use_tpu_sketch(**kw)
    cfg.retry_attempts = 2
    cfg.retry_interval_ms = 5
    if snapshot_dir is not None:
        cfg.snapshot_dir = str(snapshot_dir)
    return redisson_tpu.create(cfg)


@pytest.fixture
def pair(tmp_path):
    """(port client, JAX client), each spilling into its own directory."""
    port = make_client(tmp_path / "blobs-torch")
    jax_c = make_jax_client(tmp_path / "blobs-jax")
    yield port, jax_c
    port.shutdown()
    jax_c.shutdown()


def truth(client, name):
    """The object's current state in device-row layout, whatever tier."""
    eng = client._engine
    return np.asarray(eng._host_row(eng.registry.lookup(name))).copy()


def tier(client, name):
    e = client._engine.registry.lookup(name)
    return (e.residency, e.row >= 0)


def same(a, b):
    assert np.array_equal(np.asarray(a), np.asarray(b)), (a, b)


def wait_until(cond, what: str) -> None:
    deadline = time.monotonic() + DEADLINE_S
    while not cond():
        assert time.monotonic() < deadline, f"{what} within {DEADLINE_S} s"
        time.sleep(0.01)


class _FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


# -- heat tracker (injected clock) --------------------------------------------


@pytest.mark.parametrize("cls", [HeatTracker, JaxHeatTracker], ids=["torch", "jax"])
def test_heat_decays_by_half_life(cls):
    clk = _FakeClock()
    h = cls(half_life_s=10.0, clock=clk)
    for _ in range(8):
        h.touch("a")
    trace = [h.heat("a")]
    clk.t += 10.0
    trace.append(h.heat("a"))
    clk.t += 20.0
    trace += [h.heat("a"), h.idle_s("a"), h.heat("never"), h.idle_s("never")]
    assert trace == pytest.approx([8.0, 4.0, 1.0, 30.0, 0.0, 0.0])


def test_heat_rename_drop_and_prune_match_the_jax_tracker():
    traces = []
    for cls in (HeatTracker, JaxHeatTracker):
        clk = _FakeClock()
        h = cls(half_life_s=10.0, clock=clk, max_entries=8)
        h.touch("x", 5)
        h.rename("x", "y")
        trace = [h.heat("y"), h.heat("x")]
        h.drop("y")
        trace.append(h.heat("y"))
        for i in range(6):
            h.touch(f"hot{i}", 10)
        for i in range(9):
            h.touch(f"cold{i}", 1)
        assert len(h) <= 8
        assert h.heat("hot0") > 0.0  # the hottest survive the prune
        trace.append(sorted(h.snapshot().items()))
        traces.append(trace)
    assert traces[0] == traces[1]
    assert traces[0][:3] == [5.0, 0.0, 0.0]


# -- ladder transitions, all kinds, bit-exact ---------------------------------


def _load_kinds(c):
    bf = c.get_bloom_filter("bf")
    bf.try_init(2000, 0.01)
    bf.add_all([1, 2, 3])
    bs = c.get_bit_set("bs")
    bs.set_many([5, 700], True)
    cms = c.get_count_min_sketch("cms")
    cms.try_init(4, 512)
    cms.add(7, 3)
    h = c.get_hyper_log_log("hll")
    h.add_all(list(range(200)))
    return bf, bs, cms, h


NAMES = ("bf", "bs", "cms", "hll")


def test_full_ladder_every_kind_bit_exact(pair):
    out = []
    for c in pair:
        rm = c._engine.residency
        bf, bs, cms, h = _load_kinds(c)
        before = {n: truth(c, n) for n in NAMES}
        trace = []
        for n in NAMES:
            assert rm.demote(n), n
            trace.append(tier(c, n))
            same(truth(c, n), before[n])
        for n in NAMES:
            assert rm.spill(n), n
            trace.append(tier(c, n))
            assert n not in c._engine._mirrors
        # Reads on the DISK tier load the blob and serve identically.
        trace += [bf.contains(1), bf.contains(999999), bs.get(5), bs.get(6),
                  cms.estimate(7), h.count()]
        for n in NAMES:
            if tier(c, n)[0] == DISK:
                assert rm.load(n), n
            same(truth(c, n), before[n])
        for n in NAMES:
            assert rm.promote(n), n
            trace.append(tier(c, n))
            same(truth(c, n), before[n])
        st = rm.stats()
        trace += [st[k] for k in ("demotions", "promotions", "spills", "loads",
                                  "host_serves")]
        trace.append(rm.reclaim())  # quarantined rows recycle after a drain
        out.append((trace, before))
    assert out[0][0] == out[1][0]
    for n in NAMES:
        same(out[0][1][n], out[1][1][n])
    assert out[0][0][:4] == [(HOST, False)] * 4
    assert out[0][0][4:8] == [(DISK, False)] * 4
    assert out[0][0][-6:-2] == [4, 4, 4, 4] and out[0][0][-1] == 4
    assert out[0][0][-10:-6] == [(DEVICE, True)] * 4


def test_writes_on_every_tier_are_acked_and_kept(pair):
    outs = []
    for c in pair:
        eng = c._engine
        rm = eng.residency
        bf = c.get_bloom_filter("bf")
        bf.try_init(2000, 0.01)
        trace = [bf.add(1)]
        assert rm.demote("bf")
        trace.append(bf.add(2))  # HOST-tier write
        assert eng.health.board.open_count() == 0
        assert not eng.health.any_degraded  # demoted is not degraded
        assert rm.spill("bf")
        trace.append(bf.add(3))  # DISK-tier write: loads, then applies
        trace.append(tier(c, "bf"))
        assert rm.promote("bf")
        trace += [bf.contains(k) for k in (1, 2, 3, 4)]
        # Bitset size-class growth while demoted.
        bs = c.get_bit_set("bs")
        bs.set(1, True)
        assert rm.demote("bs")
        trace += [bs.set(100_000, True), bs.get(100_000), bs.get(1)]
        assert rm.promote("bs")
        trace += [bs.get(100_000), bs.get(1), bs.get(2), bs.length(), bs.size()]
        trace.append(eng.obs.degraded_ops.get(("bloom",)))
        outs.append((trace, truth(c, "bf"), truth(c, "bs")))
    assert outs[0][0] == outs[1][0]
    same(outs[0][1], outs[1][1])
    same(outs[0][2], outs[1][2])
    assert outs[0][0][3] == (HOST, False) and outs[0][0][4:7] == [True] * 3
    assert outs[0][0][-1] == 0  # no op counted as degraded


def test_demote_refused_while_a_breaker_owns_the_kind(pair):
    for c in pair:
        eng = c._engine
        rm = eng.residency
        bf = c.get_bloom_filter("bf")
        bf.try_init(1000, 0.01)
        bf.add(1)
        orig = eng.health.degraded_kind
        try:
            eng.health.degraded_kind = lambda kind: kind == "bloom"
            assert not rm.demote("bf")
            assert not rm.promote("bf")
        finally:
            eng.health.degraded_kind = orig
        assert rm.demote("bf") and not rm.demote("bf")
        assert rm.promote("bf") and not rm.promote("bf")
        assert bf.contains(1)


# -- born-cold creation + maintenance -----------------------------------------


def test_born_cold_past_budget_and_heat_promotion(pair):
    outs = []
    for c in pair:
        eng = c._engine
        rm = eng.residency
        rm.heat = type(rm.heat)(half_life_s=10.0, clock=_FakeClock())
        warm = c.get_bloom_filter("warm")
        warm.try_init(500, 0.01)
        warm.add(1)
        rm.set_budget(device_rows=rm.device_rows_used())
        cold = c.get_bloom_filter("cold")
        cold.try_init(500, 0.01)
        trace = [tier(c, "cold")]  # born cold: no row
        trace += [cold.add(42), cold.contains(42), cold.contains(43)]
        for _ in range(40):  # heat it
            cold.contains(42)
        out = rm.maintain()
        trace += [out, tier(c, "cold"), tier(c, "warm"), cold.contains(42),
                  warm.contains(1), rm.device_rows_used() <= rm.device_rows]
        rm.set_budget(device_rows=0)
        outs.append((trace, truth(c, "cold"), truth(c, "warm")))
    assert outs[0][0] == outs[1][0]
    same(outs[0][1], outs[1][1])
    same(outs[0][2], outs[1][2])
    trace = outs[0][0]
    assert trace[0] == (HOST, False)
    assert trace[4]["promoted"] >= 1 and trace[5] == (DEVICE, True)
    assert trace[6] == (HOST, False)  # the colder victim


def test_maintenance_budget_and_spill_and_admission(pair):
    outs = []
    for c in pair:
        eng = c._engine
        rm = eng.residency
        for i in range(6):
            bf = c.get_bloom_filter(f"t{i}")
            bf.try_init(500, 0.01)
            bf.add(i)
        used = rm.device_rows_used()
        rm.set_budget(device_rows=max(1, used - 3))
        trace = [rm.maintain()]
        # Demoted rows sit QUARANTINED (still counted used) until a later
        # cycle's drain reclaims them.
        trace.append(rm.reclaim())
        trace.append(rm.device_rows_used() <= rm.device_rows)
        rm.set_budget(max_host_bytes=1)  # everything demoted spills
        trace.append(rm.maintain())
        trace.append(rm.disk_objects())
        rm.promote_heat = 0.0
        rm._admission_blocked = lambda: True  # promotion deferred, never stormed
        trace.append(rm.maintain()["promoted"])
        trace += [c.get_bloom_filter(f"t{i}").contains(i) for i in range(6)]
        trace.append(sorted(tier(c, f"t{i}") for i in range(6)))
        rm.set_budget(device_rows=0, max_host_bytes=0)
        outs.append((trace, [truth(c, f"t{i}") for i in range(6)]))
    assert outs[0][0] == outs[1][0]
    for a, b in zip(outs[0][1], outs[1][1]):
        same(a, b)
    trace = outs[0][0]
    assert trace[0]["demoted"] >= 3 and trace[1] >= 3 and trace[2]
    assert trace[3]["spilled"] >= 1 and trace[4] >= 1 and trace[5] == 0


def test_background_thread_enforces_the_budget(tmp_path):
    c = make_client(tmp_path / "blobs", residency_device_rows=2,
                    residency_interval_ms=20)
    try:
        rm = c._engine.residency
        assert rm._thread is not None  # a budget arms the thread
        for i in range(6):
            c.get_bloom_filter(f"b{i}").try_init(500, 0.01)
        # Past the budget, tenants are born cold: at most 2 rows used.
        assert rm.device_rows_used() <= 2
        assert sum(tier(c, f"b{i}")[1] for i in range(6)) == 2
        for i in range(6):
            c.get_bloom_filter(f"b{i}").add(i)
        # A lower budget: the thread demotes, and a later cycle reclaims
        # the quarantined row.
        rm.set_budget(device_rows=1)
        wait_until(lambda: rm.device_rows_used() <= 1, "the thread enforces the budget")
        assert rm.stats()["demotions"] >= 1 and rm.errors == 0
        assert all(c.get_bloom_filter(f"b{i}").contains(i) for i in range(6))
    finally:
        c.shutdown()
    assert rm._thread is None


# -- chaos at the storage points ----------------------------------------------


def test_chaos_spill_and_load_fail_clean(pair):
    for c, (mod, _) in zip(pair, CHAOS):
        eng = c._engine
        rm = eng.residency
        bf = c.get_bloom_filter("bf")
        bf.try_init(1000, 0.01)
        bf.add_all([1, 2])
        want = truth(c, "bf")
        assert rm.demote("bf")
        mod.inject("storage.spill", kind="error", rate=1.0, seed=7)
        with pytest.raises(mod.FaultInjected):
            rm.spill("bf")
        assert tier(c, "bf") == (HOST, False)  # intact on the HOST tier
        same(truth(c, "bf"), want)
        mod.clear()
        assert rm.spill("bf")
        mod.inject("storage.load", kind="error", rate=1.0, seed=7)
        with pytest.raises(mod.FaultInjected):
            rm.load("bf")
        with pytest.raises(mod.FaultInjected):
            bf.contains(1)  # the op fails typed; nothing is served
        assert tier(c, "bf") == (DISK, False)
        mod.clear()
        assert rm.load("bf")
        same(truth(c, "bf"), want)
        # Both packages fired the same points, as often.
        assert mod.counts() == {("storage.spill", "error"): 1,
                                ("storage.load", "error"): 2}
    assert FaultInjected is chaos.FaultInjected


def test_failed_promotion_write_raises_typed_and_keeps_the_mirror(tmp_path):
    c = make_client(tmp_path / "blobs")
    try:
        eng = c._engine
        rm = eng.residency
        bf = c.get_bloom_filter("bf")
        bf.try_init(1000, 0.01)
        bf.add(1)
        want = truth(c, "bf")
        assert rm.demote("bf")
        free_before = len(eng.registry.lookup("bf").pool._free)
        chaos.inject("dispatch.write_row", kind="error", rate=1.0)
        with pytest.raises(ResidencyError):
            rm.promote("bf")
        chaos.clear()
        assert tier(c, "bf") == (HOST, False)
        assert len(eng.registry.lookup("bf").pool._free) == free_before  # row freed
        same(truth(c, "bf"), want)
        assert rm.promote("bf") and bf.contains(1)
    finally:
        c.shutdown()


def test_torn_blob_refuses_instead_of_serving_garbage(pair):
    for c in pair:
        rm = c._engine.residency
        bf = c.get_bloom_filter("bf")
        bf.try_init(1000, 0.01)
        bf.add(1)
        assert rm.demote("bf") and rm.spill("bf")
        path = os.path.join(rm.directory, rm.disk_index()["bf"]["file"])
        blob = open(path, "rb").read()
        mid = len(blob) // 2
        open(path, "wb").write(blob[:mid] + bytes([blob[mid] ^ 0xFF]) + blob[mid + 1:])
        with pytest.raises(ValueError, match="CRC"):
            rm.load("bf")
        with pytest.raises(ValueError, match="CRC"):
            bf.contains(1)
        open(path, "wb").write(blob[:mid])  # torn: short payload
        with pytest.raises(ValueError, match="CRC"):
            rm.load("bf")
        assert tier(c, "bf") == (DISK, False)


# -- identity ops across tiers ------------------------------------------------


def test_delete_rename_expire_drop_tier_state(pair):
    outs = []
    for c in pair:
        eng = c._engine
        rm = eng.residency
        bf = c.get_bloom_filter("a")
        bf.try_init(500, 0.01)
        bf.add(1)
        assert rm.demote("a") and rm.spill("a")
        assert eng.rename("a", "b")
        trace = [bool(rm.disk_index().get("b")), bool(rm.disk_index().get("a"))]
        trace.append(c.get_bloom_filter("b").contains(1))  # loaded from the renamed blob
        assert eng.delete("b")
        trace += [rm.disk_index(), rm.host_objects(), "b" in eng._mirrors]
        bf3 = c.get_bloom_filter("c")
        bf3.try_init(500, 0.01)
        bf3.add(1)
        assert rm.demote("c")
        eng.expire_at("c", time.time() - 1.0)
        trace += [eng.exists("c"), "c" in eng._mirrors, rm.host_objects()]
        # Retired blobs go at the next GC (no snapshot names them).
        trace.append(rm.gc_blobs())
        trace.append(sorted(os.listdir(rm.directory)))
        outs.append(trace)
    assert outs[0] == outs[1]
    assert outs[0][:3] == [True, False, True]
    assert outs[0][3:6] == [{}, 0, False] and outs[0][6:9] == [False, False, 0]
    assert outs[0][-1] == []


# -- the differential soak with forced transitions ----------------------------


def _flap(fn, attempts=8):
    """Ride out breaker flaps: a degraded-window op may fail typed while
    the breaker re-opens; retrying resumes from the mirror."""
    for _ in range(attempts - 1):
        try:
            return fn()
        except Exception:
            time.sleep(0.05)
    return fn()


def test_differential_soak_vs_golden_with_forced_transitions(tmp_path):
    """Interleaved ops + forced promote / demote / spill / load + breaker
    degradation on the same objects; every read equal to the JAX
    package's golden engine — zero stale reads, zero acked-write loss."""
    rng = np.random.default_rng(20260804)
    gold = redisson_tpu.create(redisson_tpu.Config().set_codec(JaxLongCodec()))
    c = make_client(tmp_path / "blobs", breaker_failure_threshold=2, breaker_open_ms=400)
    try:
        eng = c._engine
        rm = eng.residency
        tb, gb = (x.get_bloom_filter("soak-bf") for x in (c, gold))
        for h in (tb, gb):
            h.try_init(20_000, 0.01)
        tbs, gbs = (x.get_bit_set("soak-bs") for x in (c, gold))
        tcm, gcm = (x.get_count_min_sketch("soak-cms") for x in (c, gold))
        for h in (tcm, gcm):
            h.try_init(4, 512)
        th, gh = (x.get_hyper_log_log("soak-hll") for x in (c, gold))
        names = ("soak-bf", "soak-bs", "soak-cms", "soak-hll")
        K = 2000
        degraded_until = 0.0
        for step in range(300):
            roll = rng.random()
            if roll < 0.12:
                n = names[int(rng.integers(4))]
                verb = int(rng.integers(4))
                if verb == 0:
                    rm.demote(n)
                elif verb == 1:
                    rm.promote(n)
                elif verb == 2:
                    rm.demote(n)
                    rm.spill(n)
                else:
                    rm.load(n)
            elif roll < 0.15 and not degraded_until:
                chaos.inject("dispatch.bloom_mixed_keys_runs", kind="error",
                             rate=1.0, seed=step)
                degraded_until = time.monotonic() + 0.2
            elif roll < 0.40:
                ks = rng.integers(0, K, 6).tolist()
                assert np.array_equal(_flap(lambda: tb.add_all_async(ks).result()),
                                      gb.add_all_async(ks).result())
            elif roll < 0.55:
                idx = rng.integers(0, 4096, 4).tolist()
                val = bool(rng.random() < 0.8)
                same(_flap(lambda: tbs.set_many(idx, val)), gbs.set_many(idx, val))
            elif roll < 0.65:
                ks = rng.integers(0, K, 4).tolist()
                w = rng.integers(1, 5, 4).tolist()
                same(_flap(lambda: tcm.add_all(ks, w)), gcm.add_all(ks, w))
            elif roll < 0.72:
                ks = rng.integers(0, K, 8).tolist()
                assert _flap(lambda: th.add_all(ks)) == gh.add_all(ks)
            else:
                ks = rng.integers(0, K, 8).tolist()
                same(_flap(lambda: tb.contains_each(ks)), gb.contains_each(ks))
                idx = rng.integers(0, 4096, 4).tolist()
                same(_flap(lambda: tbs.get_many(idx)), gbs.get_many(idx))
                same(np.asarray(_flap(lambda: tcm.estimate_all(ks)), np.int64),
                     np.asarray(gcm.estimate_all(ks), np.int64))
                assert _flap(lambda: th.count()) == gh.count(), step
            if degraded_until and time.monotonic() > degraded_until:
                chaos.clear()
                degraded_until = 0.0
        chaos.clear()
        wait_until(lambda: not eng.health.any_degraded, "the breaker closes")
        for n in names:
            rm.load(n)
            rm.promote(n)
        ks = list(range(K))
        same(tb.contains_each(ks[:1024]), gb.contains_each(ks[:1024]))
        same(tb.contains_each(ks[1024:]), gb.contains_each(ks[1024:]))
        idx = list(range(4096))
        same(tbs.get_many(idx), gbs.get_many(idx))
        same(np.asarray(tcm.estimate_all(ks), np.int64),
             np.asarray(gcm.estimate_all(ks), np.int64))
        assert th.count() == gh.count()
        st = rm.stats()
        assert st["demotions"] > 0 and st["promotions"] > 0 and st["spills"] > 0
    finally:
        chaos.clear()
        c.shutdown()
        gold.shutdown()


# -- snapshots, blobs and GC across the packages ------------------------------


def _tiered_keyspace(c):
    """DEVICE + HOST + DISK + born-cold tenants of every kind."""
    rm = c._engine.residency
    for n in ("dev", "host", "disk", "disk-idle"):
        bf = c.get_bloom_filter(n)
        bf.try_init(1000, 0.01)
        bf.add_all([1, 2, len(n)])
    _load_kinds(c)
    names = ("dev", "host", "disk", "disk-idle") + NAMES
    want = {n: truth(c, n) for n in names}  # before any transition
    assert rm.demote("host") and rm.demote("bs") and rm.demote("hll")
    for n in ("disk", "disk-idle", "cms"):
        assert rm.demote(n) and rm.spill(n)
    rm.set_budget(device_rows=rm.device_rows_used())
    c.get_bloom_filter("born-cold").try_init(1000, 0.01)  # row -1, no mirror
    rm.set_budget(device_rows=0)
    return names + ("born-cold",), want


def test_blob_files_are_byte_identical_across_packages(pair):
    blobs = []
    for c in pair:
        rm = c._engine.residency
        _load_kinds(c)
        files = []
        for n in NAMES:
            assert rm.demote(n) and rm.spill(n)
            info = rm.disk_index()[n]
            with open(os.path.join(rm.directory, info["file"]), "rb") as f:
                files.append((info["file"], info["crc"], info["nbytes"], f.read()))
        blobs.append(files)
    assert blobs[0] == blobs[1]


@pytest.mark.parametrize("direction", ["torch->jax", "jax->torch"])
def test_tiered_snapshot_and_blobs_restore_across_packages(tmp_path, direction):
    """A snapshot with tenants on all three tiers (and one born cold),
    written by one package, restores into the other: every tenant on its
    tier, every tenant's bytes equal, DISK tenants loading the other
    package's blobs."""
    makers = {"torch": make_client, "jax": make_jax_client}
    src_name, dst_name = direction.split("->")
    blob_dir, snap = tmp_path / "blobs", tmp_path / "snap"
    src = makers[src_name](blob_dir)
    try:
        names, want = _tiered_keyspace(src)
        want_tiers = {n: tier(src, n) for n in names}
        src._engine.snapshot(str(snap))
        refs = sorted(src._engine.residency.disk_index()[n]["file"]
                      for n in ("disk", "disk-idle", "cms"))
    finally:
        src._engine.config.snapshot_dir = None
        src.shutdown()
    dst = makers[dst_name](blob_dir, snapshot_dir=snap)
    try:
        got_tiers = {n: tier(dst, n) for n in names}
        assert got_tiers == want_tiers
        assert sorted(dst._engine.residency.disk_index()[n]["file"]
                      for n in ("disk", "disk-idle", "cms")) == refs
        for n, row in want.items():
            same(truth(dst, n), row)
        # born cold: zeros on first touch, then a working object
        bc = dst.get_bloom_filter("born-cold")
        assert not bc.contains(1) and bc.add(1) and bc.contains(1)
        for n in ("host", "disk", "cms", "hll", "bs"):
            assert dst._engine.residency.promote(n), n
            same(truth(dst, n), want[n])
        assert dst.get_count_min_sketch("cms").estimate(7) == 3
    finally:
        dst._engine.config.snapshot_dir = None
        dst.shutdown()


def test_dump_restore_into_a_born_cold_entry(tmp_path):
    c = make_client(tmp_path / "blobs")
    try:
        rm = c._engine.residency
        bf = c.get_bloom_filter("src")
        bf.try_init(1000, 0.01)
        bf.add_all([4, 5])
        data = bf.dump()
        rm.set_budget(device_rows=rm.device_rows_used())
        c._engine.restore("copy", data)
        assert tier(c, "copy") == (HOST, False)
        same(truth(c, "copy"), truth(c, "src"))
        assert c.get_bloom_filter("copy").contains(4)
    finally:
        c.shutdown()


def test_blob_gc_never_deletes_snapshot_referenced_files(tmp_path):
    c = make_client(tmp_path / "blobs")
    snap = str(tmp_path / "snap")
    try:
        eng = c._engine
        rm = eng.residency
        bf = c.get_bloom_filter("bf")
        bf.try_init(1000, 0.01)
        bf.add(1)
        assert rm.demote("bf") and rm.spill("bf")
        blob1 = rm.disk_index()["bf"]["file"]
        eng.snapshot(snap)  # the snapshot references blob1
        assert rm.load("bf")
        bf.add(2)
        assert rm.spill("bf")
        blob2 = rm.disk_index()["bf"]["file"]
        assert blob2 != blob1
        rm.gc_blobs()
        assert os.path.exists(os.path.join(rm.directory, blob1))
        eng.snapshot(snap)  # the next snapshot references blob2 only
        rm.gc_blobs()
        assert not os.path.exists(os.path.join(rm.directory, blob1))
        assert os.path.exists(os.path.join(rm.directory, blob2))
        # A snapshot naming a missing blob is refused before any mutation.
        shutil.copytree(snap, str(tmp_path / "snap2"))
        os.unlink(os.path.join(rm.directory, blob2))
        with pytest.raises(ValueError, match="missing"):
            make_client(tmp_path / "blobs", snapshot_dir=tmp_path / "snap2")
    finally:
        c._engine.config.snapshot_dir = None
        c.shutdown()


def test_residency_counters_and_gauges(tmp_path):
    c = make_client(tmp_path / "blobs")
    try:
        rm = c._engine.residency
        _load_kinds(c)
        for n in NAMES:
            assert rm.demote(n) and rm.spill(n) and rm.load(n) and rm.promote(n)
        text = c._engine.obs.registry.render_prometheus()
        for fam in ("rtpu_residency_promotions_total 4", "rtpu_residency_demotions_total 4",
                    "rtpu_residency_spills_total 4", "rtpu_residency_loads_total 4",
                    "rtpu_residency_device_rows", "rtpu_residency_host_bytes",
                    "rtpu_residency_disk_bytes"):
            assert fam in text, fam
        lat = rm.latency_ms()
        assert sorted(lat) == ["demote", "load", "promote", "spill"]
        assert all(v["n"] == 4 and v["p50"] >= 0.0 for v in lat.values())
    finally:
        c.shutdown()


def test_load_sketch_rows_into_a_born_cold_entry(tmp_path):
    from redisson_tpu_torch.interop import load_sketch_rows

    jax_c = make_jax_client()
    c = make_client(tmp_path / "blobs")
    try:
        jbf = jax_c.get_bloom_filter("carried")
        jbf.try_init(1000, 0.01)
        jbf.add_all([3, 4])
        jeng = jax_c._engine
        je = jeng.registry.lookup("carried")
        row = np.asarray(jeng.executor.read_row(je.pool, je.row))
        rm = c._engine.residency
        rm.set_budget(device_rows=max(1, rm.device_rows_used()))
        c.get_bloom_filter("holder").try_init(1000, 0.01)  # fills the budget
        bf = load_sketch_rows(c, "carried", "bloom", jeng.params("carried"), row)
        assert tier(c, "carried") == (HOST, False)
        same(truth(c, "carried"), row)
        assert bf.contains(3) and bf.contains(4) and not bf.contains(5)
    finally:
        c.shutdown()
        jax_c.shutdown()


@pytest.mark.parametrize("tier_of_source", ["host", "disk"])
def test_merges_and_bitop_with_a_source_off_the_card(tmp_path, tier_of_source):
    """CMS.MERGE, PFMERGE and BITOP into a device-resident destination
    from a source on the host or disk tier take the source's truth (the
    JAX package passes the source's row, -1, to the device merge and
    loses it)."""
    c = make_client(tmp_path / "blobs")
    gold = make_client(tmp_path / "blobs-gold")  # the same ops, all on the card
    try:
        for cl in (c, gold):
            a = cl.get_count_min_sketch("a")
            a.try_init(4, 256)
            a.add(1, 5)
            b = cl.get_count_min_sketch("b")
            b.try_init(4, 256)
            b.add(2, 7)
            cl.get_hyper_log_log("ha").add_all(list(range(100)))
            cl.get_hyper_log_log("hb").add_all(list(range(50, 300)))
            cl.get_bit_set("sa").set_many([1, 5], True)
            cl.get_bit_set("sb").set_many([5, 9], True)
        rm = c._engine.residency
        for n in ("b", "hb", "sb"):
            assert rm.demote(n)
            if tier_of_source == "disk":
                assert rm.spill(n)
        for cl in (c, gold):
            cl.get_count_min_sketch("a").merge("b")
            cl.get_hyper_log_log("ha").merge_with("hb")
            cl.get_bit_set("sa").or_op("sb")
        assert c.get_count_min_sketch("a").estimate(2) == 7
        assert c.get_count_min_sketch("a").estimate(1) == 5
        for n in ("a", "ha", "sa", "b", "hb", "sb"):
            same(truth(c, n), truth(gold, n))
        assert c.get_hyper_log_log("ha").count() == gold.get_hyper_log_log("ha").count()
        assert c.get_bit_set("sa").cardinality() == 3
    finally:
        c.shutdown()
        gold.shutdown()
