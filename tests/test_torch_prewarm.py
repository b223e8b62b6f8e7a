"""The port's bucket pre-warmer against the JAX package's.

Counterparts of the pre-warm cases of ``tests/test_warm_path.py``.  The
JAX package warms its jit cache and counts XLA compiles; PyTorch compiles
nothing, so the port counts first launches instead — the first launch of
each (op, bucket, device, pool signature), where the card pays its lazy
kernel load and the allocator's first block of a size
(``executor.torch_executor.first_launch_count``).  The tests show the
ladder is the JAX package's, every bucket of it is launched by the warm
thread, the keyed Bloom ladder registers on the first submit, a pool's
growth re-runs its ladders, a warm failure raises out of
``prewarm_wait``, and a serving window over every bucket adds no first
launch — with every answer equal to a JAX client's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
from redisson_tpu.codecs import LongCodec as JaxLongCodec  # noqa: E402
from redisson_tpu_torch import chaos  # noqa: E402
from redisson_tpu_torch.codecs import LongCodec  # noqa: E402
from redisson_tpu_torch.executor import prewarm, torch_executor  # noqa: E402

WAIT_S = 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _chaos_off():
    chaos.clear()
    yield
    chaos.clear()


def _client(**kw):
    cfg = rt.Config().set_codec(LongCodec()).use_gpu_sketch(
        device="cpu", min_bucket=64, **kw)
    return rt.create(cfg)


def _jax_client(**kw):
    cfg = redisson_tpu.Config().set_codec(JaxLongCodec()).use_tpu_sketch(
        min_bucket=64, **kw)
    return redisson_tpu.create(cfg)


def launched_buckets(op: str, pool) -> set:
    """Buckets of ``op`` launched on ``pool``'s signature so far."""
    sig = (pool.spec.key, pool.capacity)
    return {k[1] for k in set(torch_executor._first_launched)
            if k[0] == op and k[3] == sig}


def _attach_kinds(c):
    """An HLL, a bitset and a CMS: their ladders register on attach."""
    c.get_hyper_log_log("pw-hll").add(1)
    c.get_bit_set("pw-bs").set(1)
    cms = c.get_count_min_sketch("pw-cms")
    cms.try_init(4, 256)
    return {"hll_add_changed": "pw-hll", "bitset_mixed": "pw-bs",
            "bitset_mixed_runs": "pw-bs", "cms_update_estimate": "pw-cms"}


def test_prewarm_populates_every_bucket():
    cl = _client(prewarm=True, max_batch=2048)
    jax_c = _jax_client(prewarm=True, max_batch=2048)
    try:
        ops = _attach_kinds(cl)
        assert cl.prewarm_wait(WAIT_S), "pre-warm did not drain"
        pw = cl._engine.prewarmer
        ladder = pw.ladder()
        assert ladder == jax_c._engine.prewarmer.ladder()  # the same buckets
        assert ladder[-1] >= 2048 and len(ladder) >= 4
        for op, name in ops.items():
            pool = cl._engine.registry.lookup(name).pool
            assert launched_buckets(op, pool) >= set(ladder), op
        assert pw.errors == 0 and pw.warmed >= len(ops) * len(ladder)
    finally:
        cl.shutdown()
        jax_c.shutdown()


def test_prewarm_keyed_ladder_registers_on_first_submit():
    """The codec-shaped (lane count / trim depth) ladder can't be known at
    pool attach; the FIRST encoded submit schedules it."""
    cl = _client(prewarm=True, max_batch=1024)
    jax_c = _jax_client(prewarm=True, max_batch=1024)
    try:
        answers = []
        for c in (cl, jax_c):
            bf = c.get_bloom_filter("pw-keyed")
            bf.try_init(10_000, 0.01)
            added = bf.add_all(np.arange(100, dtype=np.uint64))
            assert c.prewarm_wait(WAIT_S)
            # Warm dispatches ran against scratch state: tenant data intact.
            answers.append([added, bf.contains_all(np.arange(100, dtype=np.uint64)),
                            bf.contains(np.uint64(999_983))])
        assert answers[0] == answers[1] == [100, 100, False]
        pool = cl._engine.registry.lookup("pw-keyed").pool
        ladder = set(cl._engine.prewarmer.ladder())
        assert launched_buckets("bloom_mixed_keys_runs", pool) >= ladder
        assert launched_buckets("bloom_mixed_keys", pool) >= ladder
        assert cl._engine.prewarmer.errors == 0
    finally:
        cl.shutdown()
        jax_c.shutdown()


def test_prewarm_reruns_on_pool_growth():
    """Growth changes the pool signature; its ladder re-runs against the
    new layout."""
    cl = _client(prewarm=True, max_batch=512)
    try:
        h0 = cl.get_hyper_log_log("grow-0")
        h0.add(1)
        pool = cl._engine.registry.lookup("grow-0").pool
        cap0 = pool.capacity
        assert cl.prewarm_wait(WAIT_S)
        for i in range(1, cap0 + 1):  # one more tenant than rows: one growth
            cl.get_hyper_log_log(f"grow-{i}").add(i)
        assert pool.capacity == 2 * cap0 and pool.generation >= 1
        assert cl.prewarm_wait(WAIT_S)
        assert launched_buckets("hll_add_changed", pool) >= set(cl._engine.prewarmer.ladder())
        assert cl._engine.prewarmer.errors == 0
        assert [cl.get_hyper_log_log(f"grow-{i}").count() for i in range(cap0 + 1)] == [1] * (cap0 + 1)
    finally:
        cl.shutdown()


def test_prewarm_failure_raises_out_of_prewarm_wait():
    """Warming never swallows a failure: the first one raises out of
    prewarm_wait (once), chained to its cause."""
    cl = _client(prewarm=True, max_batch=256)
    try:
        chaos.inject("prewarm", kind="error", rate=1.0)
        cl.get_hyper_log_log("pw-fail").add(1)
        with pytest.raises(RuntimeError, match="pre-warm") as ei:
            cl.prewarm_wait(WAIT_S)
        assert isinstance(ei.value.__cause__, chaos.FaultInjected)
        assert cl._engine.prewarmer.errors >= 1
        chaos.clear()
        assert cl.prewarm_wait(WAIT_S)
    finally:
        cl.shutdown()


def test_prewarm_off_is_trivially_drained():
    cl = _client()
    try:
        assert cl._engine.prewarmer is None and cl.prewarm_wait(0.0)
    finally:
        cl.shutdown()


def test_no_first_launch_after_prewarm_completes():
    """Once pre-warm drains, serving over every bucket of the ladder — for
    Bloom, BitSet, HLL and the multi-tenant CMS path — adds no first
    launch, and every answer equals the JAX package's."""
    cl = _client(prewarm=True, max_batch=2048, batch_window_us=200)
    jax_c = _jax_client(max_batch=2048, batch_window_us=200)
    try:
        objs = []
        for c in (cl, jax_c):
            bf = c.get_bloom_filter("nf-bf")
            bf.try_init(10_000, 0.01)
            # The first encoded submit reveals the codec signature (its own
            # first launch) and schedules the keyed ladders.
            bf.add_all(np.arange(64, dtype=np.uint64))
            hll = c.get_hyper_log_log("nf-hll")
            hll.add(0)
            bs = c.get_bit_set("nf-bs")
            bs.set(0)
            cms = c.get_count_min_sketch("nf-cms")
            cms.try_init(4, 256)
            objs.append((bf, hll, bs, cms))
        assert cl.prewarm_wait(WAIT_S)
        before = prewarm.first_launch_count()
        rng = np.random.default_rng(1)
        answers = [[], []]
        for nops in (1, 33, 64, 100, 128, 500, 1024, 2000):
            keys = rng.integers(0, 20_000, nops).astype(np.uint64)
            idx = rng.integers(0, 4096, nops)
            w = rng.integers(1, 4, nops)
            for out, (bf, hll, bs, cms) in zip(answers, objs):
                out += [bf.add_all(keys), bf.contains_all(keys), hll.add_all(keys),
                        bs.set_many(idx, True).tolist(), cms.add_all(keys, w)]
        cl._engine._drain()
        after = prewarm.first_launch_count()
        assert after == before, f"{after - before} first launches on the warm path"
        for a, b in zip(*answers):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    finally:
        cl.shutdown()
        jax_c.shutdown()
