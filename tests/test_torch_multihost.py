"""The port's two-process engine (the counterpart of
``tests/test_multihost.py``, which the JAX package xfails on its CPU
backend): two OS processes join one torch.distributed group over gloo on
127.0.0.1, 8 global shards, 4 in each, through the engine's own
``coordinator_address`` config, and drive ``tests/torch_multihost_worker.py``'s
stream in lockstep — the reference worker's Bloom, HLL and BitSet plus a
BITOP, a PFMERGE and a CMS.MERGE across the two processes, a snapshot,
and a live reshard to 4 global shards and to 1.

* both processes return identical results, equal to a single-process
  JAX client at 8 shards (the 8 virtual devices of ``tests/conftest.py``)
  on the same stream;
* both snapshots hold the JAX one's pool arrays byte for byte, with the
  metadata equal but the CRC of the blob (``np.savez`` stamps times);
* the lockstep guards hold: the near cache locked off, no periodic
  snapshotter (with the JAX package's warning), a second engine in the
  process joins no group and its shutdown leaves the first's standing,
  and the group is destroyed with the engine that made it;
* ``coalesce=True`` is refused before any group is joined (the JAX
  package lets it run; ROADMAP queue 3);
* ``chip_smoke.py``'s phases 20 and 21 hold at a small size on the CPU
  (21b's children are two more processes over gloo).

Each child has a 120 s deadline; one that hangs kills both.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
import torch_multihost_worker as worker  # noqa: E402
from redisson_tpu.codecs import LongCodec as JaxLongCodec  # noqa: E402

WORKER = Path(worker.__file__)
DEADLINE_S = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(out_dir) -> list:
    """Both children's MH-OK reports; a child past the deadline kills both."""
    port = _free_port()
    root = str(WORKER.parent.parent)
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(pid), str(port), str(out_dir)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=root, env=env)
             for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DEADLINE_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
    reports = [json.loads(line[len("MH-OK "):]) for out in outs
               for line in out.splitlines() if line.startswith("MH-OK ")]
    assert len(reports) == 2, outs
    return reports


def _snapshot(directory):
    with open(os.path.join(directory, "sketch_meta.json")) as f:
        meta = json.load(f)
    meta.pop("pools_crc")
    with np.load(os.path.join(directory, "sketch_pools.npz")) as z:
        pools = {k: z[k] for k in z.files}
    return meta, pools


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    out = tmp_path_factory.mktemp("multihost")
    reports = _run_pair(out)
    cfg = redisson_tpu.Config().set_codec(JaxLongCodec()).use_tpu_sketch(
        num_shards=worker.S, min_bucket=64, coalesce=False)
    jc = redisson_tpu.create(cfg)
    try:
        jres = worker.stream(jc, str(out / "jax"))
    finally:
        jc.shutdown()
    return out, reports, jres


def test_both_processes_agree_with_each_other_and_the_reference(pair):
    _, (r0, r1), jres = pair
    assert r0["results"] == r1["results"]
    expected = dict(jres, after_second=jres["bf_count"])
    assert r0["results"] == expected
    assert all(r0["results"]["bf_hits"][:1000])
    assert abs(r0["results"]["hll_count"] - 20_000) / 20_000 < 0.05
    assert r0["results"]["bs_card"] == len(range(0, 4096, 7))
    assert r0["backend"] == r1["backend"] == "gloo"
    assert r0["devices"] == r1["devices"] == ["cpu"]


def test_lockstep_snapshots_equal_the_reference(pair):
    out, _, _ = pair
    jmeta, jpools = _snapshot(out / "jax")
    for pid in (0, 1):
        meta, pools = _snapshot(out / f"p{pid}")
        assert meta == jmeta
        assert pools.keys() == jpools.keys()
        for k in jpools:
            assert pools[k].dtype == jpools[k].dtype and pools[k].shape == jpools[k].shape
            assert pools[k].tobytes() == jpools[k].tobytes(), (pid, k)


def test_lockstep_guards(pair):
    _, reports, _ = pair
    for r in reports:
        assert r["guards"] == {
            "nearcache_locked_off": True, "nearcache_enabled": False,
            "coalescer": False, "owns_group": True,
            "second_owns_group": False, "second_snapshotter": False,
            "snapshot_warning": True, "group_destroyed": True,
        }


def test_coalescing_is_refused_before_joining():
    import torch.distributed as dist

    cfg = rt.Config().use_gpu_sketch(device="cpu", num_shards=8,
                                     coordinator_address="127.0.0.1:1",
                                     num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="coalesce=False"):
        rt.create(cfg)
    assert not dist.is_initialized()


def test_sharded_executor_needs_the_group():
    from redisson_tpu_torch.executor.sharded_executor import ShardedTorchCommandExecutor

    cfg = rt.Config().use_gpu_sketch(device="cpu", num_shards=8, num_processes=2)
    with pytest.raises(RuntimeError, match="no torch.distributed group"):
        ShardedTorchCommandExecutor(cfg)


@pytest.fixture
def p21_cpu(monkeypatch):
    """chip_smoke's phases 20 and 21 at a small size on the CPU; 20a (phase
    3's plan at 8 shards) is left out here, K1's plain version counted as
    launches, one torch thread in the 21b children."""
    import chip_smoke as cs
    from redisson_tpu_torch.ops import cms_seq

    for name in ("P20_DEVICE", "P21_DEVICE"):
        monkeypatch.setattr(cs, name, "cpu")
    monkeypatch.setattr(cs, "P20", dict(
        cs.P20, nbits=1 << 20, bs_ops=1 << 14, bloom_keys=1 << 16, bloom_chunk=1 << 14,
        outside=1 << 14, hll_keys=1 << 15, cms_events=1 << 17, mbit_threshold_words=1 << 12))
    monkeypatch.setattr(cs, "P21", dict(
        cs.P21, bloom_keys=1 << 16, bloom_chunk=1 << 14, outside=1 << 14, hll_keys=1 << 15,
        nbits=1 << 20, bs_ops=1 << 14, mbit_threshold_words=1 << 12, bitop_bits=1 << 16,
        bitop_ops=1 << 12, x_bs_bits=1 << 12, child_timeout_s=DEADLINE_S))
    monkeypatch.setattr(cs, "p20a_tenants", lambda client, rng: {
        "ops_per_s": None, "phase3_ops_per_s": None})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    plain = cms_seq.cms_update_estimate_seq

    def counted(*a, **k):
        cms_seq.LAUNCHES += 1
        return plain(*a, **k)

    monkeypatch.setattr(cms_seq, "cms_update_estimate_seq", counted)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    return cs


def test_chip_smoke_phases_20_and_21_on_the_cpu(p21_cpu):
    """Phase 21's checks at a small size: 21a on four CPU placements equal
    to phase 20's one placement row for row, BITOP across placements, the
    8 -> 4 -> 1 reshard and K1's two launches on the carried CMS; 21b's
    two gloo children equal to each other, the one-process client and
    golden, with equal snapshots."""
    from redisson_tpu_torch.ops import cms_seq

    cs = p21_cpu
    p20 = cs.phase_sharded(0, "cpu")
    cms_seq.LAUNCHES = 0
    out = cs.phase_multidevice(0, p20, "cpu")
    assert cms_seq.LAUNCHES == out["k1_launches"] == 2
    assert out["placements_on"] == ["cpu"] * 4 and out["backend"] == "gloo"
