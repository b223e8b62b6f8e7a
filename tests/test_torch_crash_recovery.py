"""Kill -9 crash soaks on the port (the counterpart of the JAX package's
``tests/test_crash_recovery.py`` and of the two residency recovery tests
of ``tests/test_residency.py``), on the CPU.

A child process (``python -m redisson_tpu_torch.chaos.crashchild
--device cpu``) takes acked writes from the deterministic op stream and
is SIGKILLed mid-stream; a fresh client recovers the directories
(snapshot restore, journal replay, writeback), and its rows must equal a
journal-less golden client fed some prefix R of the same stream:

- ``appendfsync always``: R covers every ACK (no acked write is lost);
- ``appendfsync everysec``: R covers every write acked more than the
  loss window before the kill.

Deterministic: the seeds are a fixed list, and the kill lands after an
ack count drawn from ``random.Random(seed)`` (never a wall-clock sleep).
"""

import os
import random
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu_torch as rt  # noqa: E402
from redisson_tpu_torch.chaos import crashchild  # noqa: E402
from redisson_tpu_torch.codecs import LongCodec  # noqa: E402
from redisson_tpu_torch.storage.residency import DISK  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# everysec: the writer fsyncs at most ~1 s apart; slack for a loaded box
# (the check is the POLICY bound, not disk speed).
LOSS_WINDOW_S = 2.5
OPS = 300
SEEDS = (0, 1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Matched(Exception):
    def __init__(self, r):
        self.r = r


def _run_child(tmp, fsync, seed, kill_at, *extra):
    """Spawn the soak child, collect its ACK lines, SIGKILL it right
    after ack ``kill_at``.  Returns (acked {index: unix_ts}, kill_time)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(
        [sys.executable, "-m", "redisson_tpu_torch.chaos.crashchild",
         "--dir", str(tmp), "--fsync", fsync, "--seed", str(seed),
         "--ops", str(OPS), "--device", "cpu", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        cwd=_REPO, env=env, text=True,
    )
    acked, kill_time = {}, None
    try:
        for line in proc.stdout:
            parts = line.split()
            if len(parts) == 3 and parts[0] == "ACK":
                acked[int(parts[1])] = float(parts[2])
                if int(parts[1]) >= kill_at:
                    break
            elif line.strip() == "DONE":
                break
        kill_time = time.time()
        os.kill(proc.pid, signal.SIGKILL)
        for line in proc.stdout:  # complete lines already in the pipe
            parts = line.split()
            if len(parts) == 3 and parts[0] == "ACK":
                acked[int(parts[1])] = float(parts[2])
    finally:
        proc.stdout.close()
        proc.wait(timeout=60)
    return acked, kill_time


def _rows(client) -> dict:
    """Each object's state by name: its row, or its mirror's encoding
    when it rests on the host or disk tier."""
    eng = client._engine
    eng._drain()
    return {
        e.name: np.asarray(eng._host_row(e)).copy()
        for e in eng.registry.entries()
    }


def _recovered_rows(tmp, fsync, residency=False):
    client = crashchild.build_client(str(tmp), fsync, residency=residency, device="cpu")
    eng = client._engine
    try:
        return _rows(client), eng.obs.journal_replayed.get(())
    finally:
        # Tear down without snapshotting over the evidence.
        eng.config.snapshot_dir = None
        client.config.snapshot_dir = None
        j, eng.journal = eng.journal, None
        if j is not None:
            j.close()
        client.shutdown()


def _match_prefix(seed, target, start_r):
    """R in [start_r, OPS] with golden(R ops) == target, by driving a
    journal-less port client through the same stream; None if none."""
    cfg = rt.Config().set_codec(LongCodec()).use_gpu_sketch(device="cpu", min_bucket=64)
    golden = rt.create(cfg)

    def same():
        got = _rows(golden)
        return set(got) == set(target) and all(
            np.array_equal(got[n], target[n]) for n in got
        )

    def ack(i):
        if i + 1 >= start_r and same():
            raise _Matched(i + 1)

    try:
        if start_r <= 0 and same():
            return 0
        crashchild.apply_ops(golden, seed, OPS, ack=ack)
        return None
    except _Matched as m:
        return m.r
    finally:
        golden.shutdown()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fsync", ["always", "everysec"])
def test_kill9_soak_recovers_acked_prefix(tmp_path, fsync, seed):
    kill_at = random.Random(seed).randrange(40, OPS - 20)
    acked, kill_time = _run_child(tmp_path, fsync, seed, kill_at)
    assert acked and max(acked) >= kill_at, "child never reached its kill point"
    rows, replayed = _recovered_rows(tmp_path, fsync)
    assert rows, "recovery produced an empty keyspace"
    assert replayed > 0, "no snapshot was taken: recovery must replay the journal"
    if fsync == "always":
        # Every acked write survives: golden(R) for some R covering all
        # acks (accepted-but-unacked ops may ride along).
        lower = max(acked) + 1
    else:
        covered = [i for i, ts in acked.items() if ts <= kill_time - LOSS_WINDOW_S]
        lower = (max(covered) + 1) if covered else 0
    r = _match_prefix(seed, rows, lower)
    assert r is not None, (
        f"recovered state matches NO prefix >= {lower} of the op stream "
        f"(max_acked={max(acked)}, replayed={replayed})"
    )
    assert lower <= r <= OPS


def test_kill9_with_midstream_snapshot(tmp_path):
    """The child snapshots every 50 ops (retiring covered segments) and
    dies past two cuts: recovery = the last snapshot + the remaining tail
    still restores every acked write."""
    acked, _ = _run_child(tmp_path, "always", 2, 120, "--snapshot-every", "50")
    assert max(acked) >= 120
    snap = tmp_path / "snap" / "sketch_meta.json"
    assert snap.exists()
    rows, _ = _recovered_rows(tmp_path, "always")
    assert _match_prefix(2, rows, max(acked) + 1) is not None, \
        "acked write lost across snapshot truncation"


def test_kill9_residency_soak_recovers_bit_identical(tmp_path):
    """Forced demote / spill / promote every 25 ops; the SIGKILL can land
    mid-transition, and recovery restores a golden prefix covering every
    ack, whatever tier each object died in."""
    acked, _ = _run_child(tmp_path, "always", 3, 160, "--residency-every", "25")
    assert max(acked) >= 160
    rows, _ = _recovered_rows(tmp_path, "always", residency=True)
    assert _match_prefix(3, rows, max(acked) + 1) is not None


# -- the residency recovery cases of the JAX package's test_residency.py ---------


def _mk_durable(tmp_path):
    cfg = rt.Config().use_gpu_sketch(
        device="cpu", min_bucket=64, batch_window_us=100,
        residency_dir=str(tmp_path / "blobs"),
    )
    cfg.snapshot_dir = str(tmp_path / "snap")
    cfg.journal_dir = str(tmp_path / "journal")
    cfg.journal_fsync = "always"
    cfg.retry_attempts = 2
    cfg.retry_interval_ms = 5
    return rt.create(cfg)


def test_mixed_tier_recovery_bit_identical(tmp_path):
    """A DEVICE + HOST + DISK population snapshots, takes post-snapshot
    journaled writes on every tier, and a fresh engine recovers every
    object bit-identically — the untouched DISK sketch restoring as DISK,
    the touched ones receiving their replayed mirror."""
    cl = _mk_durable(tmp_path)
    eng = cl._engine
    rm = eng.residency
    for n in ("dev", "host", "disk", "disk-idle"):
        bf = cl.get_bloom_filter(n)
        bf.try_init(1000, 0.01)
        bf.add_all([1, 2])
    assert rm.demote("host")
    assert rm.demote("disk") and rm.spill("disk")
    assert rm.demote("disk-idle") and rm.spill("disk-idle")
    eng.snapshot(str(tmp_path / "snap"))
    cl.get_bloom_filter("dev").add(10)
    cl.get_bloom_filter("host").add(20)
    cl.get_bloom_filter("disk").add(30)  # loads → HOST, journaled
    truth = {n: np.asarray(eng._host_row(eng.registry.lookup(n))).copy()
             for n in ("dev", "host", "disk", "disk-idle")}
    j, eng.journal = eng.journal, None  # abandon: no shutdown snapshot
    j.close()
    eng.config.snapshot_dir = None
    cl.config.snapshot_dir = None
    cl.shutdown()

    cl2 = _mk_durable(tmp_path)
    try:
        eng2 = cl2._engine
        e_idle = eng2.registry.lookup("disk-idle")
        assert e_idle.residency == DISK and e_idle.row < 0
        for n, want in truth.items():
            got = np.asarray(eng2._host_row(eng2.registry.lookup(n)))
            assert np.array_equal(got, want), n
        assert cl2.get_bloom_filter("disk").contains(30)
        assert cl2.get_bloom_filter("host").contains(20)
        assert cl2.get_bloom_filter("dev").contains(10)
    finally:
        cl2.shutdown()


def test_blob_gc_never_deletes_snapshot_referenced_files(tmp_path):
    cl = _mk_durable(tmp_path)
    try:
        eng = cl._engine
        rm = eng.residency
        bf = cl.get_bloom_filter("bf")
        bf.try_init(1000, 0.01)
        bf.add(1)
        assert rm.demote("bf") and rm.spill("bf")
        blob1 = rm.disk_index()["bf"]["file"]
        eng.snapshot(str(tmp_path / "snap"))  # the snapshot names blob1
        # Load + re-spill: blob1 retires but may NOT be collected (the
        # latest snapshot still names it; a crash would restore from it
        # and replay the tail).
        assert rm.load("bf")
        bf.add(2)
        assert rm.spill("bf")
        blob2 = rm.disk_index()["bf"]["file"]
        assert blob2 != blob1
        rm.gc_blobs()
        assert os.path.exists(os.path.join(rm.directory, blob1))
        eng.snapshot(str(tmp_path / "snap"))  # now blob2 is named
        rm.gc_blobs()
        assert not os.path.exists(os.path.join(rm.directory, blob1))
        assert os.path.exists(os.path.join(rm.directory, blob2))
    finally:
        cl.shutdown()
