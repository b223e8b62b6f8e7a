"""The port's public ``CountMinSketch`` on the CPU against the benchmark's
plain reference (``portbench/reference/cms.py``), which imports nothing of
the program: a stream of zipf keys through ``add_all_seq`` gives the
reference's table cell for cell (read back through ``dump()``), every
event's estimate at its sequence point, ``total_count()`` equal to the
events, and ``top_k(10)`` the ten keys with the largest true counts where
the gap between the tenth and the eleventh exceeds the sketch's error
bound.  Every geometry has (d w) % 128 = 0, so the engine takes its
sequential path (``cms_seq_plain`` on the CPU)."""

import io
import math
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu_torch as rt  # noqa: E402
from portbench.reference import cms as ref  # noqa: E402
from portbench.reference.hashing import to_i64  # noqa: E402
from redisson_tpu_torch.codecs import LongCodec  # noqa: E402
from test_torch_grid_coordination import _one_torch_thread  # noqa: E402,F401

GEOMETRIES = [(5, 4096), (3, 2048), (7, 128), (5, 65536)]
SEEDS = [0, 2**31 + 7, 99991]
CALL = 2048


def _stream(seed, n_calls, n_keys=3000):
    """Calls of zipf-1.2 uint64 keys: rank r is the key r * odd + salt."""
    rng = np.random.default_rng(seed)
    salt = np.uint64(rng.integers(0, 1 << 62))
    ranks = (rng.zipf(1.2, n_calls * CALL) - 1) % n_keys
    keys = ranks.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15) + salt
    return np.split(keys, n_calls)


def _dumped(handle) -> np.ndarray:
    data = handle.dump()
    (hlen,) = struct.unpack("<I", data[4:8])
    return np.load(io.BytesIO(data[8 + hlen:]), allow_pickle=False)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("d,w", GEOMETRIES)
def test_the_port_streams_as_the_reference_counts(d, w, seed):
    assert (d * w) % 128 == 0
    cl = rt.create(rt.Config().set_codec(LongCodec(unsigned=True))
                   .use_gpu_sketch(device="cpu", nearcache=False))
    try:
        cms = cl.get_count_min_sketch("stream")
        assert cms.try_init(d, w, track_top_k=20)
        table = torch.zeros((d, w), dtype=torch.int64)
        counts: dict = {}
        calls = _stream(seed, 6)
        for i, keys in enumerate(calls):
            got = cms.add_all_seq(keys)
            want = ref.add_seq(table, ref.cells(to_i64(keys), d, w))
            assert np.array_equal(np.asarray(got, np.int64), want.numpy()), i
            for k, n in zip(*np.unique(keys, return_counts=True)):
                counts[k] = counts.get(k, 0) + int(n)
        assert ref.cell_mismatches(_dumped(cms), table) == 0
        n_events = CALL * len(calls)
        assert cms.total_count() == n_events
        top = cms.top_k(10)
        est = ref.estimate(table, ref.cells(to_i64(np.asarray([k for k, _ in top])), d, w))
        assert [c for _, c in top] == est.tolist()
        by_count = sorted(counts.items(), key=lambda kv: -kv[1])
        gap = by_count[9][1] - by_count[10][1]
        if gap > math.e / w * n_events:
            assert {k for k, _ in top} == {k for k, _ in by_count[:10]}
    finally:
        cl.shutdown()


def test_a_repeated_key_counts_up_within_a_call():
    """Five adds of one key read 1 to 5 in the reference as in the port."""
    table = torch.zeros((5, 4096), dtype=torch.int64)
    keys = to_i64(np.full(5, 12345, np.uint64))
    assert ref.add_seq(table, ref.cells(keys, 5, 4096)).tolist() == [1, 2, 3, 4, 5]
    assert int(table.sum()) == 25
