"""Hashing of the torch port against the JAX package: murmur3_x86_128 and
the exact 64-bit ``h mod m`` must be bit-identical to
``redisson_tpu.utils.hashing.hash128_np`` + ``km_reduce_mod``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from redisson_tpu.utils import hashing as jh  # noqa: E402
from redisson_tpu_torch import codecs as tcodecs  # noqa: E402
from redisson_tpu_torch.ops import fastpath  # noqa: E402
from redisson_tpu_torch.utils import hashing as th  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The tests run several pytest workers side by side; one intra-op
    # thread per worker avoids oversubscribing the CPU.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dev(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _keys(rng, n, lo=0, hi=41):
    return [rng.bytes(int(k)) for k in rng.integers(lo, hi, n)]


@pytest.mark.parametrize("lengths", [(0, 1), (1, 17), (15, 17), (0, 41), (32, 33)])
def test_murmur_torch_matches_host(lengths):
    rng = np.random.default_rng(sum(lengths))
    blocks, lens = jh.encode_bytes_batch(_keys(rng, 400, *lengths))
    ref = jh.murmur3_x86_128(blocks, lens)
    got = th.murmur3_x86_128_torch(_dev(blocks), _dev(lens))
    for r, g in zip(ref, got):
        assert np.array_equal(g.numpy(), r.astype(np.int64))


def test_host_path_copy_matches_reference():
    rng = np.random.default_rng(7)
    items = _keys(rng, 300)
    b_ref, l_ref = jh.encode_bytes_batch(items)
    b, l = th.encode_bytes_batch(items)
    assert np.array_equal(b, b_ref) and np.array_equal(l, l_ref)
    for r, g in zip(jh.hash128_np(b_ref, l_ref), th.hash128_np(b, l)):
        assert np.array_equal(r, g)
    keys = rng.integers(0, 2**63, 500, dtype=np.uint64)
    for r, g in zip(jh.encode_uint64_batch(keys), th.encode_uint64_batch(keys)):
        assert np.array_equal(r, g)
    # The codec copy encodes exactly like the reference's.
    from redisson_tpu import codecs as jcodecs

    objs = ["a", "bcd", 5, ("t", 1)]
    for r, g in zip(jcodecs.encode_batch(jcodecs.DEFAULT_CODEC, objs),
                    tcodecs.encode_batch(tcodecs.DEFAULT_CODEC, objs)):
        assert np.array_equal(r, g)


@pytest.mark.parametrize(
    "m", [1, 2, 3, 1000, 95_851, 9_585_059, (1 << 31) - 1, 1 << 31]
)
def test_mod_m_matches_km_reduce(m):
    rng = np.random.default_rng(m % 1000)
    blocks, lens = jh.encode_bytes_batch(_keys(rng, 300))
    H1, H2 = jh.hash128_np(blocks, lens)
    r1, r2 = jh.km_reduce_mod(H1, H2, m)
    h1m, h2m = fastpath.hash_km_device(_dev(blocks), _dev(lens), m, blocks.shape[1])
    assert np.array_equal(h1m.numpy(), r1.astype(np.int64))
    assert np.array_equal(h2m.numpy(), r2.astype(np.int64))
    assert np.array_equal(np.stack(th.km_reduce_mod(H1, H2, m)), np.stack((r1, r2)))


def test_per_op_m_and_extreme_words():
    rng = np.random.default_rng(3)
    hi = rng.integers(0, 1 << 32, 2000, dtype=np.uint64)
    lo = rng.integers(0, 1 << 32, 2000, dtype=np.uint64)
    hi[:4] = lo[:4] = (1 << 32) - 1
    m = rng.integers(1, (1 << 31) + 1, 2000, dtype=np.uint64)
    m[:2] = 1 << 31
    want = ((hi << np.uint64(32)) | lo) % m
    got = th.mod64(torch.from_numpy(hi.astype(np.int64)),
                   torch.from_numpy(lo.astype(np.int64)),
                   torch.from_numpy(m.astype(np.int64)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_trimmed_lanes_rebuild_the_same_hash():
    """The executor trims all-zero trailing lanes before the copy; the
    lane count is hash input, so pad_lanes must restore it."""
    keys = np.arange(1000, dtype=np.uint64) * np.uint64(2654435761)
    blocks, lens = jh.encode_uint64_batch(keys)
    wide = np.zeros((blocks.shape[0], 8), np.uint32)  # a 2-block batch
    wide[:, :4] = blocks
    ref = jh.murmur3_x86_128(wide, lens)
    trimmed = _dev(wide[:, :2])
    got = th.murmur3_x86_128_torch(fastpath.pad_lanes(trimmed, 8), _dev(lens))
    for r, g in zip(ref, got):
        assert np.array_equal(g.numpy(), r.astype(np.int64))
