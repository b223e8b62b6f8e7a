"""The frozen reference agrees with the port at a tiny size on the CPU.
The test calls the port; the reference does not."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.reference import bitmaps, hashing

import redisson_tpu_torch as rt
from redisson_tpu_torch.codecs import LongCodec
from redisson_tpu_torch.ops import golden
from redisson_tpu_torch.utils import hashing as port_hashing


def _keys(n, seed=3):
    return np.random.default_rng(seed).integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)


@pytest.mark.parametrize("m", [7, 1000, 9_585_059, 401_414_247, 2**31 - 1])
def test_km_pair_equals_the_port(m):
    keys = _keys(20000)
    h1, h2 = port_hashing.km_reduce_mod(
        *port_hashing.hash128_np(*port_hashing.encode_uint64_batch(keys)), m)
    r1, r2 = hashing.km_pair(hashing.to_i64(keys), m)
    assert np.array_equal(h1.astype(np.int64), r1.numpy())
    assert np.array_equal(h2.astype(np.int64), r2.numpy())


@pytest.mark.parametrize("n,p", [(1_000_000, 0.01), (55_000_000, 0.03), (20000, 0.01), (10, 0.5)])
def test_sizes_equal_the_port(n, p):
    m = golden.optimal_num_of_bits(n, p)
    assert hashing.bloom_size(n, p) == (m, golden.optimal_num_of_hash_functions(n, m))


def _client():
    return rt.create(rt.Config().set_codec(LongCodec(unsigned=True)).use_gpu_sketch(device="cpu"))


def _row(client, name):
    eng = client._engine
    eng._drain()
    e = eng.registry.lookup(name)
    return eng.executor.read_row(e.pool, e.row)


def test_bloom_rows_and_answers_equal_the_port():
    client = _client()
    try:
        bf = client.get_bloom_filter("bf")
        assert bf.try_init(20000, 0.01)
        m, k = hashing.bloom_size(20000, 0.01)
        ref = bitmaps.BloomServer(m, k, "cpu")
        keys = _keys(12000)
        for chunk in np.array_split(keys, 3):
            got = bf.add_all_async(chunk).result()
            assert np.array_equal(got, ref.add("bf", chunk).result())
        probe = np.concatenate([keys[:3000], _keys(5000, seed=9)])
        assert np.array_equal(bf.contains_all_async(probe).result(),
                              ref.contains("bf", probe).result())
        row = _row(client, "bf")
        assert bitmaps.bit_mismatches(row, ref.rows["bf"]) == 0
        assert bitmaps.bit_mismatches(row, ~ref.rows["bf"]) > 0
    finally:
        client.shutdown()


def test_bitset_answers_and_row_equal_the_port():
    client = _client()
    try:
        bs = client.get_bit_set("bs")
        nbits = 1 << 18
        bs.set(nbits - 1)
        ref = bitmaps.BitsetServer(nbits, "cpu")
        ref.set("bs", np.asarray([nbits - 1], np.uint32))
        rng = np.random.default_rng(5)
        for i in range(6):
            idx = rng.integers(0, nbits, 5000).astype(np.uint32)  # repeats inside a call
            if i % 2:
                got, want = bs.get_many_async(idx).result(), ref.get("bs", idx).result()
            else:
                got, want = bs.set_many_async(idx).result(), ref.set("bs", idx).result()
            assert np.array_equal(got, want)
        assert bitmaps.bit_mismatches(_row(client, "bs"), ref.bits) == 0
    finally:
        client.shutdown()


def test_controls_break_what_they_say():
    m, k = hashing.bloom_size(20000, 0.01)
    keys = _keys(2000)
    exact, coarse = bitmaps.BloomServer(m, k, "cpu"), bitmaps.BloomServer(m, k, "cpu", "hash32")
    exact.add("f", keys)
    coarse.add("f", keys)
    assert bitmaps.bit_mismatches(coarse.row_words("f"), exact.rows["f"]) > 0
    lost = bitmaps.BitsetServer(1 << 12, "cpu", "lost_update")
    lost.set("b", np.arange(0, 64, dtype=np.uint32))  # two whole words
    assert int(lost.bits.sum()) == 2
    with pytest.raises(ValueError):
        bitmaps.BloomServer(m, k, "cpu", "nope")


def test_pack_and_unpack_are_inverse():
    bits = torch.from_numpy(np.random.default_rng(1).random(1000) < 0.3)
    assert bitmaps.bit_mismatches(bitmaps.pack_words(bits), bits) == 0
