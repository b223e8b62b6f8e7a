"""Key lanes on the host as 8-byte words: the LongCodec encoder and the
executor's staging of key blocks.

* ``encode_uint64_batch`` is byte-identical to the JAX package's on edge
  keys, negative int64 input, empty and one-key batches and random keys,
  and returns a C-contiguous ``uint32[B, 4]``.
* ``_trim_lanes`` + ``_fill_blocks`` stage, after ``fastpath.pad_lanes``
  to the block's lane count, exactly the lanes that the frozen copy of
  the lane-by-lane pair below staged (trimming may stop at a whole lane
  pair, so more all-zero lanes may ship): every lane count, trailing
  all-zero pairs, an odd lane alone nonzero, padding to the bucket,
  misaligned staging offsets and the narrow fallback.
* The keyed Bloom and HLL executor paths, one device and sharded, equal
  the JAX package's executors on those shapes.
* ``rtpu_lane_staging_total`` counts each staged key block by path.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import redisson_tpu  # noqa: E402
import redisson_tpu_torch as rt  # noqa: E402
from redisson_tpu.codecs import LongCodec as JaxLongCodec  # noqa: E402
from redisson_tpu.utils import hashing as jh  # noqa: E402
from redisson_tpu_torch.codecs import LongCodec, encode_batch  # noqa: E402
from redisson_tpu_torch.executor import torch_executor as tx  # noqa: E402
from redisson_tpu_torch.ops import fastpath  # noqa: E402
from redisson_tpu_torch.utils import hashing as th  # noqa: E402
from test_torch_bloom_ops import K, MS, _executors, _pool, _runs  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the encoder -----------------------------------------------------------------

_ENCODE_CASES = {
    "edges": np.array([0, 2**32 - 1, 2**63, 2**64 - 1], np.uint64),
    "negative_int64": np.array([-1, -(2**63), -(2**32), -12345, 7], np.int64),
    "empty": np.zeros(0, np.uint64),
    "one": np.array([0x0123456789ABCDEF], np.uint64),
    "random": np.random.default_rng(11).integers(0, 2**63, 4099, dtype=np.uint64)
    * np.uint64(3),
}


@pytest.mark.parametrize("case", sorted(_ENCODE_CASES))
def test_encode_uint64_batch_matches_jax(case):
    keys = _ENCODE_CASES[case]
    blocks, lengths = th.encode_uint64_batch(keys)
    ref_blocks, ref_lengths = jh.encode_uint64_batch(keys)
    assert blocks.dtype == np.uint32 and blocks.shape == (len(keys), 4)
    assert blocks.flags.c_contiguous
    assert blocks.tobytes() == ref_blocks.tobytes()
    assert lengths.dtype == ref_lengths.dtype
    assert lengths.tobytes() == ref_lengths.tobytes()
    # The codec's fast path (an int64 array is taken as its uint64 bits).
    cb, cl = encode_batch(LongCodec(), keys)
    assert cb.tobytes() == ref_blocks.tobytes() and cl.tobytes() == ref_lengths.tobytes()


# -- the staging ------------------------------------------------------------------


def _frozen_fill_blocks(buf, off, n_pad, blocks):
    """The lane-by-lane copy the staging used before 8-byte words."""
    B, L = blocks.shape
    view = buf[off : off + n_pad * L].reshape(n_pad, L)
    view[:B] = blocks
    view[B:] = 0
    return off + n_pad * L


def _frozen_trim_lanes(blocks):
    """The lane-by-lane trim the staging used before 8-byte words."""
    L = blocks.shape[1]
    used = L
    while used > 1 and not np.any(blocks[:, used - 1]):
        used -= 1
    return blocks[:, :used], L


def _keys(rng, B, lo, hi, zero_from=None):
    """Byte keys of lengths in [lo, hi]; bytes from ``zero_from`` on are
    zero, so trailing lanes inside the keys' lengths are all zero."""
    items = []
    for n in rng.integers(lo, hi + 1, B):
        b = bytearray(rng.bytes(int(n)))
        if zero_from is not None:
            b[zero_from:] = bytes(max(0, len(b) - zero_from))
        items.append(bytes(b))
    return jh.encode_bytes_batch(items)


def _block(case, rng, B):
    """(blocks, lengths, expected path) of a staging case."""
    if case == "L4_long":  # LongCodec keys: lanes 2-3 zero
        blocks, lens = jh.encode_uint64_batch(rng.integers(0, 2**63, B, dtype=np.uint64))
        return blocks, lens, "wide"
    if case == "L4_odd_lane":  # keys below 2**32: lane 0 alone nonzero
        blocks, lens = jh.encode_uint64_batch(rng.integers(1, 2**32, B, dtype=np.uint64))
        return blocks, lens, "wide"
    if case == "L8_odd_lane":  # 17-20 bytes: lane 4 alone nonzero past 0-3
        return (*_keys(rng, B, 17, 20), "wide")
    if case == "L8_zero_pairs":  # 17-24 bytes, zero from byte 16: lanes 4-7 zero
        return (*_keys(rng, B, 17, 24, zero_from=16), "wide")
    if case == "L12_odd_lane":  # 33-36 bytes: lane 8 the last nonzero
        return (*_keys(rng, B, 33, 36), "wide")
    if case == "L12_zero_pairs":  # 33-48 bytes, zero from byte 8: lanes 2-11 zero
        return (*_keys(rng, B, 33, 48, zero_from=8), "wide")
    if case == "L12_full":  # 41-48 bytes: nothing to trim
        return (*_keys(rng, B, 41, 48), "wide")
    if case == "L8_fortran":  # not C-contiguous: the narrow fallback
        blocks, lens = _keys(rng, B, 17, 20)
        return np.asfortranarray(blocks), lens, "narrow"
    if case == "L8_lane_strided":  # lanes 8 bytes apart: narrow
        blocks, lens = _keys(rng, B, 17, 20)
        return np.repeat(blocks, 2, axis=1)[:, ::2], lens, "narrow"
    if case == "L3_odd_count":  # a lane count without pairs: narrow
        blocks, lens = _keys(rng, B, 1, 12)
        return np.ascontiguousarray(blocks[:, :3]), np.minimum(lens, 12), "narrow"
    raise KeyError(case)


_STAGING_CASES = (
    "L4_long", "L4_odd_lane", "L8_odd_lane", "L8_zero_pairs", "L12_odd_lane",
    "L12_zero_pairs", "L12_full", "L8_fortran", "L8_lane_strided", "L3_odd_count",
)


class _Counts:
    """A registry family stand-in for ``obs.lane_staging``."""

    def __init__(self):
        self.lane_staging = self
        self.seen = []

    def inc(self, labels, n=1):
        self.seen.append(labels)


def _staged(trim, fill, blocks, B, Bp, off):
    """Stage ``blocks`` at ``off`` of a poisoned buffer; the shipped
    lanes restored to the block's lane count as the kernels see them."""
    trimmed, L = trim(blocks)
    Lt = trimmed.shape[1]
    buf = np.full(off + Bp * Lt + 3, 0xA5A5A5A5, np.uint32)
    end = fill(buf, off, Bp, trimmed)
    assert end == off + Bp * Lt
    assert np.all(buf[:off] == 0xA5A5A5A5) and np.all(buf[end:] == 0xA5A5A5A5)
    lanes = torch.from_numpy(buf[off:end].view(np.int32).reshape(Bp, Lt).copy())
    return fastpath.pad_lanes(lanes, L).numpy().view(np.uint32), Lt


@pytest.mark.parametrize("off", [0, 1, 2, 3])
@pytest.mark.parametrize("case", _STAGING_CASES)
def test_staged_lanes_match_the_lane_by_lane_pair(case, off):
    rng = np.random.default_rng(len(case) * 7 + off)
    B, Bp = 37, 64  # B < Bp: the padded ops' lanes are zero
    blocks, _, path = _block(case, rng, B)
    ref, ref_Lt = _staged(_frozen_trim_lanes, _frozen_fill_blocks, blocks, B, Bp, off)
    counts = _Counts()
    got, Lt = _staged(lambda b: tx._trim_lanes(b, counts), tx._fill_blocks,
                      blocks, B, Bp, off)
    assert np.array_equal(got, ref)
    assert np.array_equal(ref[:B], blocks) and not ref[B:].any()
    assert counts.seen == [(path,)]
    if path == "wide":  # whole pairs: at most one all-zero lane more
        assert Lt % 2 == 0 and Lt - ref_Lt in (0, 1)
    else:
        assert Lt == ref_Lt


# -- the keyed executor paths against the JAX package -------------------------------

_EXEC_CASES = ("L4_long", "L4_odd_lane", "L8_odd_lane", "L8_zero_pairs",
               "L12_odd_lane", "L12_zero_pairs", "L8_fortran", "L8_lane_strided")


@pytest.mark.parametrize("case", _EXEC_CASES)
def test_keyed_bloom_paths_match_jax_executor(case):
    """bloom_mixed_keys_runs, bloom_mixed_keys and bloom_contains_keys_st
    on one device: results and pools equal to the JAX executor's."""
    rng = np.random.default_rng(sum(map(ord, case)))
    sizes = rng.integers(1, 60, 7)
    rows, m, flags, starts = _runs(rng, sizes, rng.random(7) < 0.5)
    B = int(starts[-1])
    blocks, lengths, _ = _block(case, rng, B)
    (jex, jpool), (tex, tpool) = _executors()
    seed_state = _pool(rng, tenants=8)
    jex.state_from_host(jpool, seed_state)
    tex.state_from_host(tpool, seed_state)
    j = jex.bloom_mixed_keys_runs(jpool, K, blocks, lengths, rows, m, flags, starts)
    t = tex.bloom_mixed_keys_runs(tpool, K, blocks, lengths, rows, m, flags, starts)
    assert np.array_equal(t.result(), j.result())
    counts = np.diff(starts)
    op_rows, op_m = np.repeat(rows, counts), np.repeat(m, counts)
    is_add = rng.random(B) < 0.5
    j = jex.bloom_mixed_keys(jpool, op_rows, op_m, K, blocks, lengths, is_add)
    t = tex.bloom_mixed_keys(tpool, op_rows, op_m, K, blocks, lengths, is_add)
    assert np.array_equal(t.result(), j.result())
    j = jex.bloom_contains_keys_st(jpool, 1, MS[1], K, blocks, lengths)
    t = tex.bloom_contains_keys_st(tpool, 1, MS[1], K, blocks, lengths)
    assert np.array_equal(t.result(), j.result())
    assert np.array_equal(tex.state_to_host(tpool), jex.state_to_host(jpool))


def _sharded_pair():
    def port():
        cfg = rt.Config().set_codec(LongCodec())
        cfg.use_gpu_sketch(device="cpu", num_shards=4, min_bucket=64, coalesce=False)
        return rt.create(cfg)

    def ref():
        return redisson_tpu.create(redisson_tpu.Config().set_codec(JaxLongCodec())
                                   .use_tpu_sketch(num_shards=4, min_bucket=64,
                                                   coalesce=False))
    return ref(), port()


@pytest.mark.parametrize("case", ["L4_long", "L8_odd_lane", "L12_zero_pairs",
                                  "L8_fortran"])
def test_sharded_keyed_bloom_and_hll_match_jax(case):
    """The sharded executor's keyed Bloom (per-op rows) and HLL paths on
    four logical shards: results and every object's row equal to the
    JAX package's sharded executor's."""
    rng = np.random.default_rng(sum(map(ord, case)) + 1)
    jc, tc = _sharded_pair()
    try:
        B = 301
        blocks, lengths, _ = _block(case, rng, B)
        is_add = rng.random(B) < 0.5
        out = []
        for c in (jc, tc):
            names = [f"bf{i}" for i in range(5)]
            for i, name in enumerate(names):
                c.get_bloom_filter(name).try_init(2000 + 500 * i, 0.01)
            c.get_hyper_log_log("hl").add_all(np.arange(3, dtype=np.uint64))
            eng = c._engine
            entries = [eng.registry.lookup(n) for n in names]
            pick = np.random.default_rng(3).integers(0, len(entries), B)
            rows = np.array([entries[i].row for i in pick], np.int32)
            m_arr = np.array([entries[i].params["size"] for i in pick], np.uint32)
            k = entries[0].params["hash_iterations"]
            ex = eng.executor
            res = ex.bloom_mixed_keys(entries[0].pool, rows, m_arr, k, blocks,
                                      lengths, is_add).result()
            hl = eng.registry.lookup("hl")
            changed = ex.hll_add_keys_single(hl.pool, hl.row, blocks, lengths).result()
            row_bytes = [np.asarray(ex.read_row(e.pool, e.row)).tobytes()
                         for e in entries + [hl]]
            out.append((np.asarray(res), bool(changed), row_bytes))
        (jr, jch, jrows), (tr, tch, trows) = out
        assert np.array_equal(tr, jr)
        assert tch == jch
        assert trows == jrows
    finally:
        jc.shutdown()
        tc.shutdown()


# -- the counter ------------------------------------------------------------------


def test_lane_staging_counter_counts_each_staged_block():
    """A LongCodec bulk contains stages its keys as 8-byte words and
    counts ``wide`` once per launch; a non-contiguous block counts
    ``narrow``."""
    cfg = rt.Config().set_codec(LongCodec())
    cfg.use_gpu_sketch(device="cpu", min_bucket=64)
    c = rt.create(cfg)
    try:
        fam = c.obs.registry.family("rtpu_lane_staging_total")
        bf = c.get_bloom_filter("lanes")
        bf.try_init(100_000, 0.01)
        keys = np.random.default_rng(5).integers(0, 2**63, 5000, dtype=np.uint64)
        launches = c.obs.dispatches.get(("bloom_mixed_keys_runs",))
        assert bf.contains_all(keys) >= 0
        n_runs = c.obs.dispatches.get(("bloom_mixed_keys_runs",)) - launches
        assert n_runs >= 1
        assert dict(fam.items()).keys() == {("wide",)}
        assert fam.get(("wide",)) == n_runs
        entry = c._engine.registry.lookup("lanes")
        blocks, lengths = th.encode_uint64_batch(keys[:100])
        c._engine.executor.bloom_mixed_keys(
            entry.pool, np.full(100, entry.row, np.int32),
            np.full(100, entry.params["size"], np.uint32),
            entry.params["hash_iterations"], np.asfortranarray(blocks),
            lengths, np.zeros(100, bool)).result()
        assert fam.get(("narrow",)) == 1 and fam.get(("wide",)) == n_runs
    finally:
        c.shutdown()
