"""Kernel K1 on the card against its plain PyTorch version: bit-identical
tables and estimates.  Needs a CUDA device and nvcc; run with
``pytest -m gpu tests/test_torch_gpu.py`` on the machine with the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from redisson_tpu_torch.ops import _build, cms_seq  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels run only there)")
    return torch.device("cuda")


# (d, w, B, stream, pool words before the table)
_CASES = {
    "small": (4, 4096, 1000, "zipf", 0),
    "main_path": (5, 65536, 32768, "zipf", 0),
    "one_op": (5, 65536, 1, "zipf", 0),
    "33_ops": (5, 65536, 33, "zipf", 0),
    "ragged_last_tile": (3, 10_007, 5000, "zipf", 0),
    "one_key": (5, 65536, 32768, "one_key", 0),
    "uniform": (5, 65536, 32768, "uniform", 0),
    "weights_wrap": (5, 65536, 32768, "wrap", 0),
    "pool_view": (5, 65536, 32768, "zipf", 4 * 65536 * 5 + 128),
    "8_mib": (2, 1 << 20, 32768, "zipf", 0),
}


def _inputs(d, w, B, stream, rng):
    if stream == "one_key":
        keys = np.full(B, 12345)
    elif stream == "uniform":
        keys = rng.integers(0, 1 << 30, B)
    else:
        keys = rng.zipf(1.2, B) % 100_000
    h1 = (keys * 2654435761 % w).astype(np.uint32)
    h2 = (keys * 40503 % w).astype(np.uint32)
    wt = (rng.random(B) < 0.9).astype(np.uint32)
    table = rng.integers(0, 1 << 20, d * w).astype(np.uint32)
    if stream == "wrap":
        wt = rng.integers(0, 1 << 32, B, dtype=np.uint64).astype(np.uint32)
        table = rng.integers(0, 1 << 32, d * w, dtype=np.uint64).astype(np.uint32)
    return table, h1, h2, wt


@pytest.mark.parametrize("case", list(_CASES))
def test_k1_matches_plain_version(cuda, case):
    d, w, B, stream, before_words = _CASES[case]
    rng = np.random.default_rng(B + d)
    table, h1, h2, wt = _inputs(d, w, B, stream, rng)
    pool = rng.integers(0, 1 << 32, before_words + d * w + 96, dtype=np.uint64).astype(np.uint32)
    pool[before_words : before_words + d * w] = table
    cols = [torch.from_numpy(a.view(np.int32).copy()) for a in (pool, h1, h2, wt)]
    plain_pool = cols[0].clone()
    view = slice(before_words, before_words + d * w)
    plain_est = cms_seq.cms_seq_plain(plain_pool[view], *cols[1:], d=d, w=w)
    dev = [c.to(cuda) for c in cols]
    before = cms_seq.LAUNCHES
    est = cms_seq.cms_update_estimate_seq(dev[0][view], *dev[1:], d=d, w=w)
    torch.cuda.synchronize()
    assert cms_seq.LAUNCHES == before + 1
    assert torch.equal(dev[0].cpu(), plain_pool)  # words around the view unchanged
    assert torch.equal(est.cpu(), plain_est)


def test_k1_shared_memory_matches_plan(cuda):
    lib = _build.load("cms_seq", cms_seq._bind)
    for d, w in ((5, 65536), (2, 1 << 20), (3, 10_007), (1, 1)):
        plan = cms_seq._plan(d, w)
        assert lib.cms_seq_smem_bytes(plan.tile_w) == plan.smem
