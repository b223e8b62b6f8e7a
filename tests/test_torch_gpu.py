"""Kernel K1 on the card against its plain PyTorch version: bit-identical
tables and estimates.  Needs a CUDA device and nvcc; run with
``pytest -m gpu tests/test_torch_gpu.py`` on the machine with the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from redisson_tpu_torch.ops import cms_seq  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels run only there)")
    return torch.device("cuda")


@pytest.mark.parametrize("d,w,B", [(4, 4096, 1000), (5, 65536, 32768)])
def test_k1_matches_plain_version(cuda, d, w, B):
    rng = np.random.default_rng(B)
    keys = rng.zipf(1.2, B) % 100_000
    h1 = (keys * 2654435761 % w).astype(np.uint32)
    h2 = (keys * 40503 % w).astype(np.uint32)
    wt = (rng.random(B) < 0.9).astype(np.uint32)
    table = rng.integers(0, 1 << 20, d * w).astype(np.uint32)
    cols = [torch.from_numpy(a.view(np.int32).copy()) for a in (table, h1, h2, wt)]
    plain_table = cols[0].clone()
    plain_est = cms_seq.cms_seq_plain(plain_table, *cols[1:], d=d, w=w)
    dev = [c.to(cuda) for c in cols]
    before = cms_seq.LAUNCHES
    est = cms_seq.cms_update_estimate_seq(*dev, d=d, w=w)
    torch.cuda.synchronize()
    assert cms_seq.LAUNCHES == before + 1
    assert torch.equal(dev[0].cpu(), plain_table)
    assert torch.equal(est.cpu(), plain_est)
