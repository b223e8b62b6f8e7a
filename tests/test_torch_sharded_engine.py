"""The JAX package's sharded-engine suites, run again on the port:
``tests/test_sharded_engine.py`` (coalesced and direct clients at 8
shards) and ``tests/test_mbit_sharded.py`` (m-sharded giant BitSets).

``port_namespace`` (``tests/test_torch_cluster.py``) rebinds each
reference module — its tests, fixtures and helpers — to the port, so a
body that builds ``Config().use_tpu_sketch(num_shards=8)`` gets the
port's sharded engine on the CPU (``PortConfig``: ``device="cpu"``,
``use_tpu_sketch`` read as ``use_gpu_sketch``).  Every method of both
suites runs; none is skipped.
"""

import pytest

torch = pytest.importorskip("torch")

import test_mbit_sharded as _ref_mbit  # noqa: E402
import test_sharded_engine as _ref_sharded  # noqa: E402
from test_torch_cluster import port_namespace  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


globals().update(port_namespace(_ref_sharded))
globals().update(port_namespace(_ref_mbit))
