"""The JAX package's read-replication suite, run again on the port:
``tests/test_replication.py`` (a hot Bloom filter copied to every shard;
reads rotate, writes broadcast) and
``tests/test_overload.py::test_replication_fence_shadows_ambient_deadline``.

``port_namespace`` (``tests/test_torch_cluster.py``) rebinds each
reference module to the port (``PortConfig``: ``device="cpu"``,
``use_tpu_sketch`` read as ``use_gpu_sketch``); the overload module's
``make_client`` builds a ``RedissonTpuClient``, which the port names
``RedissonTorchClient``, so it is replaced by ``_overload_client`` with
the same settings.  Every method of ``test_replication.py`` runs; none is
skipped.
"""

import pytest

torch = pytest.importorskip("torch")

import redisson_tpu_torch as rt  # noqa: E402
import test_overload as _ref_ovl  # noqa: E402
import test_replication as _ref_repl  # noqa: E402
from test_torch_cluster import port_namespace  # noqa: E402
from test_torch_grid_coordination import PortConfig  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


globals().update(port_namespace(_ref_repl))


def _overload_client(**tpu_kw):
    """``tests/test_overload.py``'s ``make_client`` on the port."""
    tpu_kw.setdefault("batch_window_us", 100)
    tpu_kw.setdefault("breaker_failure_threshold", 10_000)
    cfg = PortConfig().use_gpu_sketch(**tpu_kw)
    cfg.retry_attempts = 2
    cfg.retry_interval_ms = 5
    return rt.create(cfg)


test_replication_fence_shadows_ambient_deadline = port_namespace(
    _ref_ovl, extra={"make_client": _overload_client},
)["test_replication_fence_shadows_ambient_deadline"]
