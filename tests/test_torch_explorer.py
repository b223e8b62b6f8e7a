"""``tests/test_explorer.py`` on the port's schedule explorer
(``redisson_tpu_torch/analysis/explorer.py``, rebound by
``port_namespace``): the explorer's own contract (lost updates found and
replayed, preemption bounds, deadlock reports, the virtual clock,
cooperative queues and futures), then its models of the port's shipped
code under enumerated interleavings — the coalescer's flush, park and
shed, the breaker, the near cache, the tenant governor, the response
cache's epoch, the degraded mirror's seed guard, the journal's group
commit, the reactor and the front door's handoff, the run fences, the
residency ladder and the prewarm ladder — each with its mutation guard.

Two names differ between the packages, and an autouse fixture maps them
for the reference bodies: the engine class (``TpuSketchEngine`` is the
port's ``TorchSketchEngine``), and the prewarm ladder's JAX compile
listener, which the reference bodies swap for a no-op (the port has no
listener; the no-op stands in for it).
"""

import pytest

torch = pytest.importorskip("torch")

import test_explorer as _ref  # noqa: E402
from redisson_tpu_torch.executor import prewarm as _port_prewarm  # noqa: E402
from redisson_tpu_torch.objects import engines as _port_engines  # noqa: E402
from test_torch_cluster import port_namespace  # noqa: E402
from test_torch_grid_coordination import _BUILTINS  # noqa: E402
from test_torch_grid_coordination import _one_torch_thread  # noqa: E402,F401


@pytest.fixture(autouse=True)
def _reference_names(monkeypatch):
    monkeypatch.setattr(_port_engines, "TpuSketchEngine",
                        _port_engines.TorchSketchEngine, raising=False)
    monkeypatch.setattr(_port_prewarm, "_ensure_listener", lambda: None,
                        raising=False)


# The reference module's marks (``netsim``, ``explorer``, ``slow``).
pytestmark = _ref.pytestmark

globals().update(port_namespace(_ref, _BUILTINS))
