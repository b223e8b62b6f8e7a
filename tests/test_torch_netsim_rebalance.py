"""``tests/test_netsim_rebalance.py`` on the port (``port_namespace``):
the port's ``RebalancePlanner``, ``blocked_reason`` and ``run_wave``
driven over simulated sockets against three port ``MiniClusterNode``s
(the harness of ``test_torch_netsim.py``): the assigner skips a mid-pump
slot and a stale plan, never touches a failed node, and a planned wave
loses no acked write; the busy and owner mutation guards are caught and
replayed.
"""

import pytest

torch = pytest.importorskip("torch")

import test_netsim_rebalance as _ref  # noqa: E402
from test_torch_cluster import port_namespace  # noqa: E402
from test_torch_grid_coordination import _BUILTINS  # noqa: E402
from test_torch_grid_coordination import _one_torch_thread  # noqa: E402,F401
from test_torch_netsim import MiniClusterNode  # noqa: E402

# The reference module's marks (``netsim``, ``explorer``, ``slow``).
pytestmark = _ref.pytestmark

globals().update(port_namespace(
    _ref, _BUILTINS, extra={"MiniClusterNode": MiniClusterNode}
))
