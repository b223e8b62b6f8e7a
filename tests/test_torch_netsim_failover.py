"""``tests/test_netsim_failover.py`` on the port (``port_namespace``):
the port's ``FailoverState`` and ``FailoverAgent`` elections over
simulated sockets — a single winner per race, a rogue candidate never
wins, a minority partition never elects, double takeovers converge —
and the three mutation guards caught.  ``slow``, as in the reference.
"""

import pytest

torch = pytest.importorskip("torch")

import test_netsim_failover as _ref  # noqa: E402
from test_torch_cluster import port_namespace  # noqa: E402
from test_torch_grid_coordination import _BUILTINS  # noqa: E402
from test_torch_grid_coordination import _one_torch_thread  # noqa: E402,F401

# The reference module's marks (``netsim``, ``explorer``, ``slow``).
pytestmark = _ref.pytestmark

globals().update(port_namespace(_ref, _BUILTINS))
