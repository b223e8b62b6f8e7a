"""``tests/test_netsim_recovery.py`` on the port (``port_namespace``):
the port's group-commit journal crashed at every pipeline stage under
``HostCrashDisk`` (recovery covers the acked prefix, an ack waits out a
slow fsync, the ack-at-write mutation is caught), and the residency
ladder's transitions against snapshots with the promote-order mutation
guard, all under the port's explorer.
"""

import pytest

torch = pytest.importorskip("torch")

import test_netsim_recovery as _ref  # noqa: E402
from test_torch_cluster import port_namespace  # noqa: E402
from test_torch_grid_coordination import _BUILTINS  # noqa: E402
from test_torch_grid_coordination import _one_torch_thread  # noqa: E402,F401

# The reference module's marks (``netsim``, ``explorer``, ``slow``).
pytestmark = _ref.pytestmark

globals().update(port_namespace(_ref, _BUILTINS))
