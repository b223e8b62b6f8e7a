"""``tests/test_netsim.py`` on the port (``port_namespace``): the port's
cluster protocol — ``ClusterDoor.route``/``route_recheck``/
``migrate_key`` under the move guard, the routing client's MOVED/ASK
chase and scatter/gather demux, ``supervisor.migrate_slot``,
``wireutil.exchange`` and ``resp.consume_one_shot_licenses`` — driven
over the port's simulated network (``analysis/netsim.py``) under the
port's schedule explorer, with every mutation guard caught and replayed.

The autouse fixture of the reference module restores the real socket
layer after every test (``netsim.restore_patches()``), and no test here
nests one package's ``explore()`` inside the other's.
"""

import pytest

torch = pytest.importorskip("torch")

import test_netsim as _ref  # noqa: E402
from test_torch_cluster import port_namespace  # noqa: E402
from test_torch_grid_coordination import _BUILTINS  # noqa: E402
from test_torch_grid_coordination import _one_torch_thread  # noqa: E402,F401

# The reference module's marks (``netsim``, ``explorer``, ``slow``).
pytestmark = _ref.pytestmark

globals().update(port_namespace(_ref, _BUILTINS, export=("MiniClusterNode",)))
