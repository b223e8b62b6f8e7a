"""``tests/test_rebalancer.py`` on the port (``port_namespace`` of
``test_torch_cluster.py``): the pure planner (warmup, hysteresis,
cooldown, the mega slot, exclusions, drain, cold pack, the idle floor,
baselines), ``blocked_reason`` and ``run_wave``'s last-moment vetoes,
the write-time slot->key index and its DEBUG-scan differential on two
in-process cluster nodes, CLUSTER MEET, CLUSTER REBALANCE STATUS on
nodes without the agent, the armed agent's verbs, CONFIG rows and a
heat-driven wave that migrates hot slots between two port nodes,
``fleet_loadmap``'s dead-member degradation, and the elastic join/drain
of a subprocess fleet (``slow``, as in the reference; its nodes run
``--device cpu``).

Nothing is left out: every test of the reference module runs here.
"""

import pytest

torch = pytest.importorskip("torch")

import test_rebalancer as _ref  # noqa: E402
from test_torch_cluster import cpu_builtins, port_namespace  # noqa: E402
from test_torch_grid_coordination import _one_torch_thread  # noqa: E402,F401

globals().update(port_namespace(_ref, cpu_builtins))
