"""The slot-index and membership half of ``tests/test_rebalancer.py`` on
the port (``port_namespace`` of ``test_torch_cluster.py``): the
write-time slot->key index and its DEBUG-scan differential on two
in-process cluster nodes, CLUSTER MEET, CLUSTER REBALANCE STATUS on
nodes without the agent, and ``fleet_loadmap``'s dead-member
degradation.

Not collected (``WAITING``): the planner, the agent, the wave and the
elastic join/drain tests — they drive ``cluster/rebalancer.py`` and the
supervisor's migration pump under it, which come with the fleet doctor
in ROADMAP queue 1 item 3b.
"""

import pytest

torch = pytest.importorskip("torch")

import test_rebalancer as _ref  # noqa: E402
from test_torch_cluster import cpu_builtins, port_namespace  # noqa: E402
from test_torch_grid_coordination import _one_torch_thread  # noqa: E402,F401

_SLICE_14 = "queue 1 item 3b: cluster/rebalancer.py"
WAITING = {
    name: _SLICE_14 for name in (
        "test_planner_first_observation_is_baseline_only",
        "test_planner_warmup_gate_blocks_early_waves",
        "test_planner_hot_shed_and_hysteresis_dead_band",
        "test_planner_below_threshold_never_triggers",
        "test_planner_cooldown_blocks_ping_pong",
        "test_planner_mega_slot_never_bounces",
        "test_planner_excluded_nodes_untouchable",
        "test_planner_drain_ignores_warmup_and_empties_node",
        "test_planner_cold_pack_consolidates_idle_keyed_slots",
        "test_planner_min_heat_floor_keeps_idle_cluster_still",
        "test_planner_forget_node_resets_baseline",
        "test_blocked_reason_busy_stale_failover_precedence",
        "test_run_wave_skips_without_dialing",
        "test_agent_surfaces_config_and_heat_driven_wave",
        "test_add_node_and_drain_node_e2e",
    )
}

globals().update(port_namespace(_ref, cpu_builtins, skip=WAITING))
