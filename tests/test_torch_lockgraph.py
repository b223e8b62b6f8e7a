"""``tests/test_lockgraph.py`` on the port's static lock-order graph
(``redisson_tpu_torch/analysis/lockgraph.py``): ``port_namespace`` rebinds
the reference module with ``PKG`` set to the port's tree, so its
shipped-tree tests gate ``redisson_tpu_torch/`` (the catalog covers every
tier, no cycle, the interprocedural ``engine.mirror -> health.state``
edge), its fixtures run through the port's pass, the witness round trip
uses the port's witness and the CLI test runs ``python -m
redisson_tpu_torch.analysis``.  All 9 reference tests run.

Added for the port:

* the catalog equals the reference's named locks, site for site, all 49
  of them (``engine.host`` is the port's ``HostSketchEngine`` lock;
  ``REF_ONLY_LOCKS`` is empty);
* the static edges equal the reference's, less ``REF_ONLY_EDGES`` and
  plus ``PORT_ONLY_EDGES``, each with its reason;
* a lock order that would close a cycle through the port's real edges is
  reported, and so is one merged from runtime edges.
"""

import json
import os

import pytest

import test_lockgraph as _ref
from redisson_tpu_torch.analysis import lockgraph
from test_torch_rtpulint import _rebind
from test_torch_cluster import port_namespace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PKG = os.path.join(REPO, "redisson_tpu_torch")
REF_PKG = os.path.join(REPO, "redisson_tpu")

globals().update(_rebind(port_namespace(_ref, extra={"PKG": PORT_PKG})))

# Named in the reference, with no counterpart in the port: none since the
# port carries the host engine (its lock is engine.host).
REF_ONLY_LOCKS: dict = {}

# Edges of the reference's static graph the port's lacks.  The host
# engine's two (cluster.move -> engine.host, engine.host -> engine.topk)
# are in both graphs now.
REF_ONLY_EDGES = {
    ("grid.topics.bus", "grid.store"):
        "name resolution, infeasible: TopicBus.drain's nested pending() resolved to "
        "Stream.pending (which takes the grid lock); in the port the nested check is "
        "undelivered(), since the armed suites' runtime grid.store -> grid.topics.bus "
        "edge (a publish under the grid lock) closed a cycle with it",
    ("repl.link", "grid.services.function"):
        "name resolution, infeasible: restore_snapshot's json.load/np.load resolve to "
        "FunctionService.load among the reference's three load defs; the port has a "
        "fourth (K1's _build.load), past AMBIG_CAP, so no load call resolves",
}

# Edges only the port's static graph has.  (cluster.move -> engine.topk
# left this list with the host engine: its dump is the port's fourth dump
# def too, past AMBIG_CAP, so neither pass follows dump from the door.)
PORT_ONLY_EDGES = {
    ("engine.mirror", "engine.topk"):
        "the port's _snapshot_capture builds the meta (top-K tables included) inside the "
        "mirror -> registry -> dispatch locks; the reference builds it after releasing "
        "them.  engine.topk is a leaf: no cycle",
}


@pytest.fixture(scope="module")
def graphs():
    return lockgraph.build_graph([REF_PKG]), lockgraph.build_graph([PORT_PKG])


def test_port_catalog_is_the_references_less_the_host_engine(graphs):
    ref, port = graphs
    assert set(port.catalog) == set(ref.catalog) - set(REF_ONLY_LOCKS)
    assert len(ref.catalog) == 49 and len(port.catalog) == 49
    # Same name, same module: each lock is named at its counterpart site.
    # (A module-level lock is catalogued once per scan that meets it.)
    for name, sites in port.catalog.items():
        assert ({os.path.relpath(f, PORT_PKG) for f, _l in sites}
                == {os.path.relpath(f, REF_PKG) for f, _l in ref.catalog[name]}), name


def test_port_edges_are_the_references_with_the_named_differences(graphs):
    ref, port = graphs
    assert set(REF_ONLY_EDGES) <= set(ref.edges)
    assert not set(REF_ONLY_EDGES) & set(port.edges)
    assert set(port.edges) == (set(ref.edges) - set(REF_ONLY_EDGES)) | set(PORT_ONLY_EDGES), (
        f"port-only: {sorted(set(port.edges) - set(ref.edges) - set(PORT_ONLY_EDGES))}, "
        f"reference-only: {sorted(set(ref.edges) - set(port.edges) - set(REF_ONLY_EDGES))}")
    assert port.suppressed == {} and ref.suppressed == {}


def test_a_reverse_order_on_a_real_port_edge_is_a_cycle(graphs):
    """The port's real engine.mirror -> health.state edge (reconcile
    under the mirror lock) closes a cycle with the reverse order taken
    anywhere: the gate would refuse a health path that entered the
    mirror lock."""
    _ref_graph, port = graphs
    assert lockgraph.check(port) == []
    merged = lockgraph.LockGraph(catalog=dict(port.catalog), edges=dict(port.edges))
    lockgraph.merge_runtime_edges(merged, [("health.state", "engine.mirror")])
    (v,) = lockgraph.check(merged)
    assert v.rule == "RT010" and "engine.mirror" in v.message and "health.state" in v.message


def test_cli_dump_of_the_port_tree(tmp_path):
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-m", "redisson_tpu_torch.analysis", "--dump-lock-graph"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    dumped = json.loads(proc.stdout)
    assert len(dumped["catalog"]) == 49 and "engine.host -> engine.topk" in dumped["edges"]


@pytest.mark.parametrize("flags", [[], ["--dump-lock-graph"], ["--rule", "RT010"]],
                         ids=["lint", "dump", "rt010"])
def test_cli_missing_runtime_export_is_a_usage_error(tmp_path, flags):
    """A witness that never armed exports nothing: ``--runtime-edges`` on
    a missing file exits 2 instead of passing the gate on no edges."""
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-m", "redisson_tpu_torch.analysis", *flags,
         "--runtime-edges", str(tmp_path / "never-written.json"), str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "cannot read --runtime-edges" in proc.stderr
