"""Metrics federation on the port.

The tests of ``tests/test_federation.py`` run again on the port's
``obs/federate.py`` (``port_module``): the four that need no cluster, and
the three-node supervisor test (``slow``; its nodes run with ``--device
cpu``, ``cpu_builtins`` of ``test_torch_cluster.py``).  Its
``test_federate_cli_mode`` runs on the port's entry point (unmarked:
federation mode boots no engine).  New here: the per-core front door's
parent serves its workers' metrics merged on ``--metrics-port``.
"""

import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

torch = pytest.importorskip("torch")

import test_federation as _ref  # noqa: E402
from redisson_tpu_torch.obs.promhttp import MetricsHTTPServer  # noqa: E402
from test_torch_grid_coordination import _one_torch_thread  # noqa: E402,F401
from test_torch_cluster import cpu_builtins, port_namespace  # noqa: E402
from test_torch_observability import port_module  # noqa: E402

SKIPPED = {
    "test_three_node_federated_metrics_and_fleet_merges":
        "rebound below with the CPU supervisor",
    "test_federate_cli_mode": "replaced below by the port's entry point",
}

port_module(_ref, globals(), skip=SKIPPED)
test_three_node_federated_metrics_and_fleet_merges = port_namespace(
    _ref, cpu_builtins)["test_three_node_federated_metrics_and_fleet_merges"]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _scrape(port: int, want: str, proc, timeout: float = 50.0) -> str:
    """The page at ``port`` once it holds ``want`` (polled)."""
    deadline = time.monotonic() + timeout
    body = ""
    while want not in body:
        assert proc.poll() is None, proc.stdout.read().decode()
        assert time.monotonic() < deadline, f"{want!r} never served: {body[-500:]}"
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=5
            ) as r:
                body = r.read().decode()
        except OSError:
            time.sleep(0.1)
    return body


def _stop(proc) -> int:
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_federate_cli_mode():
    """``python -m redisson_tpu_torch --federate ... --metrics-port N``
    serves the merged page without booting an engine."""
    member = MetricsHTTPServer(lambda: _ref.PAGE_A)
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "redisson_tpu_torch",
         "--federate", f"{member.host}:{member.port}",
         "--metrics-port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=_env(),
    )
    try:
        body = _scrape(port, "rtpu_federation_node_up", proc)
        assert f'node="{member.host}:{member.port}"' in body
        assert _stop(proc) == 0
    finally:
        member.close()


def test_frontdoor_parent_federates_its_workers():
    """The K=2 parent's ``--metrics-port`` page carries both workers'
    series, each under its own endpoint's node label."""
    port, mport = _free_port(), _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "redisson_tpu_torch", "--frontdoor-processes",
         "2", "--device", "cpu", "--port", str(port),
         "--metrics-port", str(mport)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=_env(),
    )
    try:
        nodes = [f"127.0.0.1:{mport + 1 + i}" for i in range(2)]
        body = _scrape(port=mport, want=f'rtpu_federation_node_up{{node="{nodes[1]}"}} 1',
                       proc=proc)
        for i, node in enumerate(nodes):
            assert f'rtpu_federation_node_up{{node="{node}"}} 1' in body
            assert f'rtpu_frontdoor_processes{{node="{node}"}} 2' in body
            assert f'rtpu_frontdoor_worker_index{{node="{node}"}} {i}' in body
        assert body.count("# TYPE rtpu_frontdoor_processes gauge") == 1
    finally:
        assert _stop(proc) == 0
