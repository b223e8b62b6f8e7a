"""The port passes its own static analyser (``python -m
redisson_tpu_torch.analysis``) with no unsuppressed finding, as the JAX
package passes its (the ``rtpulint`` CI job): every lock, tmp-file
publish and module-level table of ``redisson_tpu_torch/`` — the cache and
storage tiers included — is clean or carries a reasoned suppression, no
suppression is stale, and the RT010 lock graph over the witness-named
locks has no cycle.  The JAX package's analyser runs over the port too,
as a cross-check."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("analyser, flags", [
    ("redisson_tpu_torch.analysis", []),
    ("redisson_tpu_torch.analysis", ["--audit-suppressions"]),
    ("redisson_tpu.analysis", ["--audit-suppressions"]),
], ids=["lint", "no-stale-suppressions", "reference-cross-check"])
def test_port_lints_clean(analyser, flags):
    proc = subprocess.run(
        [sys.executable, "-m", analyser, *flags, "redisson_tpu_torch/"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    assert "rtpulint: 0 violation(s)" in out, out
    assert "lock graph: 49 locks" in out, out


def test_port_rt010_gate_over_the_named_locks():
    """``--rule RT010``: the whole-tree lock graph over the port's 49
    witness-named locks (the reference's 49, the host engine's included)
    has no cycle; the CLI's default path is the port's package."""
    proc = subprocess.run(
        [sys.executable, "-m", "redisson_tpu_torch.analysis", "--rule", "RT010"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    assert "rtpulint: 0 violation(s), 0 suppressed; lock graph: 49 locks" in out, out


def test_new_tiers_are_linted():
    """The analyser really walks the cache, storage, serving and grid
    modules."""
    proc = subprocess.run(
        [sys.executable, "-m", "redisson_tpu_torch.analysis", "--show-suppressed",
         "redisson_tpu_torch/cache/", "redisson_tpu_torch/storage/",
         "redisson_tpu_torch/executor/prewarm.py", "redisson_tpu_torch/serve/",
         "redisson_tpu_torch/grid/"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    # residency.py carries the reference's reasoned RT001 suppressions
    # (promotion write-back and quarantine reclaim under their locks).
    assert "storage/residency.py" in out and "RT001" in out, out
    # The front door carries the reference's: the connection write lock
    # (RT001), the client-compat CONFIG rows (RT004) and the reactor's
    # self-pipe (RT013).
    for rule in ("RT001", "RT004", "RT013"):
        assert any(rule in line and "serve/" in line for line in out.splitlines()), rule
