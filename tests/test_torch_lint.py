"""The port passes the project's static analyser with no unsuppressed
finding, as the JAX package does (its ``rtpulint`` CI job): every lock,
tmp-file publish and module-level table of ``redisson_tpu_torch/`` — the
cache and storage tiers included — is clean or carries a reasoned
suppression, and no suppression is stale."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("flags", [[], ["--audit-suppressions"]],
                         ids=["lint", "no-stale-suppressions"])
def test_port_lints_clean(flags):
    proc = subprocess.run(
        [sys.executable, "-m", "redisson_tpu.analysis", *flags, "redisson_tpu_torch/"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    assert "rtpulint: 0 violation(s)" in out, out


def test_new_tiers_are_linted():
    """The analyser really walks the cache, storage, serving and grid
    modules."""
    proc = subprocess.run(
        [sys.executable, "-m", "redisson_tpu.analysis", "--show-suppressed",
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
