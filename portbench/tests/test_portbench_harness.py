"""The harness end to end on the CPU at a tiny size: a cell added as files
alone runs, the reference in the program's place comes out correct, each
control and each fault the cells can have comes out not correct, and the
command refuses to run without a card."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from portbench import run
from portbench.tests.conftest import REPO, make_tiny

SEED = 2**31 + 123


def _run(root, which, control=None, trace=False, seconds=1.0):
    bench = make_tiny(root, which)
    return run.execute("tiny", SEED, seconds, trace, device="cpu", root=root,
                       bench_path=bench, control=control)


@pytest.mark.parametrize("which", ["bloom", "bulk", "bitset", "replicated"])
def test_a_cell_added_as_files_alone_runs_correct(root, which):
    out = _run(root, which)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["metrics"]["ops_per_s"]["value"] > 0
    assert set(out["metrics"]) <= {"ops_per_s", "call_p99_ms", "setup_s"}
    assert list(out)[-1] == "checks"
    assert out["check_info"]["answers_checked"] > 0


def test_a_new_metric_added_as_a_file_is_read(root):
    with open(os.path.join(root, "metrics", "calls_per_s.py"), "w") as f:
        f.write('UNIT = "calls/s"\nLAYER = "client"\nMOVES = "ops_per_s"\n\n\n'
                "def read(run):\n    return len(run.window_calls()) / run.seconds\n")
    bench = make_tiny(root, "bloom")
    with open(bench) as f:
        b = json.load(f)
    b["per_layer"].append({"name": "calls_per_s", "unit": "calls/s", "better": "higher",
                           "source": "host_clock", "layer": "client", "moves": "ops_per_s",
                           "workloads": ["tiny"]})
    with open(bench, "w") as f:
        json.dump(b, f)
    out = run.execute("tiny", SEED, 1.0, True, device="cpu", root=root, bench_path=bench)
    assert out["correct"]
    assert out["metrics"]["calls_per_s"]["value"] > 0
    # Read from the program's counters; the trace's readers find no
    # trace on the CPU and leave their metrics out.
    assert out["metrics"]["ops_per_launch"]["value"] > 0
    assert "kernel_roofline" not in out["metrics"]


@pytest.mark.parametrize("which", ["bloom", "bitset"])
def test_the_reference_in_the_programs_place_is_correct(root, which):
    assert _run(root, which, control="exact")["correct"]


@pytest.mark.parametrize("which,variant", [
    ("bloom", "hash32"), ("bulk", "hash32"), ("replicated", "hash32"),
    ("bitset", "lost_update")])
def test_each_control_comes_out_not_correct(root, which, variant):
    out = _run(root, which, control=variant)
    assert not out["correct"]
    assert out["checks"]["row_bits_wrong"]["value"] > 0


def _flip_first_answer(monkeypatch, method):
    from redisson_tpu_torch.executor import torch_executor as te

    orig = getattr(te.TorchCommandExecutor, method)

    def altered(self, *a, **kw):
        res = orig(self, *a, **kw)
        t = res._transform

        def flip(v, t=t):
            v = np.array(t(v) if t is not None else v, copy=True)
            if v.dtype == bool and v.size:
                v[0] = ~v[0]
            return v

        res._transform = flip
        return res

    monkeypatch.setattr(te.TorchCommandExecutor, method, altered)


@pytest.mark.parametrize("which,method", [
    ("bloom", "bloom_mixed_keys_runs"), ("bulk", "bloom_mixed_keys_runs"),
    ("bitset", "bitset_mixed_runs")])
def test_an_answer_altered_where_it_is_produced_is_caught(root, monkeypatch, which, method):
    _flip_first_answer(monkeypatch, method)
    out = _run(root, which)
    assert not out["correct"]
    assert out["checks"]["wrong_answers"]["value"] > 0


def test_the_copy_to_the_other_shards_left_out_is_caught(root, monkeypatch):
    from redisson_tpu_torch.executor import sharded_executor as se

    monkeypatch.setattr(se.ShardedTorchCommandExecutor, "bitset_bitop",
                        lambda self, *a, **kw: None)
    out = _run(root, "replicated")
    assert not out["correct"]
    assert out["checks"]["row_bits_wrong"]["value"] > 0
    assert out["checks"]["wrong_answers"]["value"] > 0


def test_the_command_refuses_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                          "bitset-1gbit.batch-2m", "--seed", "1", "--seconds", "1"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_the_command_fails_beside_the_benchmark_alone(tmp_path):
    """A checkout holding only BENCHMARK.json and portbench/ has no program
    to measure: the run exits non-zero and prints no result."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                          "bitset-1gbit.batch-2m", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.gpu
@pytest.mark.parametrize("cell,variant", [
    ("bloom-1k-tenants.bulk-contains", "hash32"), ("bitset-1gbit.batch-2m", "lost_update")])
def test_on_the_card_the_control_fails_and_the_program_passes(card, cell, variant):
    """The control at the cell's own size on the card (a short window)."""
    for control, want in ((variant, False), (None, True)):
        cmd = [sys.executable, "-m", "portbench", "--workload", cell, "--seed", str(SEED),
               "--seconds", "5"] + (["--control", control] if control else [])
        out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=400)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is want


def test_a_call_that_never_answers_is_caught(root, monkeypatch):
    from redisson_tpu_torch.objects.bitset import BitSet

    orig, seen = BitSet.get_many_async, []

    def failing(self, idx):
        seen.append(1)
        if len(seen) == 3:
            raise RuntimeError("an injected failure")
        return orig(self, idx)

    monkeypatch.setattr(BitSet, "get_many_async", failing)
    out = _run(root, "bitset")
    assert not out["correct"]
    assert out["checks"]["calls_failed"]["value"] == 1


def _retraffic(root, **over):
    """The tiny cell's mix file, rewritten with ``over``."""
    path = os.path.join(root, "traffic", "tiny.json")
    with open(path) as f:
        mix = json.load(f)
    mix.update(over)
    with open(path, "w") as f:
        json.dump(mix, f)


def test_an_open_loop_mix_added_as_files_alone_runs_correct(root):
    bench = make_tiny(root, "bloom")
    _retraffic(root, loop="open", rate_per_s=300.0, arrivals="poisson",
               bursts={"every_s": 0.5, "length_s": 0.1, "factor": 4.0})
    out = run.execute("tiny", SEED, 1.5, False, device="cpu", root=root, bench_path=bench)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0
    # 300 calls a second, 1200 in the bursts (a fifth of the time): 720
    # due in 1.5 s.
    calls = out["check_info"]["window_calls"]
    assert 500 <= calls <= 950, calls


def test_a_loop_added_as_a_file_alone_drives_a_cell(root):
    with open(os.path.join(root, "loops", "one_at_a_time.py"), "w") as f:
        f.write('"""One call at a time, a pause between."""\n\nimport time\n\n'
                'KEYS = frozenset({"pause_s"})\n\n\n'
                "def client(plan, book, mix, first, stop_at, max_calls):\n"
                "    for j in range(first, first + max_calls):\n"
                "        if time.perf_counter() >= stop_at:\n"
                "            return\n"
                "        held = book.issue(plan.call(j))\n"
                "        if held is not None:\n"
                "            book.finish(*held)\n"
                '        time.sleep(mix["pause_s"])\n')
    bench = make_tiny(root, "bitset")
    _retraffic(root, loop="one_at_a_time", pause_s=0.01)
    out = run.execute("tiny", SEED, 1.0, False, device="cpu", root=root, bench_path=bench)
    assert out["correct"], out["checks"]
    # Four clients, each a call and a 10 ms pause at a time.
    assert 0 < out["check_info"]["window_calls"] <= 4 * 100
