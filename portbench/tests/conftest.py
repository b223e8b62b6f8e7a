"""Fixtures of the benchmark's CPU tests: a copy of the harness's root with
a tiny cell added as files, as a later change would add one."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from portbench import spec

REPO = os.path.dirname(spec.ROOT)

TINY = {
    "bloom": ("bloom-1k-tenants", "ycsb-b",
              {"tenants": 6, "expected_insertions": 20000, "loaded_keys_per_tenant": 4096},
              {"clients": 4, "inflight": 2, "elements_per_call": 256, "warmup_calls": 2}),
    "bulk": ("bloom-1k-tenants", "bulk-contains",
             {"tenants": 4, "expected_insertions": 20000, "loaded_keys_per_tenant": 4096},
             {"elements_per_call": 4096, "warmup_calls": 1, "check_share": 0.5}),
    "bitset": ("bitset-1gbit", "batch-2m", {"bits": 1 << 20, "preset_bits": 1 << 14},
               {"elements_per_call": 1 << 12, "warmup_calls": 2, "check_share": 0.5}),
    "replicated": ("bloom-55m-replicated", "ycsb-c",
                   {"expected_insertions": 100000, "loaded_keys_per_tenant": 100000,
                    "gpu_sketch": {"num_shards": 4}},
                   {"clients": 4, "elements_per_call": 2048, "warmup_calls": 2}),
}


def make_tiny(root: str, which: str, name: str = "tiny") -> str:
    """Add config, mix and cell ``name`` to ``root``: a committed
    deployment and mix cut to a CPU test's size.  Returns the path of a
    BENCHMARK.json copy whose metrics name the new cell."""
    config, mix, cfg_over, mix_over = TINY[which]
    with open(os.path.join(root, "configs", config + ".json")) as f:
        cfg = json.load(f)
    cfg.update(cfg_over)
    with open(os.path.join(root, "traffic", mix + ".json")) as f:
        m = json.load(f)
    m.update(mix_over)
    for folder, obj in (("configs", cfg), ("traffic", m)):
        with open(os.path.join(root, folder, name + ".json"), "w") as f:
            json.dump(obj, f)
    with open(os.path.join(root, "workloads", name + ".json"), "w") as f:
        json.dump({"config": name, "traffic": name, "chips": 1, "why": "a CPU test"}, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for section in ("end_to_end", "per_layer"):
        for metric in bench[section]:
            metric.get("workloads", []).append(name)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    return path


@pytest.fixture
def root(tmp_path):
    """A copy of the harness's data and code folders."""
    dst = tmp_path / "portbench"
    shutil.copytree(spec.ROOT, dst, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    return str(dst)


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
