"""The count-min top-K cell on the CPU at a tiny size: the program's runs
come out correct, the reference in its place too, and each control and a
faulted program not; the cell's readers return ``None`` on a run without
their records; the byte count gives kernel K1's bound."""

from __future__ import annotations

import json
import os
import types

import numpy as np
import pytest

from portbench import run, spec
from portbench.peaks import peaks_for
from portbench.tests.conftest import REPO

SEED = 2**31 + 2024
READERS = ("k1_roofline_pct", "cms_hash_ms", "topk_offer_ms")


def make_tiny_cms(root: str, name: str = "tiny", check_share: float = 0.5) -> str:
    """``cms-topk.zipf-stream`` cut to a CPU test's size (d = 5 and
    (d w) % 128 = 0, so the program takes its sequential path), as a cell
    ``name`` added to ``root``; returns its BENCHMARK.json copy."""
    with open(os.path.join(root, "configs", "cms-topk.json")) as f:
        cfg = json.load(f)
    cfg.update({"width": 4096, "keys": 5000})
    with open(os.path.join(root, "traffic", "zipf-stream.json")) as f:
        mix = json.load(f)
    mix.update({"elements_per_call": 2048, "warmup_calls": 2, "check_share": check_share})
    mix["ops"][1]["every"] = 8
    for folder, obj in (("configs", cfg), ("traffic", mix)):
        with open(os.path.join(root, folder, name + ".json"), "w") as f:
            json.dump(obj, f)
    with open(os.path.join(root, "workloads", name + ".json"), "w") as f:
        json.dump({"config": name, "traffic": name, "chips": 1, "why": "a CPU test"}, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for section in ("end_to_end", "per_layer"):
        for metric in bench[section]:
            if "cms-topk.zipf-stream" in metric.get("workloads", [name]):
                metric["workloads"].append(name)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    return path


def _run(root, control=None, trace=False, seconds=1.0, check_share=0.5):
    bench = make_tiny_cms(root, check_share=check_share)
    return run.execute("tiny", SEED, seconds, trace, device="cpu", root=root,
                       bench_path=bench, control=control)


def test_the_cell_runs_correct_and_reads_its_phases(root):
    out = _run(root, trace=True, seconds=1.5)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    checks = out["checks"]
    assert set(checks) == {"sketch_sized_wrong", "calls_failed", "wrong_answers",
                           "cells_wrong", "count_wrong", "topk_wrong"}
    assert out["check_info"]["answers_checked"] > 0
    m = out["metrics"]
    assert m["cms_hash_ms"]["value"] > 0 and m["topk_offer_ms"]["value"] > 0
    # No trace on the CPU: K1's share finds nothing to read.
    assert "k1_roofline_pct" not in m


def test_the_reference_in_the_programs_place_is_correct(root):
    assert _run(root, control="exact")["correct"]


@pytest.mark.parametrize("variant,caught_by", [
    ("hash32", "cells_wrong"), ("batch_final", "wrong_answers")])
def test_each_control_comes_out_not_correct(root, variant, caught_by):
    out = _run(root, control=variant)
    assert not out["correct"]
    assert out["checks"][caught_by]["value"] > 0


def test_an_estimate_altered_where_it_is_produced_is_caught(root, monkeypatch):
    from redisson_tpu_torch.executor import torch_executor as te

    orig = te.TorchCommandExecutor.cms_update_estimate_seq

    def altered(self, *a, **kw):
        res = orig(self, *a, **kw)
        t = res._transform

        def flip(v, t=t):
            v = np.array(t(v), copy=True)
            v[0] += 1
            return v

        res._transform = flip
        return res

    monkeypatch.setattr(te.TorchCommandExecutor, "cms_update_estimate_seq", altered)
    out = _run(root, check_share=1.0)
    assert not out["correct"]
    assert out["checks"]["wrong_answers"]["value"] > 0


def test_a_lost_event_is_caught(root, monkeypatch):
    """A call whose last event never reaches the sketch."""
    from redisson_tpu_torch.objects.count_min_sketch import CountMinSketch

    orig = CountMinSketch.add_all_seq

    def dropping(self, objs, counts=None):
        return np.concatenate([orig(self, objs[:-1]), [0]]).astype(np.uint32)

    monkeypatch.setattr(CountMinSketch, "add_all_seq", dropping)
    out = _run(root)
    assert not out["correct"]
    assert out["checks"]["count_wrong"]["value"] > 0
    assert out["checks"]["cells_wrong"]["value"] > 0


def test_each_new_reader_reads_nothing_without_its_records(root):
    """A run of the parent program: no ``hash`` or ``offer`` phase, no
    trace (or a trace without K1)."""
    phase = "rtpu_call_phase_seconds"
    before = {(phase, ("CountMinSketch.estimate_all_async", "encode")): (0.0, 0)}
    after = {(phase, ("CountMinSketch.estimate_all_async", "encode")): (0.5, 5)}
    r = types.SimpleNamespace(before=before, after=after, profile=None, peaks={},
                              window_calls=lambda: [])
    for name in READERS:
        assert spec.metric(name, root).read(r) is None, name
    r.profile = {"device_ops": [["void at::native::index_elementwise_kernel", 0.5]],
                 "t0": 0.0, "t1": 1.0}
    r.peaks = peaks_for("NVIDIA H100 80GB HBM3")
    assert spec.metric("k1_roofline_pct", root).read(r) is None
    r.before = r.after = None
    for name in READERS:
        assert spec.metric(name, root).read(r) is None, name


def test_k1_share_reads_the_bytes_bound_over_the_kernels_time(root):
    cfg = spec.config("cms-topk", root)
    kind = spec.kind("cms", root)
    space = kind.Space(cfg, 0)
    calls = [types.SimpleNamespace(op="add_seq", n=32768, t_done=0.5),
             types.SimpleNamespace(op="topk", n=0, t_done=0.6)]
    r = types.SimpleNamespace(
        profile={"device_ops": [["_Z14cms_seq_kernelPiPKiS1_S1_S_iiiii", 2.84e-5],
                                ["void at::native::index_elementwise_kernel", 1e-3]],
                 "t0": 0.0, "t1": 1.0},
        peaks=peaks_for("NVIDIA H100 80GB HBM3"), kind=kind, space=space,
        window_calls=lambda: calls)
    reader = spec.metric("k1_roofline_pct", root)
    # 96 B an event over 32,768 events: 0.94 us at 3.35 TB/s, 3.3% of 28.4 us.
    assert reader.read(r) == pytest.approx(100 * 96 * 32768 / 3.35e12 / 2.84e-5)
    assert reader.detail(r)["bound_by"] == "bytes"


def test_element_bytes_give_k1s_bound():
    cfg = spec.config("cms-topk")
    kind = spec.kind("cms")
    space = kind.Space(cfg, 0)
    assert kind.element_bytes(space, "add_seq") == 16 + 8 * 5 * 65536 / 32768
    assert kind.element_bytes(space, "topk") == 0
    t = 32768 * kind.element_bytes(space, "add_seq") / peaks_for("H100")["hbm_bytes_per_s"]
    assert t == pytest.approx(0.94e-6, rel=0.01)


def test_keys_and_ranks_invert():
    import torch

    kind = spec.kind("cms")
    space = kind.Space(spec.config("cms-topk"), 2**31 + 99)
    ranks = np.arange(0, 100000, 7, dtype=np.int64)
    keys = np.empty(len(ranks), np.uint64)
    space.values("stream", 0, ranks, keys)
    t = space.values_t("stream", 0, torch.from_numpy(ranks))
    assert np.array_equal(t.numpy().view(np.uint64), keys)
    assert np.array_equal(space.ranks_t(t).numpy(), ranks)
    assert len(np.unique(keys)) == len(keys)
