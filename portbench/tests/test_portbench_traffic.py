"""The traffic generator's parameters: zipf ranks at any theta, ops that
take every N-th call, ops with no elements, open-loop arrivals and their
bursts, and the keys a mix may hold."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest

from portbench import spec
from portbench.loops import open as open_loop
from portbench.traffic import ClientPlan, Zipf, load_mix


class _Space:
    n_targets = 10
    dtype = np.uint64

    @staticmethod
    def domain(source):
        return 1 << 20

    @staticmethod
    def values(source, target, ranks, out):
        np.copyto(out, ranks, casting="unsafe")


def _mix(**over):
    mix = {"loop": "closed", "clients": 2, "inflight": 1, "elements_per_call": 8,
           "warmup_calls": 0, "ops": [{"op": "get", "parts": [{"source": "u", "share": 1.0}]}]}
    mix.update(over)
    return mix


def _write(tmp_path, mix, root=spec.ROOT):
    path = tmp_path / "mix.json"
    path.write_text(json.dumps(mix))
    return load_mix(str(path), root)


@pytest.mark.parametrize("n,theta", [(1000, 0.99), (1000, 1.0), (1000, 1.2),
                                     (5_000_000, 1.2), (5_000_000, 2.0)])
def test_zipf_ranks_follow_the_distribution(n, theta):
    u = np.random.default_rng(3).random(400_000)
    r = Zipf(n, theta).ranks(u)
    assert r.min() >= 0 and r.max() < n
    w = np.arange(1, min(n, 1 << 20) + 1, dtype=np.float64) ** -theta
    total = w.sum() + (0 if n <= 1 << 20 else
                       (math.log((n + .5) / ((1 << 20) + .5)) if theta == 1 else
                        (((n + .5) ** (1 - theta)) - ((1 << 20) + .5) ** (1 - theta)) / (1 - theta)))
    # YCSB's generator (theta below 1) is exact for the first two ranks
    # only; its approximation beyond them is the workloads' own.
    for rank in (0, 1, 2, 9, 99) if theta >= 1 else (0, 1):
        want = w[rank] / total
        got = np.mean(r == rank)
        assert abs(got - want) <= 5 * math.sqrt(want / len(u)) + 1e-4, (rank, got, want)
    if n > 1 << 16:  # the tail past the exact head is drawn too
        assert np.mean(r >= 1 << 16) > 0


def test_an_every_op_takes_every_nth_call_and_may_carry_no_elements(tmp_path):
    mix = _write(tmp_path, _mix(ops=[
        {"op": "add", "weight": 1, "parts": [{"source": "u", "share": 1.0}]},
        {"op": "get", "weight": 1, "parts": [{"source": "u", "share": 1.0}]},
        {"op": "count", "every": 4, "elements": 0}]))
    plan = ClientPlan(mix, _Space(), 2**33 + 1, 0)
    calls = [plan.call(j) for j in range(64)]
    assert [c.number for c in calls if c.op == "count"] == list(range(3, 64, 4))
    assert all(len(c.elements) == 0 for c in calls if c.op == "count")
    assert {c.op for c in calls if c.op != "count"} == {"add", "get"}
    assert all(len(c.elements) == 8 for c in calls if c.op != "count")
    import torch

    assert plan.elements_on(3, torch.device("cpu")).numel() == 0


@pytest.mark.parametrize("bad", [
    {"rate": 5},  # a key no loop reads
    {"loop": "open"},  # an open loop needs its rate
    {"loop": "open", "rate_per_s": 10, "arrivals": "bursty"},
    {"loop": "no-such-loop"},
    {"ops": [{"op": "count", "every": 2, "elements": 0}]},  # no op left for the rest
    {"ops": [{"op": "get", "parts": [{"source": "u", "share": 0.5}]}]},
])
def test_a_mix_that_does_not_hold_is_refused(tmp_path, bad):
    with pytest.raises((ValueError, KeyError, FileNotFoundError)):
        _write(tmp_path, _mix(**bad))


def test_open_arrivals_keep_their_rate_and_their_bursts(tmp_path):
    mix = _write(tmp_path, _mix(loop="open", rate_per_s=2000.0, clients=2,
                                bursts={"every_s": 1.0, "length_s": 0.25, "factor": 4.0}))
    due = open_loop.arrivals(mix, 2**40 + 7, 1, 0)
    t = np.array([next(due) for _ in range(20_000)])
    assert np.all(np.diff(t) > 0)
    # 1000 calls a second for this client; a period carries 0.25 * 4 + 0.75 of it.
    per_period = 1000 * (0.25 * 4 + 0.75)
    span = int(t[-1])
    assert abs(len(t[t < span]) / span - per_period) < 0.05 * per_period
    in_burst = np.mean((t % 1.0) < 0.25)
    assert abs(in_burst - 1.0 / 1.75) < 0.02
    again = open_loop.arrivals(mix, 2**40 + 7, 1, 0)
    assert [next(again) for _ in range(100)] == list(t[:100])
