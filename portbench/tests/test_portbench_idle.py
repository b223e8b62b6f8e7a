"""The readers of the program's per-call phases, launch device time and
idle causes, rehearsed on the CPU on B's mix at a tiny size: each of the
six reads a number from a traced run, and the three idle shares together
stay within the window; the client's share leaves out the part of the
window's first gap that lies before the window."""

from __future__ import annotations

import types

from portbench import run, spec
from portbench.loop import Record
from portbench.tests.conftest import make_tiny

SEED = 2**31 + 321
READERS = ("encode_ms", "admit_wait_ms", "launch_device_ms",
           "idle_client_pct", "idle_coalescer_pct", "idle_executor_pct")


def test_each_idle_reader_reads_a_number_on_the_bulk_mix(root):
    bench = make_tiny(root, "bulk")
    out = run.execute("tiny", SEED, 1.5, True, device="cpu", root=root, bench_path=bench)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    assert set(READERS) <= set(m), sorted(m)
    for name in READERS:
        assert m[name]["value"] >= 0, (name, m[name])
    assert m["encode_ms"]["value"] > 0 and m["launch_device_ms"]["value"] > 0
    shares = sum(m[n]["value"] for n in READERS if n.startswith("idle_"))
    assert 0 < shares <= 100.0


def test_the_client_share_leaves_out_the_gap_before_the_window(root):
    """The program counts the gap before the window's first launch when
    that launch retires: from the warm-up's last answer (t = 9) to the
    window's start (t = 10) is the caller's, but not the window's."""
    fam = "rtpu_device_idle_seconds_total"
    before = {("rtpu_launch_device_seconds", ("op",)): (0.0, 0), (fam, ("caller",)): 0.0}
    after = {("rtpu_launch_device_seconds", ("op",)): (0.5, 5), (fam, ("caller",)): 1.5,
             (fam, ("encode",)): 0.25, (fam, ("enqueue",)): 0.25}
    records = [Record(0, 0, "contains", 0, 8, 8.0, 9.0, phase="warm"),
               Record(0, 1, "contains", 0, 8, 10.0, 10.5)]
    r = types.SimpleNamespace(before=before, after=after, records=records, t_start=10.0,
                              seconds=2.0, cell={"chips": 1})
    reader = spec.metric("idle_client_pct", root)
    assert reader.read(r) == 100.0 * (0.5 + 0.25) / 2.0
    assert spec.metric("idle_executor_pct", root).read(r) == 100.0 * 0.25 / 2.0
