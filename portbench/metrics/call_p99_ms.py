"""99th percentile, over every call answered inside the window, of the
time from its issue to its answer in host memory (numpy's linear
interpolation between order statistics).  In a traced run the calls that
overlap the profiled slice are left out.  ``None`` below 1000 calls: the
percentile needs ten calls beyond it.

``call_p99_ms.<suffix>`` is this reader as a per-layer metric of the
cells whose tail swings too widely to bound end to end (PERF.md, section
2), read in their traced runs."""

import numpy as np

UNIT = "ms"
LAYER = "end to end"
MOVES = "call_p99_ms"
PER_CELL = {"layer": "client", "moves": "ops_per_s"}


def read(run):
    calls = run.window_calls()
    if run.profile is not None:
        t0, t1 = run.profile["t0"], run.profile["t1"]
        calls = [r for r in calls if r.t_done < t0 or r.t_issue > t1]
    if len(calls) < 1000:
        return None
    return float(np.percentile([r.t_done - r.t_issue for r in calls], 99)) * 1e3
