"""Mean time a call spent encoding its keys into lane blocks: the
``encode`` phase of the program's ``rtpu_call_phase_seconds`` over the
window (change of sum over change of count, every public data call)."""

from portbench.counters import delta

UNIT = "ms"
LAYER = "client"
MOVES = "ops_per_s"
FAMILIES = ("rtpu_call_phase_seconds",)


def read(run):
    if run.before is None:
        return None
    d = delta(run.before, run.after, "rtpu_call_phase_seconds")
    s = sum(v[0] for k, v in d.items() if k[1] == "encode")
    n = sum(v[1] for k, v in d.items() if k[1] == "encode")
    return s / n * 1e3 if n > 0 else None
