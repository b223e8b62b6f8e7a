"""Mean time a launch's ops waited in the coalescer's queue before the
flush took them: the ``coalesce_wait`` phase of the program's
``rtpu_op_phase_seconds`` over the window (change of sum over change of
count, every op)."""

from portbench.counters import delta

UNIT = "ms"
LAYER = "coalescer"
MOVES = "ops_per_s"
FAMILIES = ("rtpu_op_phase_seconds",)


def read(run):
    if run.before is None:
        return None
    d = delta(run.before, run.after, "rtpu_op_phase_seconds")
    s = sum(v[0] for k, v in d.items() if k[1] == "coalesce_wait")
    n = sum(v[1] for k, v in d.items() if k[1] == "coalesce_wait")
    return s / n * 1e3 if n > 0 else None
