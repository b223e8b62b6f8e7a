"""Mean time a call waited for the coalescer to admit it (the queue bound,
``max_queued_ops``): the ``admit_wait`` phase of the program's
``rtpu_call_phase_seconds`` over the window, 0 for a call admitted at
once (change of sum over change of count, every public data call)."""

from portbench.counters import delta

UNIT = "ms"
LAYER = "coalescer"
MOVES = "ops_per_s"
FAMILIES = ("rtpu_call_phase_seconds",)


def read(run):
    if run.before is None:
        return None
    d = delta(run.before, run.after, "rtpu_call_phase_seconds")
    s = sum(v[0] for k, v in d.items() if k[1] == "admit_wait")
    n = sum(v[1] for k, v in d.items() if k[1] == "admit_wait")
    return s / n * 1e3 if n > 0 else None
