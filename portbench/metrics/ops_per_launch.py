"""Ops per executor launch over the window: the change of the program's
``rtpu_dispatch_ops`` over the change of ``rtpu_dispatches`` (every
executor method).  The coalescer's merging shows here."""

from portbench.counters import delta

UNIT = "ops"
LAYER = "coalescer"
MOVES = "ops_per_s"
FAMILIES = ("rtpu_dispatches_total", "rtpu_dispatch_ops_total")


def read(run):
    if run.before is None:
        return None
    launches = sum(delta(run.before, run.after, "rtpu_dispatches_total").values())
    ops = sum(delta(run.before, run.after, "rtpu_dispatch_ops_total").values())
    return ops / launches if launches > 0 else None
