"""Mean device time per launch over the window: the program's
``rtpu_launch_device_seconds``, timed by events the program records
before and after each launch on its stream (change of sum over change
of count, every launch; card-seconds where a launch spans cards)."""

from portbench.counters import delta

UNIT = "ms"
LAYER = "device"
MOVES = "ops_per_s"
FAMILIES = ("rtpu_launch_device_seconds",)


def read(run):
    if run.before is None:
        return None
    d = delta(run.before, run.after, "rtpu_launch_device_seconds")
    s = sum(v[0] for v in d.values())
    n = sum(v[1] for v in d.values())
    return s / n * 1e3 if n > 0 else None
