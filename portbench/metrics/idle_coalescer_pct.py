"""Share of the window the card sat idle while a launch's first call
waited for admission or its ops sat queued in the coalescer: the
``admit_wait`` and ``coalesce_wait`` causes of the program's
``rtpu_device_idle_seconds_total`` over the window's length, per card.
The program times each idle gap between two launches with its own events
and puts it down to the host phase that held the later launch."""

from portbench.counters import delta

UNIT = "%"
LAYER = "coalescer"
MOVES = "ops_per_s"
FAMILIES = ("rtpu_device_idle_seconds_total", "rtpu_launch_device_seconds")
CAUSES = ("admit_wait", "coalesce_wait")


def read(run):
    if run.before is None:
        return None
    launches = sum(v[1] for v in delta(run.before, run.after, "rtpu_launch_device_seconds").values())
    if launches == 0:  # no launch timed: nothing to read
        return None
    d = delta(run.before, run.after, "rtpu_device_idle_seconds_total")
    idle = sum(v for k, v in d.items() if k[0] in CAUSES)
    return 100.0 * idle / (run.seconds * int(run.cell["chips"]))
