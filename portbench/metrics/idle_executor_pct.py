"""Share of the window the card sat idle while the flush thread staged
a launch, waited for a launch slot or enqueued it: the ``host_stage``,
``slot_wait`` and ``enqueue`` causes of the program's
``rtpu_device_idle_seconds_total`` over the window's length, per card.
The program times each idle gap between two launches with its own events
and puts it down to the host phase that held the later launch."""

from portbench.counters import delta

UNIT = "%"
LAYER = "executor"
MOVES = "ops_per_s"
FAMILIES = ("rtpu_device_idle_seconds_total", "rtpu_launch_device_seconds")
CAUSES = ("host_stage", "slot_wait", "enqueue")


def read(run):
    if run.before is None:
        return None
    launches = sum(v[1] for v in delta(run.before, run.after, "rtpu_launch_device_seconds").values())
    if launches == 0:  # no launch timed: nothing to read
        return None
    d = delta(run.before, run.after, "rtpu_device_idle_seconds_total")
    idle = sum(v for k, v in d.items() if k[0] in CAUSES)
    return 100.0 * idle / (run.seconds * int(run.cell["chips"]))
