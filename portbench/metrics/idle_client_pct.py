"""Share of the window the card sat idle while the host was in the
caller's own code before a launch's first call began, or in that call's
encode and engine work: the ``caller`` and ``encode`` causes of the
program's ``rtpu_device_idle_seconds_total`` over the window's length, per
card, less the part of the window's first gap that lies before it.  The program times each idle gap between two launches with its own
events and puts it down to the host phase that held the later launch."""

from portbench.counters import delta

UNIT = "%"
LAYER = "client"
MOVES = "ops_per_s"
FAMILIES = ("rtpu_device_idle_seconds_total", "rtpu_launch_device_seconds")
CAUSES = ("caller", "encode")


def read(run):
    if run.before is None:
        return None
    launches = sum(v[1] for v in delta(run.before, run.after, "rtpu_launch_device_seconds").values())
    if launches == 0:  # no launch timed: nothing to read
        return None
    d = delta(run.before, run.after, "rtpu_device_idle_seconds_total")
    caller = d.get(("caller",), 0.0)
    # The program counts a gap when the launch after it retires.  The gap
    # before the window's first launch opened when the warm-up's last
    # launch ended, and the program puts it down to the caller: its part
    # before the window (from the warm-up's last answer to the window's
    # start, where a traced run starts its profiler) is not the window's.
    warm = [r.t_done for r in run.records if r.phase != "window"]
    if warm:
        caller = max(0.0, caller - max(0.0, run.t_start - max(warm)))
    idle = caller + sum(v for k, v in d.items() if k[0] in CAUSES and k[0] != "caller")
    return 100.0 * idle / (run.seconds * int(run.cell["chips"]))
