"""Share of the window the flush spent staging launches on the host (pad,
concatenate, the pinned copy): the change of the ``host_stage`` phase's
sum in the program's ``rtpu_op_phase_seconds`` over the window's
length."""

from portbench.counters import delta

UNIT = "%"
LAYER = "executor"
MOVES = "ops_per_s"
FAMILIES = ("rtpu_op_phase_seconds",)


def read(run):
    if run.before is None:
        return None
    d = delta(run.before, run.after, "rtpu_op_phase_seconds")
    n = sum(v[1] for k, v in d.items() if k[1] == "host_stage")
    if n == 0:
        return None
    return 100.0 * sum(v[0] for k, v in d.items() if k[1] == "host_stage") / run.seconds
