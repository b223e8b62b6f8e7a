"""Elements (keys tested or added, bits got or set) of the calls answered
inside the window, summed over every client, per second of the window."""

UNIT = "ops/s"
LAYER = "end to end"
MOVES = "ops_per_s"


def read(run):
    return sum(r.n for r in run.window_calls()) / run.seconds
