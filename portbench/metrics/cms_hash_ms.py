"""Mean time a count-min add call spent hashing its keys on the host
(MurmurHash3 and the mod-w reduction): the ``hash`` phase of the
program's ``rtpu_call_phase_seconds`` over the window, for the
``CountMinSketch.add_all*`` calls (change of sum over change of count).
``None`` where the program records no such phase."""

from portbench.counters import delta

UNIT = "ms"
LAYER = "client"
MOVES = "ops_per_s"
FAMILIES = ("rtpu_call_phase_seconds",)
OPS = "CountMinSketch.add_all"
PHASE = "hash"


def read(run):
    if run.before is None:
        return None
    d = delta(run.before, run.after, "rtpu_call_phase_seconds")
    picked = [v for k, v in d.items() if k[0].startswith(OPS) and k[1] == PHASE]
    n = sum(v[1] for v in picked)
    return sum(v[0] for v in picked) / n * 1e3 if n > 0 else None
