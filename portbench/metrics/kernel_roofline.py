"""The kernels' share of the card's roofline over the profiled slice: the
least time the card could take for the elements answered in the slice,
over the summed time of every kernel in it (all cards).

The least time is the larger of two bounds, each against the card's
published peak (``portbench/peaks.py``): the bytes the algorithm needs
over the HBM bandwidth, and its integer operations over the INT32 rate.
The counts come from the algorithm, by the kind's ``element_bytes`` and
``element_ops``, so they stay the same whatever a later program
launches.  ``bound_by`` names the bound that binds."""

UNIT = "%"
LAYER = "bit operations"
MOVES = "ops_per_s"


def work(run):
    """(bytes, integer ops) of the calls answered inside the slice."""
    p = run.profile
    nbytes = nops = 0.0
    for r in run.window_calls():
        if p["t0"] <= r.t_done <= p["t1"]:
            nbytes += r.n * run.kind.element_bytes(run.space, r.op)
            nops += r.n * run.kind.element_ops(run.space, r.op)
    return nbytes, nops


def _bounds(run):
    nbytes, nops = work(run)
    return (nbytes / run.peaks["hbm_bytes_per_s"], nops / run.peaks["int32_ops_per_s"])


def read(run):
    p = run.profile
    if p is None or p["kernel_s"] <= 0 or not run.peaks:
        return None
    t_bytes, t_ops = _bounds(run)
    if max(t_bytes, t_ops) <= 0:
        return None
    return 100.0 * max(t_bytes, t_ops) / p["kernel_s"]


def detail(run):
    t_bytes, t_ops = _bounds(run)
    return {"bound_by": "bytes" if t_bytes >= t_ops else "int32 ops",
            "bytes_bound_s": t_bytes, "ops_bound_s": t_ops,
            "kernel_s": run.profile["kernel_s"]}
