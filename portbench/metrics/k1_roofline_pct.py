"""Kernel K1's share of its roofline over the profiled slice: the least
time the card could take for the ``add_seq`` events answered in the
slice, over the summed time of the slice's ``cms_seq_kernel`` launches,
found by name in the trace.

The least time is the larger of two bounds against the card's published
peak (``portbench/peaks.py``): the bytes the algorithm needs over the HBM
bandwidth, and its integer operations over the INT32 rate, each counted
by the kind's ``element_bytes`` and ``element_ops``.  ``bound_by`` names
the bound that binds.  ``None`` where the trace holds no K1 launch."""

UNIT = "%"
LAYER = "bit operations"
MOVES = "ops_per_s"
KERNEL = "cms_seq_kernel"
OP = "add_seq"


def _k1_s(run):
    p = run.profile
    if p is None:
        return 0.0
    return sum(s for name, s in p["device_ops"] if KERNEL in name)


def _bounds(run):
    p = run.profile
    nbytes = nops = 0.0
    for r in run.window_calls():
        if r.op == OP and p["t0"] <= r.t_done <= p["t1"]:
            nbytes += r.n * run.kind.element_bytes(run.space, r.op)
            nops += r.n * run.kind.element_ops(run.space, r.op)
    return (nbytes / run.peaks["hbm_bytes_per_s"], nops / run.peaks["int32_ops_per_s"])


def read(run):
    k1 = _k1_s(run)
    if k1 <= 0 or not run.peaks:
        return None
    t_bytes, t_ops = _bounds(run)
    if max(t_bytes, t_ops) <= 0:
        return None
    return 100.0 * max(t_bytes, t_ops) / k1


def detail(run):
    t_bytes, t_ops = _bounds(run)
    return {"bound_by": "bytes" if t_bytes >= t_ops else "int32 ops",
            "bytes_bound_s": t_bytes, "ops_bound_s": t_ops, "kernel_s": _k1_s(run)}
