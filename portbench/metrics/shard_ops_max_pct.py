"""The busiest mesh shard's share of the ops routed to shards over the
window, from the program's ``rtpu_shard_ops``: 100 / S when reads spread
evenly over S shards."""

from portbench.counters import delta

UNIT = "%"
LAYER = "sharded executor"
MOVES = "ops_per_s"
FAMILIES = ("rtpu_shard_ops_total",)


def read(run):
    if run.before is None:
        return None
    d = delta(run.before, run.after, "rtpu_shard_ops_total")
    total = sum(d.values())
    return 100.0 * max(d.values()) / total if total > 0 else None
