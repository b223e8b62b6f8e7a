"""Share of the profiled slice in which no kernel, copy or memset ran on
the card (averaged over the cards of the cell)."""

UNIT = "%"
LAYER = "device"
MOVES = "ops_per_s"


def read(run):
    p = run.profile
    if p is None or p["device_events"] == 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
