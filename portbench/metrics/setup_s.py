"""Process start to window start: imports, the CUDA context, the pools,
the deployment's loading and the warm-up calls."""

UNIT = "s"
LAYER = "end to end"
MOVES = "setup_s"


def read(run):
    return run.setup_s
