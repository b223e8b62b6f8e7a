"""``python -m portbench``: see ``portbench/run.py``."""

import time

T_PROCESS = time.perf_counter()

import sys  # noqa: E402

from portbench.run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_process=T_PROCESS))
