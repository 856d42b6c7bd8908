"""Run one cell of the port's benchmark (see portbench/README.md).

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root in place of this folder: the harness imports
# `portbench` and the port as packages
sys.path[0] = str(Path(__file__).resolve().parents[1])

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t_start=T_START))
