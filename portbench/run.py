"""Run one cell of the benchmark:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``python3 -m portbench.run`` works too).  The
last line of standard output is the result object; the numbers compared,
each with its limit, are the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
