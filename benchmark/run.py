"""The benchmark of tetraear_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the program and BENCHMARK.json.
See benchmark/README.md.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from tebench.harness import main  # noqa: E402

if __name__ == "__main__":
    rc = main(sys.argv[1:], T_START)
    sys.stdout.flush()
    sys.stderr.flush()
    # the check's lines stay the last of standard error: nothing the
    # libraries print while the interpreter tears down comes after them
    os._exit(rc)
