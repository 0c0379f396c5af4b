"""The benchmark of bronko's PyTorch and CUDA port: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the CUDA cards the
cell asks for. Prints progress and the compared numbers on standard error
and, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics, device, breakdown (traced runs), checks.
Exits non-zero, printing no result, without the cards, when the program
is missing, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import guard  # noqa: E402

guard.install()

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
