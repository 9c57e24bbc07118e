"""Run one benchmark cell once: ``python bench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` from the root of a checkout (see
``bench/README.md``)."""
import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root, not this directory, leads the import path: no
# module of the benchmark's may shadow a library's
sys.path[0] = str(Path(__file__).resolve().parents[1])

from bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T0))
