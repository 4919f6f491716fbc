"""The port's benchmark: run one cell once and print its result as the last
line of standard output.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cells, configurations, traffic mixes and metrics are those of
BENCHMARK.json at the root; benchmark/README.md says how the harness finds
them and how to add one."""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# one process with few threads: the host's numerical libraries single
# threaded (the render pool's processes inherit it)
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from benchmark.harness import main

    sys.exit(main.main(sys.argv[1:], T_PROCESS))
