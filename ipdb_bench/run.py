"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 ipdb_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout: see harness/bench.py.
"""
import time

T_START = time.perf_counter()

import sys                                                 # noqa: E402
from pathlib import Path                                   # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ipdb_bench.harness import bench                       # noqa: E402

if __name__ == "__main__":
    bench.setup_env()
    sys.exit(bench.main(sys.argv[1:], T_START))
