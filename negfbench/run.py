"""Run one cell of the benchmark of gaunegf_tpu_torch on the card.

    python negfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result's JSON object; the numbers compared for ``correct`` close standard
error.  Exits 2 without a result when the cell's CUDA devices are not
there, 3 when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from negfbench import harness  # noqa: E402  (the standard library only)

THREADS = 4

if __name__ == "__main__":
    allocator = harness.prepare_host(
        THREADS, cache=os.path.join(ROOT, ".negfbench_cache"))
    import torch
    torch.set_num_threads(THREADS)
    sys.exit(harness.main(sys.argv[1:], T_START, allocator))
