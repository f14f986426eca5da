"""Run one benchmark cell once, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the program's kernels (cached in build/ inside the checkout), makes
the weights and the videos on the card from --seed, warms up the cell's own
shapes, measures --seconds, checks a sample of the answers against the
plain float32 reference, and prints one JSON line last: --trace 0 with the
cell's end-to-end metrics, --trace 1 with its per-layer metrics read from a
profiler trace. Exits non-zero, with no result, without the CUDA devices
the cell asks for, or when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()  # set-up starts here, the torch import included

import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(ROOT, "build", "bench_cache")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
sys.path[:0] = [BENCH, ROOT]

from harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
