"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload vo.map --seed 7 --seconds 30 --trace 0

From the root of a checkout on a machine with the CUDA card(s) the cell
asks for. Set-up is timed from here; the kernels' build cache is the
program's own ``nerf_vo_tpu_torch/_build/`` and every other cache goes
under ``.bench_cache/`` in the checkout, so that only a checkout's first
run builds. Exits non-zero, with no result, without the cards, or when a
module of JAX or of the JAX package is loaded.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.run(sys.argv[1:], t0=T0))
