"""Entry point of the port's benchmark (see port_bench/harness.py).

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout. Set-up time is counted from here.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout, not this folder, is the import root (this folder holds
# modules whose names the standard library also uses)
sys.path[0] = ROOT
# caches of compiled code stay inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = (
    os.path.join(ROOT, "build", "triton_cache"))
os.environ["TORCH_EXTENSIONS_DIR"] = (
    os.path.join(ROOT, "build", "torch_extensions"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

if __name__ == "__main__":
    from port_bench.harness import main
    sys.exit(main(sys.argv[1:], T_START))
