"""Run one cell of the port's benchmark once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (see ``README.md``); the compared numbers and their limits are the
last lines of standard error.  Exits non-zero, printing no result, where
the cell asks for more CUDA devices than the machine has, or where JAX
or the JAX package got loaded.
"""

import time

T0 = time.perf_counter()  # set-up counts from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# build and kernel caches at fixed paths inside the checkout (the port
# builds its kernels into its own _build/ there)
os.environ.setdefault("TRITON_CACHE_DIR", str(CHECKOUT / "portbench" / ".cache" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CHECKOUT / "portbench" / ".cache" / "torch_extensions"))
sys.path.insert(0, str(CHECKOUT))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
