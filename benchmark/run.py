"""Run one benchmark cell once and print its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: the program under test is the
``topopteval_tpu_torch`` package beside this folder.  Needs a CUDA
device; exits non-zero with no result line without one.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed paths inside the checkout; the port's
# own nvcc and g++ builds already go to build/ there
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["USE_FLAX"] = "0"
# host threads fixed, the same on every machine: OpenBLAS, OpenMP and
# torch's CPU pool each take 4 of the host's cores
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "4"
os.environ["TOPOPTEVAL_VERBOSE"] = "0"
sys.path.insert(0, ROOT)

from benchmark.core.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
