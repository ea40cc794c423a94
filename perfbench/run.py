"""Run one cell of the benchmark once; the last line of standard output is its result.

    python3 perfbench/run.py --workload large.infer_b32 --seed 7 --seconds 10 --trace 0

Every cache a run builds stays in the checkout: the port's nvcc libraries in
`build/lwdetr_tpu_torch/` (the port puts them there), Triton's and
PyTorch's extension caches under `build/perfbench/`.
"""
import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
os.environ["USE_FLAX"] = "0"  # no library may load JAX in this process
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(ROOT))

from perfbench.lib.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
