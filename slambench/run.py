"""The benchmark of ``semantic_slam_mapping_torch`` on one cell.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA cards; it
fails without them. The last line of standard output is the result (see
``core/result.py``); the numbers compared with the plain reference are the
last lines of standard error.
"""

import os
import sys
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_CACHE = _HERE / ".cache"
# the program's build and kernel caches, at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(_CACHE / "nv")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(_HERE.parent))

from slambench.core.runner import main, process_start  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t_start=process_start()))
