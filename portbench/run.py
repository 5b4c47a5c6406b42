"""Run one benchmark cell once on the card and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(also ``python3 -m portbench.run ...``), from the root of a checkout. See
``portbench/README.md``.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# Build and kernel caches at fixed paths inside the checkout, set before
# torch is imported; the port's own caches (build/torch_kernels,
# build/native) are there already.
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(ROOT / "build" / "portbench" / _sub)
# Run as a script, the script's own folder heads sys.path, where its
# modules would shadow the standard library's: the checkout's root goes
# there instead.
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "portbench"]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    _start = harness.process_start_time()
    sys.exit(harness.main(sys.argv[1:], _start))
