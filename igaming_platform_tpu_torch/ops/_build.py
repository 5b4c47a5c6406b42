"""Build the port's CUDA sources with ``nvcc`` at first use, load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C entry point and compiles on its own
into ``build/torch_kernels/lib<name>-<hash>.so`` beside the package, for
``sm_90a``. The hash covers the source, every ``csrc/*.cuh`` header and
the compiler flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. Nothing is compiled when a module is imported: the first
call that needs a kernel builds it, and ``build`` compiles several sources
at once, one ``nvcc`` each, all started together.

No PyTorch header is compiled in, which keeps a build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """``nvcc`` on PATH, else under CUDA_HOME (default /usr/local/cuda)."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for found in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if found and os.path.exists(found):
            return found
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the port's kernels")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by sources and flags."""
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    h = hashlib.sha256()
    for path in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names) -> dict[str, dict]:
    """Compile every named source that is not built yet, all at once.

    Returns, per name, the seconds its ``nvcc`` took (0.0 when the library
    was already there) and the compiler's log (ptxas register and shared
    memory use). Raises with the log if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    report = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "log": ""}
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
