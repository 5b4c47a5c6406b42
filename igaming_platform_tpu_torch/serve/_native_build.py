"""Build the repository's native C++ sources with ``g++`` at first use, load them with ctypes.

The serving front's two native libraries come from the sources in
``native/`` at the repository root, read as they are: ``feature_store.cpp``
(the feature store, with the one-call risk.v1 request decode and gather)
and ``wire_codec.cpp`` (the one-call ScoreBatchResponse encode). Each
compiles on its own into ``build/native/lib<name>-<hash>.so``; the hash
covers the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. Nothing is compiled at import. A build
that fails raises with the compiler's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
NATIVE_SRC = ROOT / "native"
BUILD_DIR = ROOT / "build" / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def library_path(name: str) -> Path:
    """Where ``native/<name>.cpp`` builds to, keyed by its source and flags."""
    src = NATIVE_SRC / f"{name}.cpp"
    if not src.exists():
        raise FileNotFoundError(src)
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cpp``, compiled first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
                cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(NATIVE_SRC / f"{name}.cpp")]
                try:
                    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
                except FileNotFoundError as exc:
                    raise RuntimeError(f"native build of {name}: g++ not found") from exc
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(f"native build of {name} failed (g++ exited "
                                       f"{proc.returncode}):\n{proc.stderr}")
                os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
