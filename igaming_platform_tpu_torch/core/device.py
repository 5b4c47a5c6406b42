"""Device selection for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``. It runs on
the CPU only when the caller asks for it; with no card and no explicit CPU
request it raises instead of quietly scoring on the host.
"""

from __future__ import annotations

import numpy as np
import torch

_constants: dict[tuple[str, torch.device], torch.Tensor] = {}


def constant(key: str, value: np.ndarray, device: torch.device) -> torch.Tensor:
    """A module's numpy constant as a tensor on ``device``, copied there on
    first use and reused after, so a step makes no host-to-device copy for
    its masks and weights. ``key`` names the constant; callers pass the
    same array under a key every time."""
    k = (key, device)
    t = _constants.get(k)
    if t is None:
        t = torch.from_numpy(value).to(device)
        _constants[k] = t
    return t


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return dev
