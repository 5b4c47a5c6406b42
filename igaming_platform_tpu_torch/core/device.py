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


def host_to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``. To a card it goes through a
    fresh page-locked copy and an asynchronous copy on the current stream:
    PyTorch's pinned-memory cache hands that staging block out again only
    after the copy has completed, so the caller may reuse ``arr`` at once.
    On the CPU the tensor shares ``arr``'s memory."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return dev
