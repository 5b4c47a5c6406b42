"""Flash-attention forward: the Hopper kernel, its wrapper and its plain version.

Replaces the two forward TPU kernels of
``igaming_platform_tpu/ops/pallas/flash_attention.py``: ``_kernel_resident``
(launched by ``_run_resident``, S <= 4096) and ``_kernel_tiled`` (launched by
``_run_tiled``, longer S). Both compute non-causal softmax attention with an
online softmax and also write the row logsumexp; so does the one kernel here,
``csrc/flash_attention_fwd.cu`` (CUDA C++ for ``sm_90a``, built by
``ops/_build.py`` at first use and called through ctypes). Its loop over key
tiles in shared memory stands in for both TPU variants, and it masks keys and
rows past S itself, so it takes every S >= 1.

What bounds it on an H100: operations, 4*BH*S^2*Dh float32 flops on the CUDA
cores (no TF32: the bar is rtol/atol 2e-5 against the dense einsum). At the
abuse detector's shape (BH = 2 per account, S=64, Dh=32) the launch latency
dominates. See the source's header for the design.

- ``flash_attention_fwd(q, k, v) -> (o, lse)`` on [BH, S, Dh] float32, lse
  [BH, S, 1], as ``_run_resident``/``_run_tiled`` return them;
- ``flash_attention(q, k, v)`` on [B, H, S, Dh], returning O as the JAX
  ``flash_attention`` does;
- ``flash_attention_plain``: dense ``QK^T*scale``, softmax, ``.V`` and the
  logsumexp, what the CPU takes and what the kernel is held to.

The wrappers take the plain version for CPU tensors only; for CUDA tensors
they launch the kernel or raise, also for a head size the kernel was not
built for. ``flash_attention_fwd.launches`` counts kernel launches. The
backward kernels (training) are not ported yet.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

HEAD_DIMS = (8, 16, 32, 64, 128)  # the kernel's instantiations

_VOIDP = ctypes.c_void_p
_count_lock = threading.Lock()


def _lib() -> ctypes.CDLL:
    from igaming_platform_tpu_torch.ops import _build

    lib = _build.load("flash_attention_fwd")
    fn = lib.flash_attention_fwd_launch
    if fn.argtypes is None:
        fn.argtypes = [_VOIDP] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, _VOIDP]
        fn.restype = ctypes.c_int
    return lib


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense attention over the last two dims: (O, row logsumexp [..., S, 1])."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    o = torch.matmul(torch.softmax(s, dim=-1), v)
    return o, torch.logsumexp(s, dim=-1, keepdim=True)


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless the kernel takes these inputs: [BH, S, Dh] float32,
    contiguous, 16-byte aligned, one device, Dh in ``HEAD_DIMS``."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} must be one [BH, S, Dh] shape")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head size {q.shape[-1]} is not one the "
                         f"kernel is built for {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention_fwd: {name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"flash_attention_fwd: {name} is {t.dtype}, want torch.float32")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_fwd: {name} is not contiguous and 16-byte aligned")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[BH, S, Dh] float32 q, k, v -> (O [BH, S, Dh], LSE [BH, S, 1])."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")
    check_args(q, k, v)
    bh, s, dh = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, s, 1), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        bh, s, dh, 1.0 / math.sqrt(dh), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd: kernel launch failed with CUDA error {rc}")
    with _count_lock:
        flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, H, S, Dh] q, k, v -> [B, H, S, Dh] full (non-causal) attention."""
    b, h, s, dh = q.shape
    o, _ = flash_attention_fwd(q.reshape(b * h, s, dh), k.reshape(b * h, s, dh),
                               v.reshape(b * h, s, dh))
    return o.reshape(b, h, s, dh)
