"""Flash attention: the Hopper kernels, their wrappers and their plain versions.

Forward. Replaces the two forward TPU kernels of
``igaming_platform_tpu/ops/pallas/flash_attention.py``: ``_kernel_resident``
(launched by ``_run_resident``, S <= 4096) and ``_kernel_tiled`` (launched by
``_run_tiled``, longer S). Both compute non-causal softmax attention with an
online softmax and also write the row logsumexp; so does the one kernel here,
``csrc/flash_attention_fwd.cu``. Its loop over key tiles in shared memory
stands in for both TPU variants, and it masks keys and rows past S itself,
so it takes every S >= 1.

Backward. Replaces ``_kernel_bwd_dq`` and ``_kernel_bwd_dkv`` (both launched
by ``_run_bwd``) with the two kernels of ``csrc/flash_attention_bwd.cu``: dQ,
one owner per query row, and dK/dV, one owner per key row, each recomputing
the probabilities from the saved LSE. They too cover every S, so the JAX
package's XLA recompute for S > 2048 (``_xla_bwd``) has no counterpart here
but the plain version.

All three are CUDA C++ for ``sm_90a``, built by ``ops/_build.py`` at first
use and called through ctypes. What bounds them on an H100: operations,
4, 6 and 8 * BH*S^2*Dh float32 flops on the CUDA cores (no TF32: the bars are
rtol/atol 2e-5 for the forward, 2e-4 for gradients). At the abuse
detector's shape (BH = 2 per account, S=64, Dh=32) the launch latency
dominates. See the sources' headers for the design.

- ``flash_attention_fwd(q, k, v) -> (o, lse)`` on [BH, S, Dh] float32, lse
  [BH, S, 1], as ``_run_resident``/``_run_tiled`` return them;
- ``flash_attention_bwd(q, k, v, o, lse, do) -> (dq, dk, dv)``, as
  ``_run_bwd`` returns them; it computes ``D = rowsum(dO * O)`` with a torch
  op, as the JAX package computes it in XLA outside its kernels;
- ``FlashAttention``, the ``torch.autograd.Function`` joining the two (the
  counterpart of ``_flash_with_vjp``), and ``flash_attention(q, k, v)`` on
  [B, H, S, Dh], which goes through it on every device;
- ``flash_attention_plain`` and ``flash_attention_bwd_plain``: dense
  versions, what the CPU takes and what the kernels are held to.

The wrappers take the plain version for CPU tensors only; for CUDA tensors
they launch the kernels or raise, also for a head size the kernels were not
built for. ``flash_attention_fwd.launches``,
``flash_attention_bwd.launches_dq`` and ``flash_attention_bwd.launches_dkv``
count kernel launches.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch
from torch.autograd.function import once_differentiable

HEAD_DIMS = (8, 16, 32, 64, 128)  # the kernels' instantiations

_VOIDP = ctypes.c_void_p
_count_lock = threading.Lock()
# Per source, its entry points and how many pointers each takes before
# (BH, S, Dh, scale, stream).
_ENTRY_POINTS = {
    "flash_attention_fwd": {"flash_attention_fwd_launch": 5},
    "flash_attention_bwd": {"flash_attention_bwd_dq_launch": 7,
                            "flash_attention_bwd_dkv_launch": 8},
}
_NAMES = ("q", "k", "v", "o", "do")


def _lib(name: str) -> ctypes.CDLL:
    from igaming_platform_tpu_torch.ops import _build

    lib = _build.load(name)
    for entry, n_ptrs in _ENTRY_POINTS[name].items():
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            fn.argtypes = [_VOIDP] * n_ptrs + [ctypes.c_int] * 3 + [ctypes.c_float, _VOIDP]
            fn.restype = ctypes.c_int
    return lib


def _launched(rc: int, fn, counter: str) -> None:
    """Raise if a launch was refused, else count it on the wrapper ``fn``."""
    if rc != 0:
        raise RuntimeError(f"{fn.__name__}: kernel launch failed with CUDA error {rc}")
    with _count_lock:
        setattr(fn, counter, getattr(fn, counter) + 1)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense attention over the last two dims: (O, row logsumexp [..., S, 1])."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    o = torch.matmul(torch.softmax(s, dim=-1), v)
    return o, torch.logsumexp(s, dim=-1, keepdim=True)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              o: torch.Tensor, lse: torch.Tensor,
                              do: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dQ, dK, dV) of dense attention from the saved O and row
    LSE, by exact recompute, as the JAX package's ``_xla_bwd``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(torch.matmul(q, k.transpose(-1, -2)) * scale - lse)
    dv = torch.matmul(p.transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = p * (dp - (do * o).sum(dim=-1, keepdim=True)) * scale
    return torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q), dv


def check_args(*tensors: torch.Tensor, op: str = "flash_attention_fwd") -> None:
    """Raise unless the kernels take these inputs (q, k, v, then O and dO for
    the backward): one [BH, S, Dh] shape, float32, contiguous, 16-byte
    aligned, one device, Dh in ``HEAD_DIMS``."""
    q = tensors[0]
    if q.dim() != 3 or any(t.shape != q.shape for t in tensors):
        shapes = ", ".join(f"{n} {tuple(t.shape)}" for n, t in zip(_NAMES, tensors))
        raise ValueError(f"{op}: {shapes} must be one [BH, S, Dh] shape")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{op}: head size {q.shape[-1]} is not one the kernels are built "
                         f"for {HEAD_DIMS}")
    for name, t in zip(_NAMES, tensors):
        if t.device != q.device:
            raise ValueError(f"{op}: {name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{op}: {name} is {t.dtype}, want torch.float32")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} is not contiguous and 16-byte aligned")


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
    rc = _lib("flash_attention_fwd").flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        bh, s, dh, 1.0 / math.sqrt(dh), stream)
    _launched(rc, flash_attention_fwd, "launches")
    return o, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor,
                        do: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[BH, S, Dh] float32 q, k, v, O, dO and LSE [BH, S, 1] -> (dQ, dK, dV)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    check_args(q, k, v, o, do, op="flash_attention_bwd")
    bh, s, dh = q.shape
    if (lse.shape != (bh, s, 1) or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} {lse.dtype} on "
                         f"{lse.device} is not a contiguous float32 [BH, S, 1] beside q")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if q.numel() == 0:
        return dq, dk, dv
    dmat = (do * o).sum(dim=-1)  # [BH, S]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale = 1.0 / math.sqrt(dh)
    lib = _lib("flash_attention_bwd")
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
           dmat.data_ptr())
    rc = lib.flash_attention_bwd_dq_launch(*ins, dq.data_ptr(), bh, s, dh, scale, stream)
    _launched(rc, flash_attention_bwd, "launches_dq")
    rc = lib.flash_attention_bwd_dkv_launch(*ins, dk.data_ptr(), dv.data_ptr(), bh, s, dh,
                                            scale, stream)
    _launched(rc, flash_attention_bwd, "launches_dkv")
    return dq, dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd.launches_dq = 0
flash_attention_bwd.launches_dkv = 0


class FlashAttention(torch.autograd.Function):
    """Attention on [BH, S, Dh] whose gradient is the backward kernels': the
    counterpart of the JAX package's ``_flash_with_vjp``. The forward saves
    q, k, v, O and the row LSE."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        o, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        # dO arrives through the caller's transpose and reshape.
        return flash_attention_bwd(*ctx.saved_tensors, do.contiguous())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, H, S, Dh] q, k, v -> [B, H, S, Dh] full (non-causal) attention,
    differentiable through ``FlashAttention``."""
    b, h, s, dh = q.shape
    o = FlashAttention.apply(q.reshape(b * h, s, dh), k.reshape(b * h, s, dh),
                             v.reshape(b * h, s, dh))
    return o.reshape(b, h, s, dh)
