"""The MLP layers' dense product, with a sum order no batch size changes.

``dense(x, w_bf16, b)`` computes ``bf16(x) @ w_bf16 + b`` in float32: the
contract of the JAX package's ``models/mlp.py:64-74`` (``_dense``: bf16
operands, float32 accumulation), which XLA compiles there. Every product of
two bf16 values is exact in float32, so only the order of the additions
decides the bits. That order is fixed here by nothing but k:

- ``PARTIALS`` (8) partial sums interleave: partial p adds the products of
  k = p, p + 8, p + 16, ... in ascending k, from +0.0;
- the partials fold in a fixed tree, ``((p0 + p1) + (p2 + p3)) + ((p4 + p5)
  + (p6 + p7))``; then the bias is added.

A row therefore gives the same bits alone or inside any batch, on the card
as on the CPU (cuBLAS's float32 GEMM picks its algorithm, and its order, by
M). Interleaved partials folded in a tree also keep the error of a
256-term sum near XLA's blocked sum, where one sequential chain would not.

On a CUDA tensor ``dense`` launches ``csrc/dense_bf16.cu`` (CUDA C++ for
``sm_90a``, built by ``ops/_build.py`` at first use, called through ctypes)
or raises; on a CPU tensor it takes ``dense_plain``, which adds in the same
order with torch ops, vectorised over the partials: K / 8 steps of an
in-place multiply-add over a [B, 8, N] accumulator. ``dense.launches``
counts kernel launches.

Not a TPU kernel: it is the repair of a fault of the port (a row's
``ml_score`` depended on its batch), not a port of a Pallas call.
"""

from __future__ import annotations

import ctypes
import threading

import torch

PARTIALS = 8  # csrc/dense_bf16.cu kPartials

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
# Launches come from the batcher's thread, the pipeline's stage workers and
# direct calls.
_count_lock = threading.Lock()


def _lib() -> ctypes.CDLL:
    from igaming_platform_tpu_torch.ops import _build

    lib = _build.load("dense_bf16")
    fn = lib.dense_bf16_launch
    if fn.argtypes is None:
        fn.argtypes = [_VOIDP] * 4 + [_INT] * 3 + [_VOIDP]
        fn.restype = _INT
    return lib


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest bfloat16 value (ties to even), as float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def dense_plain(x: torch.Tensor, w_bf16: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: [B, K] float32, [K, N] bf16-rounded
    float32 and [N] -> [B, N] float32, in the kernel's order."""
    xb = round_bf16(x)
    rows, k = xb.shape
    n = w_bf16.shape[1]
    pad = -k % PARTIALS
    if pad:
        # Zero products leave a partial that is never -0.0 as it was.
        xb = torch.nn.functional.pad(xb, (0, pad))
        w_bf16 = torch.nn.functional.pad(w_bf16, (0, 0, 0, pad))
    steps = (k + pad) // PARTIALS
    xr = xb.reshape(rows, steps, PARTIALS, 1)
    wr = w_bf16.reshape(steps, PARTIALS, n)
    acc = torch.zeros((rows, PARTIALS, n), dtype=torch.float32, device=x.device)
    for j in range(steps):
        acc.addcmul_(xr[:, j], wr[j])
    while acc.shape[1] > 1:
        acc = acc[:, 0::2] + acc[:, 1::2]
    return acc[:, 0] + b


def _check(x: torch.Tensor, w_bf16: torch.Tensor, b: torch.Tensor) -> None:
    for name, t in (("x", x), ("w", w_bf16), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"dense: {name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"dense: {name} is {t.dtype}, want torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"dense: {name} is not contiguous")
    if x.dim() != 2 or w_bf16.dim() != 2 or x.shape[1] != w_bf16.shape[0] \
            or b.shape != (w_bf16.shape[1],):
        raise ValueError(f"dense: x {tuple(x.shape)}, w {tuple(w_bf16.shape)} and "
                         f"b {tuple(b.shape)} disagree")


def dense(x: torch.Tensor, w_bf16: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, K] float32 -> [B, N] float32: ``bf16(x) @ w_bf16 + b`` in the
    fixed order. ``w_bf16`` must hold bf16-rounded values."""
    if x.device.type == "cpu":
        return dense_plain(x, w_bf16, b)
    if x.device.type != "cuda":
        raise ValueError(f"dense: unsupported device {x.device}")
    x = x.contiguous()
    _check(x, w_bf16, b)
    rows, k = x.shape
    out = torch.empty((rows, w_bf16.shape[1]), dtype=torch.float32, device=x.device)
    if rows:
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().dense_bf16_launch(x.data_ptr(), w_bf16.data_ptr(), b.data_ptr(),
                                      out.data_ptr(), rows, k, w_bf16.shape[1], stream)
        if rc != 0:
            raise RuntimeError(f"dense: kernel launch failed with CUDA error {rc}")
        with _count_lock:
            dense.launches += 1
    return out


dense.launches = 0
