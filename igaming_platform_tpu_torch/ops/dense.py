"""Dense products with a sum order no batch size changes: bf16 and float32.

``dense(x, w_bf16, b)`` computes ``bf16(x) @ w_bf16 + b`` in float32: the
contract of the JAX package's ``models/mlp.py:64-74`` (``_dense``: bf16
operands, float32 accumulation), which XLA compiles there. Every product of
two bf16 values is exact in float32, so only the order of the additions
decides the bits. ``dense_f32(x, w, b)`` computes ``x @ w + b`` on float32
operands, the sequence model's layers (``models/sequence.py``'s ``Affine``):
each product is rounded on its own and then added, a multiply and an add,
never one fused op. In both, the order is fixed by nothing but k:

- ``PARTIALS`` (8) partial sums interleave: partial p adds the products of
  k = p, p + 8, p + 16, ... in ascending k, from +0.0;
- the partials fold in a fixed tree, ``((p0 + p1) + (p2 + p3)) + ((p4 + p5)
  + (p6 + p7))``; then the bias is added.

A row therefore gives the same bits alone or inside any batch, on the card
as on the CPU (cuBLAS's float32 GEMM picks its algorithm, and its order, by
M). Interleaved partials folded in a tree also keep the error of a
256-term sum near XLA's blocked sum, where one sequential chain would not.

On a CUDA tensor each launches its mode of ``csrc/dense_fixed.cu`` (CUDA C++
for ``sm_90a``, built by ``ops/_build.py`` at first use, called through
ctypes) or raises; on a CPU tensor it takes its plain version
(``dense_plain``, ``dense_f32_plain``), which adds in the same order with
torch ops, vectorised over the partials: K / 8 steps over a [B, 8, N]
accumulator. ``dense.launches`` and ``dense_f32.launches`` count kernel
launches.

``dense_train(x, w, b)`` is ``dense`` for training: ``w`` is a float32
master weight, rounded to bf16 on every call, and ``DenseFn``'s backward
gives the JAX package's gradients of ``_dense``, each product rounded to
bf16 as XLA's program rounds it (below). ``dense_f32_train`` is
``dense_f32`` for training (``DenseF32Fn``: float32 gradients).

A launch runs under its operands' device (``torch.cuda.device(x.device)``),
on that device's current stream, and refuses operands on another card.

Not a TPU kernel: it is the repair of a fault of the port (a row's
``ml_score``, and the sequence model's score, depended on its batch), not a
port of a Pallas call.
"""

from __future__ import annotations

import ctypes

import torch

from igaming_platform_tpu_torch.obs import devtrace, perfmodel

PARTIALS = 8  # csrc/dense_fixed.cu kPartials

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int


def _lib() -> ctypes.CDLL:
    from igaming_platform_tpu_torch.ops import _build

    lib = _build.load("dense_fixed")
    for fn in (lib.dense_bf16_launch, lib.dense_f32_launch):
        if fn.argtypes is None:
            fn.argtypes = [_VOIDP] * 4 + [_INT] * 3 + [_VOIDP]
            fn.restype = _INT
    return lib


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest bfloat16 value (ties to even), as float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _interleaved(x: torch.Tensor, w: torch.Tensor):
    """x [B, K] and w [K, N], zero-padded to whole cycles of the partials, as
    [B, steps, PARTIALS, 1] and [steps, PARTIALS, N]. Zero products leave a
    partial that is never -0.0 as it was."""
    rows, k = x.shape
    pad = -k % PARTIALS
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
        w = torch.nn.functional.pad(w, (0, 0, 0, pad))
    steps = (k + pad) // PARTIALS
    return x.reshape(rows, steps, PARTIALS, 1), w.reshape(steps, PARTIALS, w.shape[1])


def _fold(acc: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, PARTIALS, N] partials -> [B, N]: the fixed tree, then the bias."""
    while acc.shape[1] > 1:
        acc = acc[:, 0::2] + acc[:, 1::2]
    return acc[:, 0] + b


def dense_plain(x: torch.Tensor, w_bf16: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``dense``: [B, K] float32, [K, N]
    bf16-rounded float32 and [N] -> [B, N] float32, in the kernel's order.
    The products are exact, so ``addcmul_`` rounds as an add would."""
    xr, wr = _interleaved(round_bf16(x), w_bf16)
    acc = torch.zeros((x.shape[0], PARTIALS, wr.shape[2]), dtype=torch.float32, device=x.device)
    for j in range(wr.shape[0]):
        acc.addcmul_(xr[:, j], wr[j])
    return _fold(acc, b)


def dense_f32_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``dense_f32``: float32 [B, K], [K, N] and
    [N] -> [B, N], in the kernel's order; each product rounded, then added
    (two ops: a fused multiply-add would round once)."""
    xr, wr = _interleaved(x, w)
    acc = torch.zeros((x.shape[0], PARTIALS, wr.shape[2]), dtype=torch.float32, device=x.device)
    prod = torch.empty_like(acc)  # one buffer for every step's products
    for j in range(wr.shape[0]):
        torch.mul(xr[:, j], wr[j], out=prod)
        acc.add_(prod)
    return _fold(acc, b)


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


def _launch(entry: str, counted, name: str, x: torch.Tensor, w: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    _check(x, w, b)
    rows, k = x.shape
    # The launch goes to the current device: make it x's card, whichever
    # card the caller's thread has current.
    with torch.cuda.device(x.device):
        out = torch.empty((rows, w.shape[1]), dtype=torch.float32, device=x.device)
        if rows:
            stream = torch.cuda.current_stream(x.device).cuda_stream
            # Counted (and marked on an armed device timeline) as it launches;
            # launches come from the batcher's thread, the pipeline's stage
            # workers and direct calls.
            rc = devtrace.launch(counted, "launches", name, x.device, getattr(_lib(), entry),
                                 x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                                 rows, k, w.shape[1], stream)
            if rc != 0:
                raise RuntimeError(f"{entry}: kernel launch failed with CUDA error {rc}")
    return out


def dense(x: torch.Tensor, w_bf16: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, K] float32 -> [B, N] float32: ``bf16(x) @ w_bf16 + b`` in the
    fixed order. ``w_bf16`` must hold bf16-rounded values."""
    perfmodel.note_work("dense", *perfmodel.dense_work(x.shape[0], *w_bf16.shape))
    if x.device.type == "cpu":
        return devtrace.plain("dense", dense_plain, x, w_bf16, b)
    if x.device.type != "cuda":
        raise ValueError(f"dense: unsupported device {x.device}")
    return _launch("dense_bf16_launch", dense, "dense", x, w_bf16, b)


def dense_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, K] float32 -> [B, N] float32: ``x @ w + b`` in the fixed order,
    each product rounded before it is added."""
    perfmodel.note_work("dense_f32", *perfmodel.dense_work(x.shape[0], *w.shape))
    if x.device.type == "cpu":
        return devtrace.plain("dense_f32", dense_f32_plain, x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"dense_f32: unsupported device {x.device}")
    return _launch("dense_f32_launch", dense_f32, "dense_f32", x, w, b)


dense.launches = 0
dense_f32.launches = 0
devtrace.register_counter("dense", dense)
devtrace.register_counter("dense_f32", dense_f32)


class DenseFn(torch.autograd.Function):
    """``dense(x, round_bf16(w), b)`` with the gradients ``jax.grad`` takes
    through ``_dense`` (``models/mlp.py:64-74`` of the JAX package). Its
    jaxpr holds, for a float32 cotangent ``dy`` [B, N]:

    - ``dw = f32(bf16(bf16(x)^T . dy))`` and ``dx = f32(bf16(dy . bf16(w)^T))``:
      each product accumulated in float32 from the float32 cotangent, then
      rounded to bf16 (the transpose of the forward's ``astype(bfloat16)``);
    - ``db = sum_B dy`` in float32.

    Autograd through ``.to(torch.bfloat16)`` would round the cotangent
    instead. The backward products run outside the fixed-order kernel, as
    JAX's run outside any Pallas call: ``torch.matmul`` (with TF32 off on a
    card, as ``chip_smoke.py`` sets it)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        w_bf16 = round_bf16(w).contiguous()
        ctx.save_for_backward(round_bf16(x), w_bf16)
        return dense(x, w_bf16, b)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x_bf16, w_bf16 = ctx.saved_tensors
        dy = dy.contiguous()
        # Each gradient product computed is one of the forward's size.
        flops, nbytes = perfmodel.dense_work(x_bf16.shape[0], *w_bf16.shape)
        products = int(ctx.needs_input_grad[0]) + int(ctx.needs_input_grad[1])
        perfmodel.note_work("dense_bwd", products * flops, products * nbytes)
        dx = round_bf16(torch.matmul(dy, w_bf16.t())) if ctx.needs_input_grad[0] else None
        dw = round_bf16(torch.matmul(x_bf16.t(), dy)) if ctx.needs_input_grad[1] else None
        db = dy.sum(0) if ctx.needs_input_grad[2] else None
        return dx, dw, db


def dense_train(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, K] float32 -> [B, N] float32: ``dense`` on the bf16 rounding of the
    float32 master weight ``w``, differentiable as ``DenseFn`` says."""
    return DenseFn.apply(x, w, b)


class DenseF32Fn(torch.autograd.Function):
    """``dense_f32(x, w, b)`` with the gradients of ``x @ w + b`` in float32:
    ``dx = dy . w^T``, ``dw = x^T . dy``, ``db = sum_B dy``. The backward
    products run outside the fixed-order kernel, as JAX's run outside any
    Pallas call: ``torch.matmul`` (with TF32 off on a card)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        ctx.save_for_backward(x, w)
        return dense_f32(x, w.contiguous(), b.contiguous())

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        flops, nbytes = perfmodel.dense_work(x.shape[0], *w.shape)
        products = int(need_x) + int(need_w)
        perfmodel.note_work("dense_f32_bwd", products * flops, products * nbytes)
        return (torch.matmul(dy, w.t()) if need_x else None,
                torch.matmul(x.t(), dy) if need_w else None,
                dy.sum(0) if need_b else None)


def dense_f32_train(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, K] float32 -> [B, N] float32: ``dense_f32``, differentiable as
    ``DenseF32Fn`` says (the sequence model's layers, the routed ensemble's
    router and the pipeline's stages)."""
    return DenseF32Fn.apply(x, w, b)
