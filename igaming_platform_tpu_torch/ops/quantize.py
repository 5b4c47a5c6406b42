"""Int8 serving: the load-time quantizers, the int8 feature wire and the int8 models.

Counterpart of ``igaming_platform_tpu/ops/quantize.py``. Three parts:

- **load-time quantizers** (``quantize_weight``, ``quantize_mlp``,
  ``quantize_gbdt``, ``quantize_multitask_fraud``, ``quantize_checkpoint``)
  run on the host in float32 numpy, once per install. They take and return
  params trees in the JAX package's layout (nested dicts and lists of numpy
  arrays) and give the JAX quantizers' int8 codes and float32 scales bit for
  bit; ``convert.from_jax_params`` carries the result to the port's backends
  (``mlp_int8``, ``gbdt_int8``, ``mlp+gbdt_int8``, ``multitask_int8``);
- **the int8 wire** (``WIRE_DTYPE=int8``): ``wire_quantize_int8`` on the
  host (numpy, before the copy to the device) and ``wire_dequantize_int8``
  on the device, each feature in its calibrated signed-log or linear domain
  (``W8_CEIL``, ``W8_LINEAR``);
- **the int8 models** on the device: ``mlp_predict_int8`` (per-row dynamic
  int8 activations against per-channel int8 weights) and
  ``gbdt_predict_int8`` (the quantized forest on the forest kernel).

Numerics. A float32 product of int8-valued operands is exact, whatever the
order of the sums, while the sum of the products' magnitudes stays under
2^24: at codes of at most 127 that holds for D_in <= 1040, which
``quantize_mlp`` asserts. So ``dense_int8`` multiplies the codes as float32
(cuBLAS on a card, with TF32 off: ``torch._int_mm`` refuses these shapes),
bit-equal to the JAX package's int32 accumulation. The run-time row scale
divides by 127 as a device tensor: on CUDA a division by a Python scalar
multiplies by its rounded reciprocal, and a scale one ulp off moves the .5
ties of ``round(x / scale)``.

The quantized forest compares ``bf16(x[b, feat])`` with
``bf16(bf16(thr_q) * bf16(thr_scale))`` and sums ``leaves_q * leaf_scale``
in float32. A bfloat16 value is exact in float32, so the port rounds the
rows to bfloat16 once on the device and hands the forest kernel the float32
images of those thresholds and leaves, computed at install
(``forest_images``): its compares take the same branches.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from igaming_platform_tpu_torch.core import numerics
from igaming_platform_tpu_torch.core.device import constant
from igaming_platform_tpu_torch.core.features import NUM_FEATURES, F
from igaming_platform_tpu_torch.models.gbdt import gbdt_predict

Params = dict[str, Any]

# The float32 sums of int8-valued products stay exact while
# D_in * 127 * 127 < 2^24.
MAX_EXACT_FAN_IN = (1 << 24) // (127 * 127)

_F32 = np.float32


def _div127(a: np.ndarray) -> np.ndarray:
    return (a / _F32(127.0)).astype(_F32)


# ---------------------------------------------------------------------------
# Load-time quantizers (host, float32 numpy)


def quantize_weight(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[D_in, D_out] float32 -> (int8 weights, [D_out] float32 per-channel scales)."""
    w = np.asarray(w, _F32)
    absmax = np.max(np.abs(w), axis=0)
    scale = np.where(absmax > 0, _div127(absmax), _F32(1.0)).astype(_F32)
    wq = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return wq, scale


def quantize_mlp(params: Params, calibration_x: np.ndarray | None = None) -> Params:
    """An ``init_mlp``-shaped tree ({"layers": [{"w", "b"}, ...]}) -> its int8
    tree ({"layers": [{"wq", "scale", "b"}, ...], "input_scale", "quantized"}).
    With ``calibration_x`` (a representative normalized feature batch) the
    per-column absmax is folded into the first layer's weights and divided
    out of the activations at run time."""
    first_w = np.asarray(params["layers"][0]["w"], _F32)
    input_scale = None
    if calibration_x is not None:
        absmax = np.max(np.abs(np.asarray(calibration_x, _F32)), axis=0)
        input_scale = np.where(absmax > 0, absmax, _F32(1.0)).astype(_F32)
        first_w = first_w * input_scale[:, None]
    layers = []
    for i, layer in enumerate(params["layers"]):
        w = first_w if i == 0 else np.asarray(layer["w"], _F32)
        if w.shape[0] > MAX_EXACT_FAN_IN:
            raise ValueError(f"layer {i} has fan-in {w.shape[0]}: the float32 int8 product "
                             f"is exact only up to {MAX_EXACT_FAN_IN}")
        wq, scale = quantize_weight(w)
        layers.append({"wq": wq, "scale": scale, "b": np.asarray(layer["b"], _F32)})
    return {"layers": layers, "input_scale": input_scale, "quantized": True}


def quantize_gbdt(params: Params) -> Params:
    """An oblivious-forest tree ({"feat", "thr", "leaves", "bias"}) -> its
    int8 tree: per-tree symmetric int8 codes of thresholds and leaves with
    float32 scales."""
    thr = np.asarray(params["thr"], _F32)
    leaves = np.asarray(params["leaves"], _F32)
    t_absmax = np.max(np.abs(thr), axis=1, keepdims=True)
    t_scale = np.where(t_absmax > 0, _div127(t_absmax), _F32(1.0)).astype(_F32)
    l_absmax = np.max(np.abs(leaves), axis=1, keepdims=True)
    l_scale = np.where(l_absmax > 0, _div127(l_absmax), _F32(1.0)).astype(_F32)
    return {
        "feat": np.asarray(params["feat"]),
        "thr_q": np.clip(np.rint(thr / t_scale), -127, 127).astype(np.int8),
        "thr_scale": t_scale,
        "leaves_q": np.clip(np.rint(leaves / l_scale), -127, 127).astype(np.int8),
        "leaf_scale": l_scale,
        "bias": np.asarray(params["bias"], _F32),
        "quantized": True,
    }


def quantize_multitask_fraud(params: Params, calibration_x: np.ndarray | None = None) -> Params:
    """A trained multitask tree's fraud path (trunk + fraud head) as an int8 MLP tree."""
    return quantize_mlp({"layers": [*params["trunk"]["layers"], params["fraud_head"]]},
                        calibration_x=calibration_x)


def quantize_checkpoint(params: Params, ml_backend: str,
                        calibration_x: np.ndarray | None = None) -> tuple[Params, str]:
    """A serving params tree and backend -> (its int8 tree, the ``*_int8`` backend)."""
    if ml_backend == "mlp":
        return {"mlp_int8": quantize_mlp(params["mlp"], calibration_x)}, "mlp_int8"
    if ml_backend == "gbdt":
        return {"gbdt_int8": quantize_gbdt(params["gbdt"])}, "gbdt_int8"
    if ml_backend == "mlp+gbdt":
        return ({"mlp_int8": quantize_mlp(params["mlp"], calibration_x),
                 "gbdt_int8": quantize_gbdt(params["gbdt"])}, "mlp+gbdt_int8")
    if ml_backend == "multitask":
        return ({"multitask_int8": quantize_multitask_fraud(params["multitask"], calibration_x)},
                "multitask_int8")
    raise ValueError(f"no int8 quantization recipe for ml_backend={ml_backend!r} "
                     "(use mlp, gbdt, mlp+gbdt or multitask)")


# ---------------------------------------------------------------------------
# The port's int8 params (built by convert.py from the trees above)


class QuantizedDense(nn.Module):
    """One int8 layer: codes ``wq`` [D_in, D_out] int8, per-channel
    ``scale`` and bias ``b`` float32. The codes' float32 image, which the
    product uses, is made once here and kept out of the state dict."""

    def __init__(self, wq, scale, b):
        super().__init__()
        wq = torch.from_numpy(np.array(wq, dtype=np.int8))
        if wq.dim() != 2 or wq.shape[0] > MAX_EXACT_FAN_IN:
            raise ValueError(f"int8 layer of shape {tuple(wq.shape)}")
        self.register_buffer("wq", wq.contiguous())
        self.register_buffer("scale", torch.from_numpy(np.array(scale, dtype=_F32)))
        self.register_buffer("b", torch.from_numpy(np.array(b, dtype=_F32)))
        self.register_buffer("wq_f32", self.wq.to(torch.float32), persistent=False)


class QuantizedMLP(nn.Module):
    """``quantize_mlp``'s tree on the port: int8 layers and the optional
    per-column ``input_scale`` folded into the first layer."""

    def __init__(self, layers, input_scale=None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.register_buffer("input_scale", None if input_scale is None else
                             torch.from_numpy(np.array(input_scale, dtype=_F32)))


def forest_images(q: Params) -> tuple[np.ndarray, np.ndarray]:
    """(thresholds, leaves) float32 of a quantized forest, as
    ``gbdt_predict_int8`` compares and sums them: the thresholds are
    bf16(bf16(thr_q) * bf16(thr_scale)) (the product of two bfloat16 values
    is exact in float32, then rounded to bfloat16), the leaves
    ``leaves_q * leaf_scale`` in float32."""
    bf = torch.bfloat16
    thr_q = torch.from_numpy(np.asarray(q["thr_q"], np.int8).astype(_F32))
    t_scale = torch.from_numpy(np.asarray(q["thr_scale"], _F32))
    thr = (thr_q.to(bf).to(torch.float32) * t_scale.to(bf).to(torch.float32)).to(bf)
    leaves = np.asarray(q["leaves_q"], np.int8).astype(_F32) * np.asarray(q["leaf_scale"], _F32)
    return thr.to(torch.float32).numpy(), leaves.astype(_F32)


# ---------------------------------------------------------------------------
# Device-side models


def _quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, D] float32 -> (float32 int8 codes, [B] per-row scales), symmetric absmax."""
    absmax = torch.amax(torch.abs(x), dim=-1)
    div = constant("quantize.127", np.array(127.0, _F32), x.device)
    scale = torch.where(absmax > 0, absmax / div, torch.ones_like(absmax))
    xq = torch.clamp(torch.round(x / scale[:, None]), -127, 127)
    return xq, scale


def dense_int8(x: torch.Tensor, layer: QuantizedDense) -> torch.Tensor:
    """float32 [B, D_in] -> float32 [B, D_out]: the int8 product of the
    row-quantized activations and the weight codes, exact in float32,
    dequantized by the row and channel scales.

    Its ``torch.matmul`` needs no fixed order, unlike ``ops/dense.py``:
    every product and partial sum is an integer of magnitude at most
    127 * 127 * D_in, below 2**24 (4,129,024 at the serving fan-in of 256;
    ``quantize_mlp`` refuses a fan-in past ``MAX_EXACT_FAN_IN``), so each
    is exact in float32 and any order, in any batch, gives the same bits."""
    xq, xs = _quantize_rows(x)
    acc = torch.matmul(xq, layer.wq_f32)
    return acc * xs[:, None] * layer.scale[None, :] + layer.b


def mlp_predict_int8(qparams: QuantizedMLP, x: torch.Tensor) -> torch.Tensor:
    """[B, 30] normalized features -> [B] fraud probability, int8 weights."""
    h = torch.as_tensor(x, dtype=torch.float32)
    if qparams.input_scale is not None:
        h = h / qparams.input_scale[None, :]  # undo the fold (quantize_mlp)
    for layer in qparams.layers[:-1]:
        h = torch.relu(dense_int8(h, layer))
    return numerics.sigmoid(dense_int8(h, qparams.layers[-1])[..., 0])


def gbdt_predict_int8(qparams: Params, x: torch.Tensor) -> torch.Tensor:
    """[B, F] normalized features -> [B] probability of the quantized
    forest: the rows rounded to bfloat16 once, then the forest kernel over
    the install-time images of the thresholds and leaves (``forest_images``)."""
    xb = torch.as_tensor(x, dtype=torch.float32).to(torch.bfloat16).to(torch.float32)
    return gbdt_predict(qparams, xb)


# ---------------------------------------------------------------------------
# The int8 feature wire (WIRE_DTYPE=int8)


def _wire8_domain_tables() -> tuple[np.ndarray, np.ndarray]:
    """(log_ceiling [30], linear_mask [30]): per-feature signed-log
    ceilings, and 1 where the feature is linear over [0, 1]."""
    ceil = np.zeros((NUM_FEATURES,), dtype=_F32)
    linear = np.zeros((NUM_FEATURES,), dtype=_F32)
    amounts = (F.TX_SUM_1H, F.TX_AVG_1H, F.AVG_BET_SIZE, F.TX_AMOUNT)
    # Lifetime aggregates get a far higher ceiling ($1B): rule 6 compares
    # the withdrawals with the deposits, and clamping both would fire it
    # for every whale account.
    lifetime = (F.TOTAL_DEPOSITS, F.TOTAL_WITHDRAWALS, F.NET_DEPOSIT)
    durations = (F.TIME_SINCE_LAST_TX, F.SESSION_DURATION)
    ages = (F.DEVICE_AGE_DAYS, F.ACCOUNT_AGE_DAYS)
    big_counts = (F.TX_COUNT_1H, F.DEPOSIT_COUNT, F.WITHDRAW_COUNT,
                  F.BONUS_CLAIM_COUNT, F.IP_COUNTRY_CHANGES)
    small_counts = (F.TX_COUNT_1M, F.TX_COUNT_5M, F.UNIQUE_DEVICES_24H, F.UNIQUE_IPS_24H)
    for idx, hi in (
        (amounts, float(np.log1p(1e9))),         # cents up to $10M
        (lifetime, float(np.log1p(1e11))),       # cents up to $1B
        (durations, float(np.log1p(604800.0))),  # a week of seconds
        (ages, float(np.log1p(3650.0))),         # a decade of days
        (big_counts, float(np.log1p(1e4))),
        (small_counts, float(np.log1p(1e3))),
    ):
        for f in idx:
            ceil[f] = hi
    for f in (F.WIN_RATE, F.IS_VPN, F.IS_PROXY, F.IS_TOR, F.DISPOSABLE_EMAIL,
              F.BONUS_WAGER_RATE, F.BONUS_ONLY_PLAYER,
              F.TX_TYPE_DEPOSIT, F.TX_TYPE_WITHDRAW, F.TX_TYPE_BET):
        linear[f] = 1.0
        ceil[f] = 1.0
    if not (ceil > 0).all():
        raise AssertionError("every feature needs a wire-int8 domain")
    return ceil, linear


W8_CEIL, W8_LINEAR = _wire8_domain_tables()
# The dequantization step of each feature, float32 (ceiling / 127).
W8_STEP = _div127(W8_CEIL)


def wire_quantize_int8(x: np.ndarray) -> np.ndarray:
    """Host side: raw float32 [B, 30] -> int8 [B, 30], before the copy to
    the device. NaN maps to 0 (the schema's "absent"), +-inf saturates."""
    x = np.asarray(x, _F32)
    t = np.where(W8_LINEAR > 0, x, np.sign(x) * np.log1p(np.abs(x)))
    q = np.nan_to_num(np.rint(t * (127.0 / W8_CEIL)), nan=0.0)
    return np.clip(q, -127, 127).astype(np.int8)


def wire_dequantize_int8(q: torch.Tensor) -> torch.Tensor:
    """Device side: int8 [B, 30] -> raw float32 [B, 30]."""
    step = constant("quantize.w8_step", W8_STEP, q.device)
    linear = constant("quantize.w8_linear", W8_LINEAR > 0, q.device)
    t = q.to(torch.float32) * step
    logged = torch.sign(t) * torch.expm1(torch.abs(t))
    return torch.where(linear, t, logged)
