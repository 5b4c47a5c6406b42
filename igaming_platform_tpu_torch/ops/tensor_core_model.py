"""A numpy model of one ``mma.sync`` with a float32 accumulator, as an H100 computes it.

The CPU tests of the attention kernels emulate their arithmetic in numpy;
this is their tensor core. ``csrc/mma_probe.cu`` feeds chosen operands to
TF32 m16n8k8 and bf16 m16n8k16 and returns the accumulators, and on an
H100 every output of 64,000 probe tiles (``chip_smoke.py`` holds this model
to them on every run) matches this model bit for bit:

- all K products and the accumulator C are summed in one step, with no
  intermediate rounding between the k-steps of one instruction;
- each product a_k b_k is exact, and its alignment exponent is the sum of
  its operands' exponents, e(a) + e(b), with e(x) = floor(log2 |x|) (the
  product itself may be up to one binade above it); C's is e(C);
- with E the largest of those exponents, every term, C included, is cut
  toward zero to a multiple of 2^(E - 25), the cut terms are summed
  exactly, and the sum is rounded toward zero to float32.

So a k-step loses up to a unit of 2^(E - 25) per term and then up to an
ulp more by the final cut, always toward zero: more than round-to-nearest
of the exact sum, and with a bias that a long chain of steps accumulates.
Subnormal results are not modelled.
"""

from __future__ import annotations

import numpy as np

ALIGN_BITS = 25
_NO_EXPONENT = -10_000  # the exponent of a zero operand: never the largest


def _exponents(x: np.ndarray) -> np.ndarray:
    """floor(log2 |x|) as int32, _NO_EXPONENT where x is zero."""
    mant, e = np.frexp(x)
    return np.where(mant == 0, _NO_EXPONENT, e - 1).astype(np.int32)


def round_operand(x: np.ndarray, kind: str) -> np.ndarray:
    """float32 rounded to an mma operand type: ``"tf32"`` to nearest, ties
    away from zero (cvt.rna.tf32), ``"bf16"`` to nearest even (cvt.rn.bf16)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    if kind == "tf32":
        u = (u + 0x1000) & 0xFFFFE000
    else:
        u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def round_toward_zero_f32(s: np.ndarray) -> np.ndarray:
    """float64 -> float32, rounded toward zero."""
    f = s.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(s)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def mma(c, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """c + a @ b as one mma.sync of this card: ``a`` [M, K], ``b`` [K, N]
    (float32 holding TF32 or bf16 values), ``c`` [M, N] float32 (or a
    scalar zero); K is the instruction's k (8 for TF32, 16 for bf16)."""
    a64, b64 = np.asarray(a, np.float64), np.asarray(b, np.float64)
    c64 = np.broadcast_to(np.asarray(c, np.float64), (a64.shape[0], b64.shape[1]))
    ea, eb = _exponents(a64), _exponents(b64)
    emax = _exponents(c64)
    for k in range(a64.shape[1]):
        np.maximum(emax, ea[:, k, None] + eb[None, k, :], out=emax)
    emax[emax < _NO_EXPONENT // 2] = 0  # every term zero
    scale = np.ldexp(1.0, ALIGN_BITS - emax)  # 1 / the unit of the cut
    units = np.trunc(c64 * scale)
    term = np.empty_like(units)
    for k in range(a64.shape[1]):
        np.multiply(a64[:, k, None], b64[None, k, :], out=term)
        term *= scale
        units += np.trunc(term, out=term)
    return round_toward_zero_f32(units / scale)
