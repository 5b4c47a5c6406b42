"""The score step's transcendental functions, with bits no device changes.

torch's float32 ``log1p`` and ``sigmoid`` are different approximations on
the CPU and on the card: each lies within an ulp or two of the exact value,
but not always on the same float32 (``chip_smoke.py`` phase 3 counts the
values whose bits differ). So a row scored on the card and again on the CPU,
as replay and the CPU twins do, could differ in ``ml_score`` although every
sum in between adds in one order (``ops/dense.py``). Here each function is
evaluated in float64 and rounded once to float32: both devices' float64
results lie within about an ulp of float64 of the exact value, so both round
to the same float32, the correctly rounded one, unless the exact value lies
within about 2**-52 of a float32 rounding midpoint. Against the JAX
package's float32 approximations the results stay within their error (the
port's tests hold ``log1p`` columns to 3 ulp and ``ml_score`` to 1e-6).

``fma`` is the fused multiply-add that XLA's CPU backend emits where a
program multiplies and then adds (the LTV formulas, ``models/ltv.py``),
rounded once on every device, though torch has no fused op that promises it.
"""

from __future__ import annotations

import torch


def log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log1p(x)``, rounded from float64."""
    return _rounded(torch.log1p, x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """float32 ``sigmoid(x)``, rounded from float64."""
    return _rounded(torch.sigmoid, x)


def _rounded(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of float32 ``x`` evaluated in float64 and stored as float32:
    the widening is one elementwise pass, and the function and the rounding
    another (``out=`` of another dtype computes in the input's and casts as it
    stores), so a call costs two launches, not three. ``out=`` records no
    gradient: these serve the score step, not training."""
    return fn(x.to(torch.float64), out=torch.empty_like(x, dtype=torch.float32))


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, the same bits on every device.

    In float64 the product of two float32 values is exact (48 bits); the sum
    with ``c`` is then rounded to odd (TwoSum's error term says whether it
    was exact, and an inexact sum with an even last bit steps one ulp toward
    the error), and a sum rounded to odd at 53 bits rounds to nearest at 24
    bits as the exact value would: no double rounding. Each step is one
    elementwise IEEE operation, which the CPU and the card both round to
    nearest."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    bits = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    odd = torch.where((err != 0) & ((bits & 1) == 0), bits + step, bits)
    return odd.view(torch.float64).to(torch.float32)
