"""HyperLogLog: approximate distinct counting for device/IP cardinality.

A numpy copy of ``igaming_platform_tpu/serve/hll.py`` (the reference keeps
these counts in Redis HLLs, redis_store.go:140-152): the classic Flajolet
et al. estimator with the linear-counting small-range correction, over
uint8 registers. The hash and the estimator are the same, so a sketch fed
the same values counts the same in both packages.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np


def _hash64(value: str) -> int:
    # Stable across processes (unlike builtin hash with PYTHONHASHSEED).
    return int.from_bytes(hashlib.blake2b(value.encode(), digest_size=8).digest(), "little")


class HyperLogLog:
    """HLL sketch with 2**precision uint8 registers."""

    __slots__ = ("p", "m", "registers", "_alpha")

    def __init__(self, precision: int = 12):
        if not 4 <= precision <= 16:
            raise ValueError(f"precision out of range: {precision}")
        self.p = precision
        self.m = 1 << precision
        self.registers = np.zeros(self.m, dtype=np.uint8)
        if self.m >= 128:
            self._alpha = 0.7213 / (1.0 + 1.079 / self.m)
        elif self.m == 64:
            self._alpha = 0.709
        elif self.m == 32:
            self._alpha = 0.697
        else:
            self._alpha = 0.673

    def add(self, value: str) -> None:
        h = _hash64(value)
        idx = h >> (64 - self.p)
        w = h & ((1 << (64 - self.p)) - 1)
        # rank = position of the leftmost 1-bit in the remaining 64-p bits
        rank = (64 - self.p) - w.bit_length() + 1
        if rank > self.registers[idx]:
            self.registers[idx] = rank

    def count(self) -> int:
        regs = self.registers.astype(np.float64)
        est = self._alpha * self.m * self.m / np.sum(np.exp2(-regs))
        if est <= 2.5 * self.m:
            zeros = int(np.count_nonzero(self.registers == 0))
            if zeros:
                est = self.m * math.log(self.m / zeros)
        return int(round(est))

    def merge(self, other: "HyperLogLog") -> None:
        if other.p != self.p:
            raise ValueError("precision mismatch")
        np.maximum(self.registers, other.registers, out=self.registers)

    def reset(self) -> None:
        self.registers[:] = 0
