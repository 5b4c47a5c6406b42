"""CRC-32C (Castagnoli), table-driven, as OCDBT puts it at the end of every
file (``ocdbt.py``).

Reflected polynomial 0x82F63B78, initial value and final xor 0xFFFFFFFF: the
checksum of ``b"123456789"`` is 0xE3069283. Eight tables ("slicing by 8")
take eight bytes a step, so a few hundred kilobytes of nodes and manifests
check in milliseconds.
"""

from __future__ import annotations

import struct

_POLY = 0x82F63B78


def _tables() -> list[list[int]]:
    t0 = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        t0.append(c)
    tables = [t0]
    for _ in range(7):
        prev = tables[-1]
        tables.append([(prev[n] >> 8) ^ t0[prev[n] & 0xFF] for n in range(256)])
    return tables


_T = _tables()


def crc32c(data: bytes | bytearray | memoryview, crc: int = 0) -> int:
    """The CRC-32C of ``data``, continuing from ``crc`` (0 to start)."""
    t0, t1, t2, t3, t4, t5, t6, t7 = _T
    c = crc ^ 0xFFFFFFFF
    mv = memoryview(data).cast("B")
    n8 = len(mv) & ~7
    for (word,) in struct.iter_unpack("<Q", mv[:n8]):
        x = c ^ (word & 0xFFFFFFFF)
        h = word >> 32
        c = (t7[x & 0xFF] ^ t6[(x >> 8) & 0xFF] ^ t5[(x >> 16) & 0xFF] ^ t4[x >> 24]
             ^ t3[h & 0xFF] ^ t2[(h >> 8) & 0xFF] ^ t1[(h >> 16) & 0xFF] ^ t0[h >> 24])
    for b in mv[n8:]:
        c = (c >> 8) ^ t0[(c ^ b) & 0xFF]
    return c ^ 0xFFFFFFFF
