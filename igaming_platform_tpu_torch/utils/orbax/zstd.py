"""Zstandard frames (RFC 8878): a decoder, and an encoder of raw blocks.

Orbax compresses every zarr chunk with zstd, and tensorstore's OCDBT store
compresses its manifests and B+tree nodes with it (``ocdbt.py``). The card's
host has no zstd library, so this is the port's own.

``decompress(data)`` decodes one or more concatenated frames:

- raw, RLE and compressed blocks;
- literals: raw, RLE, Huffman with one or four streams, and treeless (the
  previous block's Huffman table);
- sequences: FSE tables in predefined, RLE, compressed and repeat modes;
- the repeat-offset history, which carries across blocks, the window, and
  skippable frames;
- the XXH64 content checksum, checked whenever a frame carries one.

A frame that needs a dictionary, or is malformed, raises ``ValueError``
naming what it met; nothing is skipped.

``compress(data)`` writes one frame of raw blocks. That is valid zstd, read
by every decoder; the checkpoint writer needs nothing smaller.

The decoder is pure Python: the Huffman and sequence loops keep their bit
containers in local integers and refill them eight bytes at a time, and
literal and match copies work on slices of a ``bytearray``.
"""

from __future__ import annotations

import struct

MAGIC = 0xFD2FB528
_MAGIC_BYTES = struct.pack("<I", MAGIC)
_BLOCK_MAX = 128 * 1024
_M64 = (1 << 64) - 1

# ---------------------------------------------------------------------------
# XXH64 (the content checksum keeps its low 32 bits)

_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def xxh64(data: bytes | bytearray | memoryview, seed: int = 0) -> int:
    mv = memoryview(data).cast("B")
    n = len(mv)
    p = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed & _M64
        v4 = (seed - _P1) & _M64
        stop = n & ~31
        for a, b, c, d in struct.iter_unpack("<4Q", mv[:stop]):
            v1 = (((v1 + a * _P2) & _M64) << 31 | ((v1 + a * _P2) & _M64) >> 33) & _M64
            v1 = (v1 * _P1) & _M64
            v2 = (((v2 + b * _P2) & _M64) << 31 | ((v2 + b * _P2) & _M64) >> 33) & _M64
            v2 = (v2 * _P1) & _M64
            v3 = (((v3 + c * _P2) & _M64) << 31 | ((v3 + c * _P2) & _M64) >> 33) & _M64
            v3 = (v3 * _P1) & _M64
            v4 = (((v4 + d * _P2) & _M64) << 31 | ((v4 + d * _P2) & _M64) >> 33) & _M64
            v4 = (v4 * _P1) & _M64
        p = stop
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            v = (_rotl((v * _P2) & _M64, 31) * _P1) & _M64
            h = ((h ^ v) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        (k,) = struct.unpack_from("<Q", mv, p)
        k = (_rotl((k * _P2) & _M64, 31) * _P1) & _M64
        h = (_rotl(h ^ k, 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        (k,) = struct.unpack_from("<I", mv, p)
        h = (_rotl(h ^ ((k * _P1) & _M64), 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h = (_rotl(h ^ ((mv[p] * _P5) & _M64), 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    h ^= h >> 32
    return h


# ---------------------------------------------------------------------------
# Bit readers


class _ForwardBits:
    """Little-endian bits read from the front (FSE table descriptions)."""

    def __init__(self, data, start: int, end: int):
        self.value = int.from_bytes(data[start:end], "little")
        self.pos = 0
        self.limit = (end - start) * 8

    def read(self, n: int) -> int:
        v = (self.value >> self.pos) & ((1 << n) - 1)
        self.pos += n
        if self.pos > self.limit:
            raise ValueError("zstd: FSE table description runs past its block")
        return v


class _BackBits:
    """A backward bit stream (RFC 8878 4.1): read from its last byte toward
    its first, the highest set bit of the last byte marking the start. Reads
    past the beginning give zeros and leave ``left`` negative."""

    def __init__(self, data, start: int, end: int):
        if end <= start or data[end - 1] == 0:
            raise ValueError("zstd: bit stream without its end marker")
        self.value = int.from_bytes(data[start:end], "little")
        self.left = (end - start) * 8 - (9 - data[end - 1].bit_length())

    def read(self, n: int) -> int:
        self.left -= n
        if self.left >= 0:
            return (self.value >> self.left) & ((1 << n) - 1)
        if self.left + n <= 0:
            return 0
        return (self.value << -self.left) & ((1 << n) - 1)


# ---------------------------------------------------------------------------
# FSE tables


def _read_fse_description(data, start: int, end: int, max_symbol: int, max_log: int):
    """(normalized counts, accuracy log, bytes used) of an FSE table
    description at ``data[start:]`` (RFC 8878 4.1.1)."""
    bits = _ForwardBits(data, start, min(end, start + 512))
    log = bits.read(4) + 5
    if log > max_log:
        raise ValueError(f"zstd: FSE accuracy log {log} over {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts: list[int] = []
    while remaining > 1:
        if len(counts) > max_symbol:
            raise ValueError("zstd: FSE table description has too many symbols")
        lo_mask = threshold - 1
        max_small = 2 * threshold - 1 - remaining
        peek = (bits.value >> bits.pos) & (2 * threshold - 1)
        if (peek & lo_mask) < max_small:
            value = peek & lo_mask
            bits.pos += nbits - 1
        else:
            value = peek
            if value >= threshold:
                value -= max_small
            bits.pos += nbits
        count = value - 1
        remaining -= -count if count < 0 else count
        counts.append(count)
        if count == 0:
            while True:
                repeat = bits.read(2)
                counts.extend([0] * repeat)
                if repeat != 3:
                    break
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1 or bits.pos > bits.limit:
        raise ValueError("zstd: corrupt FSE table description")
    return counts, log, (bits.pos + 7) >> 3


def _build_fse(counts: list[int], log: int):
    """Decoding table: per state (symbol, bits to read, baseline)."""
    size = 1 << log
    symbols = [0] * size
    high = size - 1
    next_state = []
    for s, c in enumerate(counts):
        if c == -1:
            symbols[high] = s
            high -= 1
            next_state.append(1)
        else:
            next_state.append(c)
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(c if c > 0 else 0):
            symbols[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ValueError("zstd: FSE table does not fill its states")
    sym_out, nb_out, base_out = [], [], []
    for state in range(size):
        s = symbols[state]
        ns = next_state[s]
        next_state[s] += 1
        nb = log - (ns.bit_length() - 1)
        sym_out.append(s)
        nb_out.append(nb)
        base_out.append((ns << nb) - size)
    return sym_out, nb_out, base_out, log


def _rle_fse(symbol: int):
    return [symbol], [0], [0], 0


_LL_DEFAULT = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2,
               1, 1, 1, 1, 1, -1, -1, -1, -1]
_ML_DEFAULT = [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1,
               -1]
_OF_DEFAULT = [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1,
               -1, -1]
_LL_TABLE = _build_fse(_LL_DEFAULT, 6)
_ML_TABLE = _build_fse(_ML_DEFAULT, 6)
_OF_TABLE = _build_fse(_OF_DEFAULT, 5)

_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
                              2048, 4096, 8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = [n + 3 for n in range(32)] + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259,
                                         515, 1027, 2051, 4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]


# ---------------------------------------------------------------------------
# Huffman literals


def _read_huffman_table(data, start: int, end: int):
    """((symbol, bits) per index of width max_bits, max_bits), bytes used."""
    header = data[start]
    if header >= 128:
        n = header - 127
        size = (n + 1) // 2
        if start + 1 + size > end:
            raise ValueError("zstd: Huffman weights run past the literals")
        weights = []
        for i in range(n):
            b = data[start + 1 + i // 2]
            weights.append(b >> 4 if i % 2 == 0 else b & 0xF)
        used = 1 + size
    else:
        size = header
        if start + 1 + size > end:
            raise ValueError("zstd: Huffman weights run past the literals")
        counts, log, desc = _read_fse_description(data, start + 1, start + 1 + size, 255, 6)
        sym, nb, base, _ = _build_fse(counts, log)
        bits = _BackBits(data, start + 1 + desc, start + 1 + size)
        s1 = bits.read(log)
        s2 = bits.read(log)
        weights = []
        while True:
            if len(weights) > 254:
                raise ValueError("zstd: too many Huffman weights")
            weights.append(sym[s1])
            s1 = base[s1] + bits.read(nb[s1])
            if bits.left < 0:
                weights.append(sym[s2])
                break
            weights.append(sym[s2])
            s2 = base[s2] + bits.read(nb[s2])
            if bits.left < 0:
                weights.append(sym[s1])
                break
        used = 1 + size
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ValueError("zstd: empty Huffman table")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        raise ValueError("zstd: Huffman weights do not sum to a power of two")
    weights.append(rest.bit_length())
    if max_bits > 11:
        raise ValueError(f"zstd: Huffman code of {max_bits} bits")
    table: list[tuple[int, int]] = []
    for w in range(1, max_bits + 1):
        nbits = max_bits + 1 - w
        for s, sw in enumerate(weights):
            if sw == w:
                table.extend([(s, nbits)] * (1 << (w - 1)))
    return (table, max_bits), used


def _huffman_stream(data, start: int, end: int, count: int, huff, out: bytearray) -> None:
    """Decode ``count`` literals of one backward Huffman stream into ``out``.
    A 64-bit window is refilled from the bytes, so every step works on a
    machine-sized integer; the last window is padded below with zeros."""
    table, max_bits = huff
    if end <= start or data[end - 1] == 0:
        raise ValueError("zstd: Huffman stream without its end marker")
    pos = (end - start) * 8 - (9 - data[end - 1].bit_length())
    mask = (1 << max_bits) - 1
    append = out.append
    emitted = 0
    while emitted < count:
        if pos > 56:
            lo = (pos - 56) >> 3
            window = int.from_bytes(data[start + lo:start + ((pos + 7) >> 3)], "little")
            base = lo * 8
        else:
            window = int.from_bytes(data[start:start + ((pos + 7) >> 3)], "little") << max_bits
            base = -max_bits
        wl = pos - base
        while wl >= max_bits and emitted < count:
            s, nb = table[(window >> (wl - max_bits)) & mask]
            append(s)
            wl -= nb
            emitted += 1
        pos = base + wl
        if pos < 0:
            raise ValueError("zstd: Huffman stream ends early")
    if pos != 0:
        raise ValueError("zstd: Huffman stream not consumed exactly")


def _literals(data, p: int, end: int, state: dict):
    """(literals, position after the literals section)."""
    b0 = data[p]
    kind = b0 & 3
    fmt = (b0 >> 2) & 3
    if kind in (0, 1):
        if fmt in (0, 2):
            size, p = b0 >> 3, p + 1
        elif fmt == 1:
            size, p = (b0 >> 4) | (data[p + 1] << 4), p + 2
        else:
            size, p = (b0 >> 4) | (data[p + 1] << 4) | (data[p + 2] << 12), p + 3
        if kind == 0:
            if p + size > end:
                raise ValueError("zstd: raw literals run past the block")
            return bytearray(data[p:p + size]), p + size
        if p >= end:
            raise ValueError("zstd: RLE literals run past the block")
        return bytearray(data[p:p + 1]) * size, p + 1
    if fmt in (0, 1):
        v = int.from_bytes(data[p:p + 3], "little")
        regen, comp, streams, p = (v >> 4) & 0x3FF, (v >> 14) & 0x3FF, 1 if fmt == 0 else 4, p + 3
    elif fmt == 2:
        v = int.from_bytes(data[p:p + 4], "little")
        regen, comp, streams, p = (v >> 4) & 0x3FFF, (v >> 18) & 0x3FFF, 4, p + 4
    else:
        v = int.from_bytes(data[p:p + 5], "little")
        regen, comp, streams, p = (v >> 4) & 0x3FFFF, (v >> 22) & 0x3FFFF, 4, p + 5
    stop = p + comp
    if stop > end:
        raise ValueError("zstd: compressed literals run past the block")
    if kind == 2:
        state["huffman"], used = _read_huffman_table(data, p, stop)
        p += used
    elif state.get("huffman") is None:
        raise ValueError("zstd: treeless literals with no earlier Huffman table")
    huff = state["huffman"]
    out = bytearray()
    if streams == 1:
        _huffman_stream(data, p, stop, regen, huff, out)
    else:
        if p + 6 > stop:
            raise ValueError("zstd: Huffman jump table runs past the literals")
        s1, s2, s3 = struct.unpack_from("<3H", data, p)
        p += 6
        per = (regen + 3) // 4
        bounds = [p, p + s1, p + s1 + s2, p + s1 + s2 + s3, stop]
        if bounds[3] > stop:
            raise ValueError("zstd: Huffman jump table past the literals")
        for i in range(4):
            n = per if i < 3 else regen - 3 * per
            if n < 0:
                raise ValueError("zstd: Huffman streams shorter than their literals")
            _huffman_stream(data, bounds[i], bounds[i + 1], n, huff, out)
    return out, stop


# ---------------------------------------------------------------------------
# Sequences


def _seq_table(mode: int, data, p: int, end: int, state: dict, key: str, default, max_sym,
               max_log):
    if mode == 0:
        table = default
    elif mode == 1:
        if p >= end or data[p] > max_sym:
            raise ValueError(f"zstd: bad RLE symbol for the {key} codes")
        table = _rle_fse(data[p])
        p += 1
    elif mode == 2:
        counts, log, used = _read_fse_description(data, p, end, max_sym, max_log)
        table = _build_fse(counts, log)
        p += used
    else:
        table = state.get(key)
        if table is None:
            raise ValueError(f"zstd: repeat mode for the {key} codes with no earlier table")
    state[key] = table
    return table, p


def _sequences(data, p: int, end: int, lits: bytearray, out: bytearray, state: dict,
               window: int) -> None:
    b0 = data[p]
    if b0 == 0:
        if p + 1 != end:
            raise ValueError("zstd: bytes after an empty sequences section")
        out += lits
        return
    if b0 < 128:
        nseq, p = b0, p + 1
    elif b0 < 255:
        nseq, p = ((b0 - 128) << 8) + data[p + 1], p + 2
    else:
        nseq, p = data[p + 1] + (data[p + 2] << 8) + 0x7F00, p + 3
    modes = data[p]
    p += 1
    if modes & 3:
        raise ValueError("zstd: reserved bits set in the sequence compression modes")
    ll_t, p = _seq_table(modes >> 6, data, p, end, state, "ll", _LL_TABLE, 35, 9)
    of_t, p = _seq_table((modes >> 4) & 3, data, p, end, state, "of", _OF_TABLE, 31, 8)
    ml_t, p = _seq_table((modes >> 2) & 3, data, p, end, state, "ml", _ML_TABLE, 52, 9)
    ll_sym, ll_nb, ll_base, ll_log = ll_t
    of_sym, of_nb, of_base, of_log = of_t
    ml_sym, ml_nb, ml_base, ml_log = ml_t
    if end <= p or data[end - 1] == 0:
        raise ValueError("zstd: sequence bit stream without its end marker")
    left = (end - p) * 8 - (9 - data[end - 1].bit_length())
    from_bytes = int.from_bytes

    def read(n):
        nonlocal left
        left -= n
        if left < 0:
            raise ValueError("zstd: sequence bit stream ends early")
        return (from_bytes(data[p + (left >> 3):p + ((left + n + 7) >> 3)], "little")
                >> (left & 7)) & ((1 << n) - 1)

    ll_s = read(ll_log)
    of_s = read(of_log)
    ml_s = read(ml_log)
    reps = state["reps"]
    r1, r2, r3 = reps
    lit_pos = 0
    nlits = len(lits)
    for i in range(nseq):
        of_code = of_sym[of_s]
        ml_code = ml_sym[ml_s]
        ll_code = ll_sym[ll_s]
        if of_code > 31:
            raise ValueError(f"zstd: offset code {of_code}")
        offset_value = (1 << of_code) + (read(of_code) if of_code else 0)
        ml = _ML_BASE[ml_code] + (read(_ML_BITS[ml_code]) if _ML_BITS[ml_code] else 0)
        ll = _LL_BASE[ll_code] + (read(_LL_BITS[ll_code]) if _LL_BITS[ll_code] else 0)
        if offset_value > 3:
            offset = offset_value - 3
            r1, r2, r3 = offset, r1, r2
        else:
            idx = offset_value if ll else offset_value + 1
            if idx == 1:
                offset = r1
            elif idx == 2:
                offset = r2
                r1, r2 = r2, r1
            elif idx == 3:
                offset = r3
                r1, r2, r3 = r3, r1, r2
            else:
                offset = r1 - 1
                if offset == 0:
                    raise ValueError("zstd: repeat offset of 0")
                r1, r2, r3 = offset, r1, r2
        if i != nseq - 1:
            nb = ll_nb[ll_s]
            ll_s = ll_base[ll_s] + (read(nb) if nb else 0)
            nb = ml_nb[ml_s]
            ml_s = ml_base[ml_s] + (read(nb) if nb else 0)
            nb = of_nb[of_s]
            of_s = of_base[of_s] + (read(nb) if nb else 0)
        if lit_pos + ll > nlits:
            raise ValueError("zstd: a sequence takes more literals than the block has")
        out += lits[lit_pos:lit_pos + ll]
        lit_pos += ll
        start = len(out) - offset
        if offset > len(out) or offset > window:
            raise ValueError(f"zstd: match offset {offset} beyond the window")
        if offset >= ml:
            out += out[start:start + ml]
        else:
            # An overlapping match repeats its last ``offset`` bytes.
            piece = out[start:]
            reps_needed, rem = divmod(ml, offset)
            out += piece * reps_needed + piece[:rem]
    if left != 0:
        raise ValueError("zstd: sequence bit stream not consumed exactly")
    state["reps"] = (r1, r2, r3)
    out += lits[lit_pos:]


# ---------------------------------------------------------------------------
# Frames


def _frame(data, p: int, out: bytearray) -> int:
    """Decode the frame at ``data[p:]`` into ``out``, which holds no earlier
    frame's bytes; the position after it."""
    n = len(data)
    if p + 5 > n:
        raise ValueError("zstd: truncated frame header")
    fhd = data[p + 4]
    p += 5
    fcs_flag = fhd >> 6
    single = (fhd >> 5) & 1
    if fhd & 0x08:
        raise ValueError("zstd: reserved bit set in the frame header")
    checksum = (fhd >> 2) & 1
    did_size = (0, 1, 2, 4)[fhd & 3]
    window = None
    if not single:
        wd = data[p]
        p += 1
        log = 10 + (wd >> 3)
        window = (1 << log) + ((1 << log) >> 3) * (wd & 7)
    if did_size:
        did = int.from_bytes(data[p:p + did_size], "little")
        p += did_size
        if did:
            raise ValueError(f"zstd: frame needs dictionary {did}, which is not supported")
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content_size = None
    if fcs_size:
        content_size = int.from_bytes(data[p:p + fcs_size], "little")
        if fcs_size == 2:
            content_size += 256
        p += fcs_size
    if window is None:
        window = content_size
    block_max = min(window, _BLOCK_MAX)
    state: dict = {"reps": (1, 4, 8)}
    while True:
        if p + 3 > n:
            raise ValueError("zstd: truncated block header")
        bh = data[p] | (data[p + 1] << 8) | (data[p + 2] << 16)
        p += 3
        last = bh & 1
        btype = (bh >> 1) & 3
        size = bh >> 3
        if btype == 0:
            if p + size > n:
                raise ValueError("zstd: raw block runs past the frame")
            if size > block_max:
                raise ValueError("zstd: block larger than its window allows")
            out += data[p:p + size]
            p += size
        elif btype == 1:
            if p >= n:
                raise ValueError("zstd: truncated RLE block")
            if size > block_max:
                raise ValueError("zstd: block larger than its window allows")
            out += bytes(data[p:p + 1]) * size
            p += 1
        elif btype == 2:
            end = p + size
            if end > n or size > block_max:
                raise ValueError("zstd: compressed block runs past the frame")
            lits, q = _literals(data, p, end, state)
            _sequences(data, q, end, lits, out, state, window)
            p = end
        else:
            raise ValueError("zstd: reserved block type")
        if last:
            break
    produced = len(out)
    if content_size is not None and produced != content_size:
        raise ValueError(f"zstd: frame declares {content_size} bytes, decoded {produced}")
    if checksum:
        if p + 4 > n:
            raise ValueError("zstd: truncated content checksum")
        want = int.from_bytes(data[p:p + 4], "little")
        if xxh64(out) & 0xFFFFFFFF != want:
            raise ValueError("zstd: content checksum mismatch")
        p += 4
    return p


def decompress(data: bytes | bytearray | memoryview) -> bytes:
    """The content of every frame in ``data``, skippable frames skipped."""
    data = bytes(data)
    frames = []
    p = 0
    if not data:
        raise ValueError("zstd: empty input")
    while p < len(data):
        if len(data) - p < 4:
            raise ValueError("zstd: trailing bytes after the last frame")
        (magic,) = struct.unpack_from("<I", data, p)
        if magic & 0xFFFFFFF0 == 0x184D2A50:
            (size,) = struct.unpack_from("<I", data, p + 4)
            p += 8 + size
            if p > len(data):
                raise ValueError("zstd: truncated skippable frame")
            continue
        if magic != MAGIC:
            raise ValueError(f"zstd: bad magic {magic:#010x}")
        out = bytearray()
        try:
            p = _frame(data, p, out)
        except (IndexError, struct.error) as exc:  # a field read past the end
            raise ValueError(f"zstd: truncated frame ({exc})") from exc
        frames.append(out)
    return b"".join(frames)


def compress(data: bytes | bytearray | memoryview) -> bytes:
    """One zstd frame of ``data`` in raw blocks, its size in the header."""
    data = memoryview(data).cast("B")
    n = len(data)
    if n < 256:
        header = bytes([0x20, n])
    elif n < 65536 + 256:
        header = bytes([0x60]) + struct.pack("<H", n - 256)
    elif n < 1 << 32:
        header = bytes([0xA0]) + struct.pack("<I", n)
    else:
        header = bytes([0xE0]) + struct.pack("<Q", n)
    parts = [_MAGIC_BYTES, header]
    p = 0
    while True:
        size = min(n - p, _BLOCK_MAX)
        last = p + size >= n
        parts.append(struct.pack("<I", (size << 3) | int(last))[:3])
        parts.append(data[p:p + size])
        p += size
        if last:
            break
    return b"".join(parts)
