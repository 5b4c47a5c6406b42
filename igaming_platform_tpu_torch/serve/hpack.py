"""HPACK (RFC 7541): the header compression of HTTP/2, for the port's gRPC
transport (``serve/h2.py``, ``serve/grpc_wire.py``).

``Decoder`` reads every representation a peer may send: indexed fields,
literals with incremental indexing, without indexing and never indexed,
with a static or dynamic name index or a literal name, Huffman-coded or
raw strings, and dynamic table size updates at the start of a block. Its
dynamic table evicts the oldest entries as RFC 7541 section 4.4 says, and
its size is bounded by what the local SETTINGS_HEADER_TABLE_SIZE allows.
grpcio's and grpc-go's encoders index headers and Huffman-code values, so
a decoder without both fails on a channel's second call, not its first.

``Encoder`` writes an exact static-table match as an indexed field and
everything else as a literal without indexing, never Huffman-coded:
forms every peer must accept, and a table it never fills, so its output
depends on nothing sent before. It starts each connection's first block
with a table size update to 0, which holds whatever table size the peer
announces.

The Huffman code is RFC 7541 Appendix B, typed in below as (code, bit
length) for the 256 octets and EOS; it is canonical, so the codes follow
from the lengths alone (``tests/test_torch_grpc_wire.py`` rebuilds them).
Decoding runs a 4-bit state machine built from that table at first use.
Every error is an ``HpackError``, which the connection answers with the
HTTP/2 COMPRESSION_ERROR.
"""

from __future__ import annotations

import threading


class HpackError(Exception):
    """A malformed header block: the connection's COMPRESSION_ERROR."""


STATIC_TABLE: tuple[tuple[str, str], ...] = (
    (":authority", ""), (":method", "GET"), (":method", "POST"), (":path", "/"),
    (":path", "/index.html"), (":scheme", "http"), (":scheme", "https"), (":status", "200"),
    (":status", "204"), (":status", "206"), (":status", "304"), (":status", "400"),
    (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""), ("accept-ranges", ""),
    ("accept", ""), ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""), ("content-disposition", ""),
    ("content-encoding", ""), ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""), ("content-type", ""), ("cookie", ""),
    ("date", ""), ("etag", ""), ("expect", ""), ("expires", ""), ("from", ""), ("host", ""),
    ("if-match", ""), ("if-modified-since", ""), ("if-none-match", ""), ("if-range", ""),
    ("if-unmodified-since", ""), ("last-modified", ""), ("link", ""), ("location", ""),
    ("max-forwards", ""), ("proxy-authenticate", ""), ("proxy-authorization", ""),
    ("range", ""), ("referer", ""), ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""), ("transfer-encoding", ""),
    ("user-agent", ""), ("vary", ""), ("via", ""), ("www-authenticate", ""),
)

# RFC 7541 Appendix B: (code, length in bits) of octets 0-255, then EOS.
HUFFMAN_CODES: tuple[tuple[int, int], ...] = (
    (0x1ff8, 13), (0x7fffd8, 23), (0xfffffe2, 28), (0xfffffe3, 28), (0xfffffe4, 28),
    (0xfffffe5, 28), (0xfffffe6, 28), (0xfffffe7, 28), (0xfffffe8, 28), (0xffffea, 24),
    (0x3ffffffc, 30), (0xfffffe9, 28), (0xfffffea, 28), (0x3ffffffd, 30), (0xfffffeb, 28),
    (0xfffffec, 28), (0xfffffed, 28), (0xfffffee, 28), (0xfffffef, 28), (0xffffff0, 28),
    (0xffffff1, 28), (0xffffff2, 28), (0x3ffffffe, 30), (0xffffff3, 28), (0xffffff4, 28),
    (0xffffff5, 28), (0xffffff6, 28), (0xffffff7, 28), (0xffffff8, 28), (0xffffff9, 28),
    (0xffffffa, 28), (0xffffffb, 28),
    # ' ' ! " # $ % & ' ( ) * + , - . /
    (0x14, 6), (0x3f8, 10), (0x3f9, 10), (0xffa, 12), (0x1ff9, 13), (0x15, 6), (0xf8, 8),
    (0x7fa, 11), (0x3fa, 10), (0x3fb, 10), (0xf9, 8), (0x7fb, 11), (0xfa, 8), (0x16, 6),
    (0x17, 6), (0x18, 6),
    # 0-9
    (0x0, 5), (0x1, 5), (0x2, 5), (0x19, 6), (0x1a, 6), (0x1b, 6), (0x1c, 6), (0x1d, 6),
    (0x1e, 6), (0x1f, 6),
    # : ; < = > ? @
    (0x5c, 7), (0xfb, 8), (0x7ffc, 15), (0x20, 6), (0xffb, 12), (0x3fc, 10), (0x1ffa, 13),
    # A-Z
    (0x21, 6), (0x5d, 7), (0x5e, 7), (0x5f, 7), (0x60, 7), (0x61, 7), (0x62, 7), (0x63, 7),
    (0x64, 7), (0x65, 7), (0x66, 7), (0x67, 7), (0x68, 7), (0x69, 7), (0x6a, 7), (0x6b, 7),
    (0x6c, 7), (0x6d, 7), (0x6e, 7), (0x6f, 7), (0x70, 7), (0x71, 7), (0x72, 7), (0xfc, 8),
    (0x73, 7), (0xfd, 8),
    # [ \ ] ^ _ `
    (0x1ffb, 13), (0x7fff0, 19), (0x1ffc, 13), (0x3ffc, 14), (0x22, 6), (0x7ffd, 15),
    # a-z
    (0x3, 5), (0x23, 6), (0x4, 5), (0x24, 6), (0x5, 5), (0x25, 6), (0x26, 6), (0x27, 6),
    (0x6, 5), (0x74, 7), (0x75, 7), (0x28, 6), (0x29, 6), (0x2a, 6), (0x7, 5), (0x2b, 6),
    (0x76, 7), (0x2c, 6), (0x8, 5), (0x9, 5), (0x2d, 6), (0x77, 7), (0x78, 7), (0x79, 7),
    (0x7a, 7), (0x7b, 7),
    # { | } ~ DEL
    (0x7ffe, 15), (0x7fc, 11), (0x3ffd, 14), (0x1ffd, 13), (0xffffffc, 28),
    # 128-255
    (0xfffe6, 20), (0x3fffd2, 22), (0xfffe7, 20), (0xfffe8, 20), (0x3fffd3, 22),
    (0x3fffd4, 22), (0x3fffd5, 22), (0x7fffd9, 23), (0x3fffd6, 22), (0x7fffda, 23),
    (0x7fffdb, 23), (0x7fffdc, 23), (0x7fffdd, 23), (0x7fffde, 23), (0xffffeb, 24),
    (0x7fffdf, 23), (0xffffec, 24), (0xffffed, 24), (0x3fffd7, 22), (0x7fffe0, 23),
    (0xffffee, 24), (0x7fffe1, 23), (0x7fffe2, 23), (0x7fffe3, 23), (0x7fffe4, 23),
    (0x1fffdc, 21), (0x3fffd8, 22), (0x7fffe5, 23), (0x3fffd9, 22), (0x7fffe6, 23),
    (0x7fffe7, 23), (0xffffef, 24), (0x3fffda, 22), (0x1fffdd, 21), (0xfffe9, 20),
    (0x3fffdb, 22), (0x3fffdc, 22), (0x7fffe8, 23), (0x7fffe9, 23), (0x1fffde, 21),
    (0x7fffea, 23), (0x3fffdd, 22), (0x3fffde, 22), (0xfffff0, 24), (0x1fffdf, 21),
    (0x3fffdf, 22), (0x7fffeb, 23), (0x7fffec, 23), (0x1fffe0, 21), (0x1fffe1, 21),
    (0x3fffe0, 22), (0x1fffe2, 21), (0x7fffed, 23), (0x3fffe1, 22), (0x7fffee, 23),
    (0x7fffef, 23), (0xfffea, 20), (0x3fffe2, 22), (0x3fffe3, 22), (0x3fffe4, 22),
    (0x7ffff0, 23), (0x3fffe5, 22), (0x3fffe6, 22), (0x7ffff1, 23), (0x3ffffe0, 26),
    (0x3ffffe1, 26), (0xfffeb, 20), (0x7fff1, 19), (0x3fffe7, 22), (0x7ffff2, 23),
    (0x3fffe8, 22), (0x1ffffec, 25), (0x3ffffe2, 26), (0x3ffffe3, 26), (0x3ffffe4, 26),
    (0x7ffffde, 27), (0x7ffffdf, 27), (0x3ffffe5, 26), (0xfffff1, 24), (0x1ffffed, 25),
    (0x7fff2, 19), (0x1fffe3, 21), (0x3ffffe6, 26), (0x7ffffe0, 27), (0x7ffffe1, 27),
    (0x3ffffe7, 26), (0x7ffffe2, 27), (0xfffff2, 24), (0x1fffe4, 21), (0x1fffe5, 21),
    (0x3ffffe8, 26), (0x3ffffe9, 26), (0xffffffd, 28), (0x7ffffe3, 27), (0x7ffffe4, 27),
    (0x7ffffe5, 27), (0xfffec, 20), (0xfffff3, 24), (0xfffed, 20), (0x1fffe6, 21),
    (0x3fffe9, 22), (0x1fffe7, 21), (0x1fffe8, 21), (0x7ffff3, 23), (0x3fffea, 22),
    (0x3fffeb, 22), (0x1ffffee, 25), (0x1ffffef, 25), (0xfffff4, 24), (0xfffff5, 24),
    (0x3ffffea, 26), (0x7ffff4, 23), (0x3ffffeb, 26), (0x7ffffe6, 27), (0x3ffffec, 26),
    (0x3ffffed, 26), (0x7ffffe7, 27), (0x7ffffe8, 27), (0x7ffffe9, 27), (0x7ffffea, 27),
    (0x7ffffeb, 27), (0xffffffe, 28), (0x7ffffec, 27), (0x7ffffed, 27), (0x7ffffee, 27),
    (0x7ffffef, 27), (0x7fffff0, 27), (0x3ffffee, 26),
    # EOS
    (0x3fffffff, 30),
)
EOS = 256

DEFAULT_TABLE_SIZE = 4096
ENTRY_OVERHEAD = 32  # RFC 7541 section 4.1


# ---------------------------------------------------------------------------
# Huffman


def huffman_encode(data: bytes) -> bytes:
    """``data`` Huffman-coded, padded with the most significant bits of EOS
    (ones)."""
    acc, nbits = 0, 0
    for octet in data:
        code, n = HUFFMAN_CODES[octet]
        acc = (acc << n) | code
        nbits += n
    pad = -nbits % 8
    acc = (acc << pad) | ((1 << pad) - 1)
    return acc.to_bytes((nbits + pad) // 8, "big")


_FSM: list | None = None
_FSM_LOCK = threading.Lock()


def _build_fsm() -> list:
    """The decoder's state machine: for state s (an inner node of the code
    tree) and nibble v, ``fsm[s * 16 + v]`` is (next state, the octets
    emitted, failed). ``fsm`` also carries, per state, whether input may end
    there (``_ACCEPT``): at the root, or inside a run of at most 7 one-bits,
    a prefix of EOS (RFC 7541 section 5.2)."""
    children: list[list] = [[None, None]]
    depth, ones = [0], [True]
    for sym, (code, n) in enumerate(HUFFMAN_CODES):
        node = 0
        for i in range(n - 1, -1, -1):
            bit = (code >> i) & 1
            if i == 0:
                if children[node][bit] is not None:
                    raise AssertionError(f"Huffman code of {sym} collides")
                children[node][bit] = -1 - sym
                break
            nxt = children[node][bit]
            if nxt is None:
                nxt = len(children)
                children.append([None, None])
                depth.append(depth[node] + 1)
                ones.append(ones[node] and bit == 1)
                children[node][bit] = nxt
            elif nxt < 0:
                raise AssertionError(f"Huffman code of {sym} has a code as its prefix")
            node = nxt
    table = []
    for state in range(len(children)):
        for nibble in range(16):
            node, out, failed = state, bytearray(), False
            for i in (3, 2, 1, 0):
                nxt = children[node][(nibble >> i) & 1]
                if nxt is None:
                    failed = True
                    break
                if nxt < 0:
                    sym = -1 - nxt
                    if sym == EOS:
                        failed = True
                        break
                    out.append(sym)
                    node = 0
                else:
                    node = nxt
            table.append((node, bytes(out), failed))
    accept = [state == 0 or (ones[state] and depth[state] <= 7) for state in range(len(children))]
    return [table, accept]


def huffman_decode(data: bytes) -> bytes:
    """The octets ``data`` codes; HpackError on EOS, a code that does not
    exist, or padding that is longer than 7 bits or not all ones."""
    global _FSM
    if _FSM is None:
        with _FSM_LOCK:
            if _FSM is None:
                _FSM = _build_fsm()
    table, accept = _FSM
    state, out = 0, bytearray()
    for octet in data:
        state, emitted, failed = table[state * 16 + (octet >> 4)]
        if failed:
            raise HpackError("invalid Huffman code")
        out += emitted
        state, emitted, failed = table[state * 16 + (octet & 15)]
        if failed:
            raise HpackError("invalid Huffman code")
        out += emitted
    if not accept[state]:
        raise HpackError("invalid Huffman padding")
    return bytes(out)


# ---------------------------------------------------------------------------
# Primitives


def encode_int(value: int, prefix_bits: int, first: int = 0) -> bytes:
    """``value`` with an N-bit prefix (RFC 7541 section 5.1); ``first``
    holds the bits above the prefix of the first octet."""
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytes((first | value,))
    out = bytearray((first | limit,))
    value -= limit
    while value >= 128:
        out.append((value & 127) | 128)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_int(buf: bytes, pos: int, prefix_bits: int) -> tuple[int, int]:
    limit = (1 << prefix_bits) - 1
    if pos >= len(buf):
        raise HpackError("truncated integer")
    value = buf[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(buf):
            raise HpackError("truncated integer")
        octet = buf[pos]
        pos += 1
        value += (octet & 127) << shift
        shift += 7
        if not octet & 128:
            return value, pos
        if shift > 35:
            raise HpackError("integer overflow")


def _decode_string(buf: bytes, pos: int) -> tuple[bytes, int]:
    if pos >= len(buf):
        raise HpackError("truncated string")
    huffman = buf[pos] & 0x80
    n, pos = decode_int(buf, pos, 7)
    if pos + n > len(buf):
        raise HpackError("truncated string")
    raw = bytes(buf[pos:pos + n])
    return (huffman_decode(raw) if huffman else raw), pos + n


def _encode_string(value: bytes) -> bytes:
    return encode_int(len(value), 7) + value


# ---------------------------------------------------------------------------
# Decoder


class Decoder:
    """One direction's header decoder: its dynamic table lives as long as the
    connection. ``max_allowed`` is the SETTINGS_HEADER_TABLE_SIZE the local
    side announced; a table size update above it is an error."""

    def __init__(self, max_allowed: int = DEFAULT_TABLE_SIZE):
        self.max_allowed = max_allowed
        self.max_size = max_allowed
        self.size = 0
        self.dynamic: list[tuple[str, str]] = []  # newest first

    def _entry(self, index: int) -> tuple[str, str]:
        if index <= 0:
            raise HpackError("index 0")
        if index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        index -= len(STATIC_TABLE) + 1
        if index >= len(self.dynamic):
            raise HpackError(f"index {index + len(STATIC_TABLE) + 1} past the table")
        return self.dynamic[index]

    def _evict(self) -> None:
        while self.size > self.max_size and self.dynamic:
            name, value = self.dynamic.pop()
            self.size -= len(name) + len(value) + ENTRY_OVERHEAD

    def _add(self, name: str, value: str) -> None:
        size = len(name) + len(value) + ENTRY_OVERHEAD
        if size > self.max_size:
            # An entry larger than the table empties it (section 4.4).
            self.dynamic.clear()
            self.size = 0
            return
        self.dynamic.insert(0, (name, value))
        self.size += size
        self._evict()

    def decode(self, block: bytes) -> list[tuple[str, str]]:
        """The header list of one complete header block, in order. Names and
        values are read as Latin-1, so any octet string round-trips."""
        out: list[tuple[str, str]] = []
        pos, end = 0, len(block)
        fields_seen = False
        while pos < end:
            octet = block[pos]
            if octet & 0x80:  # indexed field
                index, pos = decode_int(block, pos, 7)
                out.append(self._entry(index))
                fields_seen = True
                continue
            if octet & 0xe0 == 0x20:  # dynamic table size update
                if fields_seen:
                    raise HpackError("table size update after a header field")
                size, pos = decode_int(block, pos, 5)
                if size > self.max_allowed:
                    raise HpackError(f"table size {size} above the allowed "
                                     f"{self.max_allowed}")
                self.max_size = size
                self._evict()
                continue
            if octet & 0xc0 == 0x40:  # literal, incremental indexing
                index, pos = decode_int(block, pos, 6)
                indexing = True
            else:  # literal without indexing (0000) or never indexed (0001)
                index, pos = decode_int(block, pos, 4)
                indexing = False
            if index:
                name = self._entry(index)[0]
            else:
                raw, pos = _decode_string(block, pos)
                name = raw.decode("latin-1")
            raw, pos = _decode_string(block, pos)
            value = raw.decode("latin-1")
            if indexing:
                self._add(name, value)
            out.append((name, value))
            fields_seen = True
        return out


# ---------------------------------------------------------------------------
# Encoder

_STATIC_EXACT = {entry: i + 1 for i, entry in reversed(list(enumerate(STATIC_TABLE)))}
_STATIC_NAME = {name: i + 1 for i, (name, _) in reversed(list(enumerate(STATIC_TABLE)))}


class Encoder:
    """One direction's header encoder: indexed static fields and literals
    without indexing, so it keeps no table. ``encode`` caches each field's
    octets."""

    def __init__(self):
        self._started = False
        self._cache: dict[tuple[str, str], bytes] = {}

    @staticmethod
    def _field(name: str, value: str) -> bytes:
        index = _STATIC_EXACT.get((name, value))
        if index is not None:
            return encode_int(index, 7, 0x80)
        raw = value.encode("latin-1")
        index = _STATIC_NAME.get(name)
        if index is not None:
            return encode_int(index, 4) + _encode_string(raw)
        return b"\x00" + _encode_string(name.encode("latin-1")) + _encode_string(raw)

    def encode(self, headers) -> bytes:
        """One header block for ``headers``, (name, value) pairs of str; the
        connection's first block opens with a table size update to 0."""
        parts = []
        if not self._started:
            self._started = True
            parts.append(b"\x20")
        cache = self._cache
        for field in headers:
            octets = cache.get(field)
            if octets is None:
                octets = self._field(*field)
                if len(cache) < 4096:
                    cache[field] = octets
            parts.append(octets)
        return b"".join(parts)
