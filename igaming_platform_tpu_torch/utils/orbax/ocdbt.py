"""tensorstore's OCDBT key-value store, as Orbax lays it out on disk.

An OCDBT database is a directory holding ``manifest.ocdbt`` and data files
``d/<hex>``. Orbax writes one database per process under
``ocdbt.process_<i>/`` and a top-level one whose leaves point into theirs;
reading the top-level manifest reaches every key.

Every manifest and B+tree node is a file (or a slice of a data file) of

- a header: magic (u32 big-endian; 0x0CDB3A2A for a manifest, 0x0CDB20DE for
  a B+tree node), the total length (u64 little-endian), the format version
  (varint 0) and the compression (varint: 0 none, 1 zstd);
- a body, compressed as the header says;
- a footer: the CRC-32C of everything before it (u32 little-endian).

Bodies are columnar, with LEB128 varints:

- the manifest: the config (uuid[16], manifest kind, max inline value bytes,
  max decoded node bytes, version tree arity log2 (u8), compression method
  and, for zstd, its level (i32)), then a data file table and the newest
  versions, each a generation, a root height (u8), the root's location
  (data file id, offset, length), its statistics (keys, tree bytes, indirect
  value bytes) and a commit time (u64 ns). Older versions sit in version tree
  nodes after these; the newest version is always inline, and it is the one
  read;
- a B+tree node: its height (u8), its data file table and its entries. Keys
  are stored as a prefix length shared with the previous key and a suffix,
  relative to the prefix its parent entry hands down. A leaf entry holds a
  value inline, or a reference (data file, offset, length) to it; an
  interior entry holds the child's location and statistics and the length
  of the subtree's common key prefix;
- a data file table: path prefix lengths shared with the previous path,
  suffix lengths, base path lengths, then the suffixes.

``read_all(path)`` returns every key and value of the newest version, and
``write(path, items)`` writes a database of one version with a single leaf:
values over ``max_inline_value_bytes`` in one data file, the leaf after
them, and a manifest with Orbax's config, every body zstd-framed
(``zstd.compress``). tensorstore and Orbax read what it writes.

Format: google.github.io/tensorstore/kvstore/ocdbt.
"""

from __future__ import annotations

import os
import struct
import time
import uuid

from igaming_platform_tpu_torch.utils.orbax import zstd
from igaming_platform_tpu_torch.utils.orbax.crc32c import crc32c

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST = "manifest.ocdbt"
_MISSING = (1 << 64) - 1  # the offset and length of an empty tree's root

# The config Orbax opens its databases with (tensorstore's defaults there).
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4


class _Cursor:
    def __init__(self, data: bytes, what: str):
        self.data = data
        self.p = 0
        self.what = what

    def varint(self) -> int:
        data, p = self.data, self.p
        result = shift = 0
        while True:
            if p >= len(data):
                raise ValueError(f"ocdbt: {self.what} ends inside a varint")
            b = data[p]
            p += 1
            result |= (b & 0x7F) << shift
            if b < 0x80:
                self.p = p
                return result
            shift += 7
            if shift > 63:
                raise ValueError(f"ocdbt: {self.what} has an overlong varint")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.p + n > len(self.data):
            raise ValueError(f"ocdbt: {self.what} is truncated")
        out = self.data[self.p:self.p + n]
        self.p += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _unframe(raw: bytes, magic: int, what: str) -> bytes:
    """The body of one manifest or node, its header and CRC checked."""
    if len(raw) < 18:
        raise ValueError(f"ocdbt: {what} is too short")
    got_magic, length = struct.unpack_from(">I", raw)[0], struct.unpack_from("<Q", raw, 4)[0]
    if got_magic != magic:
        raise ValueError(f"ocdbt: {what} has magic {got_magic:#010x}, not {magic:#010x}")
    if length != len(raw):
        raise ValueError(f"ocdbt: {what} declares {length} bytes, holds {len(raw)}")
    (crc,) = struct.unpack_from("<I", raw, len(raw) - 4)
    if crc32c(memoryview(raw)[:-4]) != crc:
        raise ValueError(f"ocdbt: {what} fails its CRC-32C")
    head = _Cursor(raw[:32], what)
    head.p = 12
    version = head.varint()
    method = head.varint()
    if version != 0:
        raise ValueError(f"ocdbt: {what} has format version {version}")
    body = raw[head.p:-4]
    if method == 0:
        return body
    if method == 1:
        return zstd.decompress(body)
    raise ValueError(f"ocdbt: {what} has compression method {method}")


def _frame(magic: int, body: bytes) -> bytes:
    payload = struct.pack("<BB", 0, 1) + zstd.compress(body)  # version 0, zstd
    length = 4 + 8 + len(payload) + 4
    head = struct.pack(">I", magic) + struct.pack("<Q", length) + payload
    return head + struct.pack("<I", crc32c(head))


def _read_file_table(c: _Cursor) -> list[str]:
    n = c.varint()
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    c.varints(n)  # base path lengths: where each path splits; the join is what is read
    paths: list[str] = []
    prev = b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"ocdbt: {c.what} has a bad data file prefix")
        prev = prev[:prefix[i]] + c.take(suffix[i])
        paths.append(prev.decode())
    return paths


def _write_file_table(paths: list[str]) -> bytes:
    raw = [p.encode() for p in paths]
    prefix, suffix = [], []
    prev = b""
    for i, p in enumerate(raw):
        shared = 0
        if i:
            while shared < min(len(p), len(prev)) and p[shared] == prev[shared]:
                shared += 1
            prefix.append(shared)
        suffix.append(p[shared:])
        prev = p
    return b"".join([_varint(len(raw))] + [_varint(n) for n in prefix]
                    + [_varint(len(s)) for s in suffix] + [_varint(0)] * len(raw) + suffix)


def _read_keys(c: _Cursor, n: int, interior: bool) -> tuple[list[bytes], list[int]]:
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    common = c.varints(n) if interior else []
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"ocdbt: {c.what} has a bad key prefix")
        prev = prev[:prefix[i]] + c.take(suffix[i])
        keys.append(prev)
    return keys, common


class _Files:
    """The database's files, each read once."""

    def __init__(self, root: str):
        self.root = root
        self._cache: dict[str, bytes] = {}

    def get(self, rel: str) -> bytes:
        data = self._cache.get(rel)
        if data is None:
            full = os.path.join(self.root, rel)
            if not os.path.isfile(full):
                raise ValueError(f"ocdbt: data file {rel} is missing")
            with open(full, "rb") as f:
                data = self._cache[rel] = f.read()
        return data

    def slice(self, rel: str, offset: int, length: int) -> bytes:
        data = self.get(rel)
        if offset + length > len(data):
            raise ValueError(f"ocdbt: {rel}[{offset}:{offset + length}] lies past its end")
        return data[offset:offset + length]


def _walk(files: _Files, rel: str, offset: int, length: int, height: int, prefix: bytes,
          out: dict[bytes, bytes]) -> None:
    what = f"B+tree node {rel}@{offset}"
    c = _Cursor(_unframe(files.slice(rel, offset, length), NODE_MAGIC, what), what)
    got_height = c.u8()
    if got_height != height:
        raise ValueError(f"ocdbt: {what} has height {got_height}, its parent says {height}")
    table = _read_file_table(c)
    n = c.varint()
    keys, common = _read_keys(c, n, interior=height > 0)

    def data_file(i: int) -> str:
        if i >= len(table):
            raise ValueError(f"ocdbt: {what} names data file {i} of {len(table)}")
        return table[i]

    if height > 0:
        ids, offsets, lengths = c.varints(n), c.varints(n), c.varints(n)
        c.varints(3 * n)  # statistics: keys, tree bytes, indirect value bytes
        for i in range(n):
            _walk(files, data_file(ids[i]), offsets[i], lengths[i], height - 1,
                  prefix + keys[i][:common[i]], out)
        return
    sizes = c.varints(n)
    kinds = c.varints(n)
    if any(k not in (0, 1) for k in kinds):
        raise ValueError(f"ocdbt: {what} has a value kind other than inline or indirect")
    n_indirect = sum(kinds)
    ids, offsets = c.varints(n_indirect), c.varints(n_indirect)
    j = 0
    for i in range(n):
        if kinds[i]:
            out[prefix + keys[i]] = files.slice(data_file(ids[j]), offsets[j], sizes[i])
            j += 1
        else:
            out[prefix + keys[i]] = c.take(sizes[i])
    if c.p != len(c.data):
        raise ValueError(f"ocdbt: {what} has {len(c.data) - c.p} bytes after its values")


def read_all(root: str) -> dict[bytes, bytes]:
    """Every key and its value in the newest version of the database at
    ``root``. A missing or malformed file raises ValueError."""
    path = os.path.join(root, MANIFEST)
    if not os.path.isfile(path):
        raise ValueError(f"ocdbt: no {MANIFEST} in {root}")
    with open(path, "rb") as f:
        c = _Cursor(_unframe(f.read(), MANIFEST_MAGIC, MANIFEST), MANIFEST)
    c.take(16)  # uuid
    kind = c.varint()
    if kind != 0:
        raise ValueError("ocdbt: numbered manifests are not supported")
    c.varint()  # max inline value bytes
    c.varint()  # max decoded node bytes
    c.u8()  # version tree arity log2
    if c.varint() == 1:
        c.take(4)  # zstd level
    table = _read_file_table(c)
    n = c.varint()
    if n == 0:
        return {}
    gens, heights = c.varints(n), [c.u8() for _ in range(n)]
    ids, offsets, lengths = c.varints(n), c.varints(n), c.varints(n)
    latest = max(range(n), key=gens.__getitem__)
    out: dict[bytes, bytes] = {}
    if offsets[latest] == _MISSING and lengths[latest] == _MISSING:
        return out
    if ids[latest] >= len(table):
        raise ValueError(f"ocdbt: the manifest names data file {ids[latest]} of {len(table)}")
    _walk(_Files(root), table[ids[latest]], offsets[latest], lengths[latest], heights[latest],
          b"", out)
    return out


def _leaf(items: list[tuple[bytes, bytes]], data_file: str | None,
          offsets: dict[bytes, int]) -> bytes:
    keys = [k for k, _ in items]
    prefix, suffix = [], []
    prev = b""
    for i, k in enumerate(keys):
        shared = 0
        if i:
            m = min(len(k), len(prev))
            while shared < m and k[shared] == prev[shared]:
                shared += 1
            prefix.append(shared)
        suffix.append(k[shared:])
        prev = k
    indirect = [k for k in keys if k in offsets]
    parts = [bytes([0]), _write_file_table([data_file] if indirect else []), _varint(len(keys))]
    parts += [_varint(n) for n in prefix] + [_varint(len(s)) for s in suffix] + suffix
    parts += [_varint(len(v)) for _, v in items]
    parts += [b"\x01" if k in offsets else b"\x00" for k in keys]
    parts += [_varint(0)] * len(indirect) + [_varint(offsets[k]) for k in indirect]
    parts += [v for k, v in items if k not in offsets]
    return b"".join(parts)


def write(root: str, items: dict[bytes, bytes]) -> None:
    """A database of one version holding ``items`` at ``root`` (a directory
    that is created, or is empty)."""
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    pairs = sorted(items.items())
    data_file = f"d/{uuid.uuid4().hex}"
    blob = bytearray()
    offsets: dict[bytes, int] = {}
    for k, v in pairs:
        if len(v) > MAX_INLINE_VALUE_BYTES:
            offsets[k] = len(blob)
            blob += v
    body = _leaf(pairs, data_file, offsets)
    if len(body) > MAX_DECODED_NODE_BYTES:
        raise ValueError(f"ocdbt: a leaf of {len(body)} bytes is over the node limit")
    node = _frame(NODE_MAGIC, body)
    node_offset = len(blob)
    blob += node
    with open(os.path.join(root, data_file), "wb") as f:
        f.write(blob)
    config = (uuid.uuid4().bytes + _varint(0) + _varint(MAX_INLINE_VALUE_BYTES)
              + _varint(MAX_DECODED_NODE_BYTES) + bytes([VERSION_TREE_ARITY_LOG2])
              + _varint(1) + struct.pack("<i", 0))
    version = (_write_file_table([data_file]) + _varint(1)  # one version
               + _varint(1) + bytes([0])  # generation 1, a root of height 0
               + _varint(0) + _varint(node_offset) + _varint(len(node))
               + _varint(len(pairs)) + _varint(len(node)) + _varint(sum(
                   len(v) for k, v in pairs if k in offsets))
               + struct.pack("<Q", time.time_ns()) + _varint(0))  # no version tree nodes
    with open(os.path.join(root, MANIFEST), "wb") as f:
        f.write(_frame(MANIFEST_MAGIC, config + version))
