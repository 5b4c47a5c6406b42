"""zarr v2 arrays over an OCDBT key space, as Orbax writes them.

An array named ``name`` is the key ``name/.zarray``, a JSON object such as
``{"chunks": [3, 1], "compressor": {"id": "zstd", "level": 1},
"dimension_separator": ".", "dtype": "<f4", "fill_value": null,
"filters": null, "order": "C", "shape": [3, 1], "zarr_format": 2}``, and one
key per chunk, its grid position joined by the separator (``0.0``; ``0`` for
a 0-d array). A chunk is the zstd frame of its C-order bytes, always of the
full chunk shape (an edge chunk is padded). A missing chunk is zeros (the
``null`` fill value Orbax writes).

dtypes: ``<f4``, ``<f8``, ``<i4``, ``<i8``, ``|i1``, ``|u1``, ``|b1``, and
``bfloat16`` as tensorstore writes it (two bytes a value, little-endian). numpy has no
bfloat16, so such an array is read and written as a ``torch.bfloat16``
tensor; every other array is numpy.

``write_array`` writes one chunk of the whole array, as Orbax does for the
port's sizes.
"""

from __future__ import annotations

import itertools
import json

import numpy as np
import torch

from igaming_platform_tpu_torch.utils.orbax import zstd

BFLOAT16 = "bfloat16"
_DTYPES = {"<f4", "<f8", "<i4", "<i8", "|i1", "|u1", "|b1"}
_ZSTD = {"id": "zstd", "level": 1}


def _numpy_dtype(code: str) -> np.dtype:
    if code == BFLOAT16:
        return np.dtype("<u2")
    if code not in _DTYPES:
        raise ValueError(f"zarr: dtype {code!r} is not supported")
    return np.dtype(code)


def read_array(items: dict[bytes, bytes], name: str):
    """The array ``name`` of a zarr v2 key space (``ocdbt.read_all``'s
    dict)."""
    meta_raw = items.get(f"{name}/.zarray".encode())
    if meta_raw is None:
        raise ValueError(f"zarr: no array {name!r}")
    meta = json.loads(meta_raw)
    if meta.get("zarr_format") != 2:
        raise ValueError(f"zarr: {name} is zarr format {meta.get('zarr_format')}, not 2")
    if meta.get("order", "C") != "C":
        raise ValueError(f"zarr: {name} is in {meta['order']} order; only C is supported")
    if meta.get("filters"):
        raise ValueError(f"zarr: {name} has filters {meta['filters']}, which are not supported")
    compressor = (meta.get("compressor") or {}).get("id")
    if compressor != "zstd":
        raise ValueError(f"zarr: {name} uses compressor {compressor!r}; only zstd is supported")
    if meta.get("fill_value") is not None:
        raise ValueError(f"zarr: {name} has fill value {meta['fill_value']!r}; only null is "
                         "supported")
    code = meta["dtype"]
    dtype = _numpy_dtype(code)
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    if len(chunks) != len(shape):
        raise ValueError(f"zarr: {name} has chunks {chunks} for shape {shape}")
    out = np.zeros(shape, dtype)
    grid = [range(-(-s // c)) if c else range(1) for s, c in zip(shape, chunks)]
    for index in itertools.product(*grid):
        key = sep.join(map(str, index)) if index else "0"
        raw = items.get(f"{name}/{key}".encode())
        if raw is None:
            continue
        data = zstd.decompress(raw)
        expect = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
        if len(data) != expect:
            raise ValueError(f"zarr: chunk {name}/{key} holds {len(data)} bytes, not {expect}")
        chunk = np.frombuffer(data, dtype).reshape(chunks)
        dst = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        src = tuple(slice(0, d.stop - d.start) for d in dst)
        out[dst] = chunk[src]
    if code == BFLOAT16:
        return torch.from_numpy(out.astype(np.int16)).view(torch.bfloat16)
    return out


def _code(value) -> tuple[str, np.ndarray]:
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return BFLOAT16, t.view(torch.int16).numpy().astype("<u2")
        value = t.numpy()
    arr = np.asarray(value)
    if not arr.flags.c_contiguous:  # ascontiguousarray would make a 0-d array 1-d
        arr = arr.copy(order="C")
    if arr.dtype == np.bool_:
        return "|b1", arr
    code = arr.dtype.newbyteorder("<").str if arr.dtype.itemsize > 1 else "|" + arr.dtype.str[1:]
    if code not in _DTYPES:
        raise ValueError(f"zarr: dtype {arr.dtype} is not supported")
    return code, arr.astype(code, copy=False)


def write_array(items: dict[bytes, bytes], name: str, value) -> None:
    """Add the array ``name`` (numpy, or a torch tensor) to ``items``, in
    one zstd-framed chunk."""
    code, arr = _code(value)
    if arr.size == 0:
        raise ValueError(f"zarr: {name} has zero size, which Orbax does not save")
    meta = {"chunks": list(arr.shape), "compressor": _ZSTD, "dimension_separator": ".",
            "dtype": code, "fill_value": None, "filters": None, "order": "C",
            "shape": list(arr.shape), "zarr_format": 2}
    items[f"{name}/.zarray".encode()] = json.dumps(meta, separators=(",", ":")).encode()
    key = ".".join("0" for _ in arr.shape) or "0"
    items[f"{name}/{key}".encode()] = zstd.compress(arr.tobytes())
