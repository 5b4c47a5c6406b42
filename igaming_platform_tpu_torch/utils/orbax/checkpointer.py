"""``save_tree`` and ``restore_tree`` in the layout
``orbax.checkpoint.StandardCheckpointer`` writes (Orbax 0.11), without Orbax.

A checkpoint directory holds

- ``_METADATA``: JSON ``{"tree_metadata": {...}, "use_ocdbt": true,
  "use_zarr3": false, "store_array_data_equal_to_fill_value": true,
  "custom_metadata": null}``. Each tree entry is keyed by the repr of its
  path's tuple (``"('params', 'trunk', 'layers', '0', 'w')"``) and holds
  ``key_metadata`` (each key with ``key_type`` 1 for a sequence index, 2
  for a dict key) and ``value_metadata`` (``value_type``: ``np.ndarray``,
  ``scalar`` for a Python number, ``None``, ``Dict`` or ``List`` for an
  empty container; ``skip_deserialize`` true for the last three);
- ``_CHECKPOINT_METADATA``: the handler's name and commit times;
- an OCDBT database (``ocdbt.py``) whose keys are zarr v2 arrays
  (``zarr.py``) named by the path joined with dots
  (``params.trunk.layers.0.w``).

``restore_tree`` returns the nesting ``StandardCheckpointer().restore(path)``
returns: dicts for dict keys, lists for sequences (a saved tuple comes back
a list), numpy arrays (a ``torch.bfloat16`` tensor for bfloat16), Python
scalars for ``scalar`` entries, None and empty containers as saved. A
checkpoint that uses zarr3, or not OCDBT, raises ValueError that says so.

``save_tree`` writes a tree of dicts, lists, tuples, numpy arrays, torch
tensors, Python scalars and None into a temporary directory beside
``path`` (its name starts with a dot, so no ``step_*`` scan sees it), then
renames it into place. Orbax restores what it writes.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any

import numpy as np

from igaming_platform_tpu_torch.utils.orbax import ocdbt, zarr

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")
_SEQUENCE, _DICT = 1, 2
_EMPTY = {"None": None, "Dict": dict, "List": list}


def _leaves(tree, path: tuple, out: list) -> None:
    if isinstance(tree, dict):
        if not tree:
            out.append((path, "Dict", None))
        for k, v in tree.items():
            _leaves(v, path + ((str(k), _DICT),), out)
    elif isinstance(tree, (list, tuple)):
        if not tree:
            out.append((path, "List", None))
        for i, v in enumerate(tree):
            _leaves(v, path + ((str(i), _SEQUENCE),), out)
    elif tree is None:
        out.append((path, "None", None))
    elif isinstance(tree, (bool, int, float)):
        out.append((path, "scalar", np.asarray(tree)))
    else:
        out.append((path, "np.ndarray", tree))


def save_tree(path: str, tree: Any) -> str:
    """Write ``tree`` as an Orbax checkpoint at ``path`` (which must not
    exist); returns the absolute path."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        raise FileExistsError(f"checkpoint {path} already exists")
    init = time.time_ns()
    leaves: list = []
    _leaves(tree, (), leaves)
    if not leaves or any(not p for p, _, _ in leaves):
        raise ValueError("save_tree needs a dict or sequence at the root")
    items: dict[bytes, bytes] = {}
    meta = {}
    for keys, value_type, value in leaves:
        names = tuple(k for k, _ in keys)
        if value is not None:
            zarr.write_array(items, ".".join(names), value)
        meta[repr(names)] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
            "value_metadata": {"value_type": value_type,
                               "skip_deserialize": value_type in _EMPTY}}
    parent, name = os.path.split(path)
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".{name}.orbax-checkpoint-tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        ocdbt.write(tmp, items)
        with open(os.path.join(tmp, METADATA), "w") as f:
            json.dump({"tree_metadata": meta, "use_ocdbt": True, "use_zarr3": False,
                       "store_array_data_equal_to_fill_value": True,
                       "custom_metadata": None}, f)
        with open(os.path.join(tmp, CHECKPOINT_METADATA), "w") as f:
            json.dump({"item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
                       "init_timestamp_nsecs": init, "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": {}}, f)
        os.rename(tmp, path)  # a reader sees the whole checkpoint or none
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def _place(root: dict, keys: list[tuple[str, int]], value) -> None:
    node = root
    for k, t in keys[:-1]:
        node = node.setdefault((k, t), {})
    node[keys[-1]] = value


def _build(node):
    """Nested ``{(key, key_type): ...}`` -> dicts and lists."""
    if not isinstance(node, dict) or not node or not isinstance(next(iter(node)), tuple):
        return node
    if all(t == _SEQUENCE for _, t in node):
        ordered = sorted(node.items(), key=lambda kv: int(kv[0][0]))
        if [int(k) for (k, _), _ in ordered] != list(range(len(ordered))):
            raise ValueError("checkpoint: a sequence's indices have gaps")
        return [_build(v) for _, v in ordered]
    return {k: _build(v) for (k, _), v in node.items()}


def restore_tree(path: str) -> Any:
    """The tree of the Orbax checkpoint at ``path``."""
    meta_path = os.path.join(path, METADATA)
    if not os.path.isfile(meta_path):
        raise ValueError(f"{path} is not an Orbax checkpoint: no {METADATA}")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{path} stores its arrays in zarr3, which the port does not read "
                         "(only zarr v2 over OCDBT, Orbax's default)")
    if not meta.get("use_ocdbt"):
        raise ValueError(f"{path} is not an OCDBT checkpoint, which the port does not read "
                         "(only zarr v2 over OCDBT, Orbax's default)")
    items = ocdbt.read_all(path)
    root: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [(km["key"], km["key_type"]) for km in entry["key_metadata"]]
        value_type = entry["value_metadata"]["value_type"]
        if value_type in _EMPTY:
            value = _EMPTY[value_type]() if _EMPTY[value_type] else None
        else:
            value = zarr.read_array(items, ".".join(k for k, _ in keys))
            if value_type == "scalar":
                value = value.item()
        _place(root, keys, value)
    return _build(root)
