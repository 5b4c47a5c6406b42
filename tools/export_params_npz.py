"""Export a JAX checkpoint's params as an ``.npz`` the PyTorch port boots.

``python -m tools.export_params_npz SRC OUT.npz`` reads SRC, either an
Orbax checkpoint directory written by ``train/checkpoint.py``
(``save_checkpoint``; restored with ``restore_params_for_serving``, as the
JAX server boots it) or a flax ``.msgpack`` of a multitask params tree (as
``tests/golden/released_multitask.msgpack``), and writes the multitask
tree as ``{"multitask": tree}``: one array per leaf, its path joined by
``/`` (``multitask/trunk/layers/0/w``, ...). That is the layout the port's
``convert.load_params_tree`` reads, so the file serves as the port's
``FRAUD_MODEL_PATH`` and as replay's ``--params``. The machine with the card
has neither orbax nor msgpack, so the conversion is made here, on the JAX
side.

This script imports the JAX package and never the port; the port never
imports it. It keeps its own copy of the writer, pinned to the port's
reader by ``tests/test_torch_boot.py``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _lists(node):
    """A restored tree with numpy leaves, dicts whose keys are all list
    positions ("0", "1", ...: msgpack's and some Orbax restores' form of a
    list) turned back into lists."""
    if isinstance(node, (list, tuple)):
        return [_lists(v) for v in node]
    if not isinstance(node, dict):
        return np.asarray(node)
    if node and all(str(k).isdigit() for k in node):
        return [_lists(node[k]) for k in sorted(node, key=int)]
    return {str(k): _lists(v) for k, v in node.items()}


def tree_from_orbax(path: str) -> dict:
    """The params tree of an Orbax checkpoint, as the JAX server restores it."""
    from igaming_platform_tpu.train.checkpoint import restore_params_for_serving

    return _lists(restore_params_for_serving(os.path.abspath(path)))


def tree_from_msgpack(path: str) -> dict:
    """The params tree of a flax ``.msgpack`` (``serialization.to_bytes``)."""
    from flax import serialization

    with open(path, "rb") as f:
        return _lists(serialization.msgpack_restore(f.read()))


def load_tree(src: str) -> dict:
    """The multitask params tree at ``src``: an Orbax directory or a
    ``.msgpack`` file. Raises ValueError for a tree that is not multitask."""
    tree = tree_from_orbax(src) if os.path.isdir(src) else tree_from_msgpack(src)
    if not isinstance(tree, dict) or not {"trunk", "fraud_head"} <= set(tree):
        raise ValueError(f"{src}: not a multitask params tree")
    return tree


def save_params_tree(path: str, tree: dict) -> None:
    """``tree`` (nested dicts and lists of numpy arrays) to an ``.npz``, one
    array per leaf, its path joined by ``/``."""
    flat: dict[str, np.ndarray] = {}

    def walk(node, prefix: str) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}/")
        else:
            flat[prefix[:-1]] = np.asarray(node)

    walk(tree, "")
    with open(path, "wb") as f:
        np.savez(f, **flat)


def export(src: str, out: str) -> dict:
    """Write ``{"multitask": load_tree(src)}`` to ``out``; returns the tree."""
    tree = {"multitask": load_tree(src)}
    save_params_tree(out, tree)
    return tree


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("src", help="an Orbax checkpoint directory or a flax .msgpack")
    parser.add_argument("out", help="the .npz to write")
    args = parser.parse_args(argv)
    tree = export(args.src, args.out)
    trunk = [int(np.shape(layer["w"])[1]) for layer in tree["multitask"]["trunk"]["layers"]]
    print(f"wrote {args.out}: multitask, trunk {tuple(trunk)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
