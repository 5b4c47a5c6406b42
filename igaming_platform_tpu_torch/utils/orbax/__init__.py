"""The port's own reader and writer of Orbax checkpoints.

The JAX package checkpoints through ``orbax.checkpoint.StandardCheckpointer``,
which stores zarr v2 arrays, zstd-compressed, in tensorstore's OCDBT
key-value store. The card's host has none of orbax, tensorstore, zstandard,
numcodecs, zarr or crc32c, so the port carries the format itself:

- ``crc32c.py``: CRC-32C, which ends every OCDBT file;
- ``zstd.py``: a zstd frame decoder, and an encoder of raw blocks;
- ``ocdbt.py``: the OCDBT manifest, B+tree and data files;
- ``zarr.py``: zarr v2 arrays over that store;
- ``checkpointer.py``: ``save_tree`` and ``restore_tree``, the
  ``StandardCheckpointer`` layout.
"""

from igaming_platform_tpu_torch.utils.orbax.checkpointer import restore_tree, save_tree

__all__ = ["restore_tree", "save_tree"]
