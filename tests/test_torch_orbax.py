"""Port parity: the port's own Orbax reader and writer (``utils/orbax``) and
the checkpoints that go through it, against orbax 0.11, tensorstore,
zstandard and google_crc32c, which are the oracles here and are absent on
the card's host.

- zstd: frames of levels 1, 3 and 19, with and without a checksum, decoded
  as ``zstandard`` decodes them; several blocks and frames, skippable
  frames; the port's raw-block frames read by ``zstandard``; a frame that
  needs a dictionary, carries a wrong checksum or is cut short raises;
- CRC-32C equal to ``google_crc32c``;
- OCDBT: every key and value equal to tensorstore's ``list``/``read`` on
  databases Orbax wrote (a ``TrainConfig()`` trainer checkpoint, a
  ``routed`` bundle, the committed fixtures) and on one tensorstore wrote
  with small nodes (a B+tree of height 2, values inline and in a data
  file); tensorstore reads the port's writer;
- ``restore_tree`` bit-equal to ``StandardCheckpointer().restore``, leaf
  for leaf, and Orbax restores what ``save_tree`` writes bit-equal, for
  those checkpoints and a tree of every dtype and container; zarr3 or
  non-OCDBT checkpoints and corrupt files raise;
- a JAX ``TrainingLoop``'s checkpoint resumes the port's loop, and the
  port's resumes the JAX loop; each then runs 3 steps against the other
  package's loop from the same checkpoint (losses rtol 1e-4, params rtol
  1e-4 / atol 1e-6, as tests/test_torch_train.py);
- the params vault across packages for ``mlp+gbdt``, ``multitask``, the
  int8 trees and the ``routed`` bundle: the JAX ``vault_load`` reads the
  port's entries and the port's reads the JAX's, fingerprints equal; the
  port's replay resolves its own vault entries with 0 mismatches, and a JAX
  service's with 0 fingerprint mismatches and every field equal but
  ``ml_score``, within 1e-6 (the two packages' CPU sums);
- the committed fixtures under ``tests/golden/orbax/`` are what
  :func:`build_fixtures` builds (``python tests/test_torch_orbax.py`` writes
  them again).
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import google_crc32c
import jax
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
import zstandard

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from igaming_platform_tpu_torch import convert  # noqa: E402
from igaming_platform_tpu_torch.utils.orbax import (  # noqa: E402
    crc32c,
    ocdbt,
    restore_tree,
    save_tree,
    zstd,
)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
FIXTURES = os.path.join(GOLDEN, "orbax")
SEED = 22


def trainer_fixture(root: str = FIXTURES) -> str:
    return os.path.join(root, "trainer", "step_00000003")


def vault_fixture(root: str = FIXTURES) -> str:
    vault = os.path.join(root, "vault")
    (entry,) = os.listdir(vault)
    return os.path.join(vault, entry)


def build_fixtures(root: str) -> tuple[str, str]:
    """Write the fixtures with the JAX package into ``root``: a
    ``save_checkpoint`` of a ``TrainState`` whose params are
    ``released_multitask.msgpack``'s tree, its opt_state ``TrainConfig``'s
    adamw after 3 updates with seeded gradients, at step 3 (a tenth of the
    weights get a gradient, so that the moments compress and the fixtures
    stay under 200 KB); and a
    ``vault_save`` of an ``mlp+gbdt`` tree at the serving width (an MLP of
    128x128, 64 trees of depth 4) from ``jax.random.key(SEED)``. Returns
    their paths."""
    from igaming_platform_tpu.models.gbdt import init_gbdt
    from igaming_platform_tpu.models.mlp import init_mlp
    from igaming_platform_tpu.train.checkpoint import save_checkpoint
    from igaming_platform_tpu.train.promote import vault_save
    from igaming_platform_tpu.train.trainer import TrainConfig, TrainState
    from tools.export_params_npz import tree_from_msgpack

    params = tree_from_msgpack(os.path.join(GOLDEN, "released_multitask.msgpack"))
    cfg = TrainConfig()
    opt = optax.adamw(cfg.learning_rate, weight_decay=cfg.weight_decay)
    state = opt.init(params)
    rng = np.random.default_rng(SEED)
    live = jax.tree.map(lambda p: rng.random(np.shape(p)) < 0.1, params)
    for _ in range(3):
        grads = jax.tree.map(
            lambda p, m: (rng.standard_normal(np.shape(p)) * m).astype(np.float32), params, live)
        _, state = opt.update(grads, state, params)
    step_dir = save_checkpoint(os.path.join(root, "trainer"),
                               TrainState(params, jax.device_get(state), 3))
    k_mlp, k_gbdt = jax.random.split(jax.random.key(SEED))
    tree = jax.device_get({"mlp": init_mlp(k_mlp, hidden=(128, 128)),
                           "gbdt": init_gbdt(k_gbdt, n_trees=64, depth=4)})
    fp = vault_save(os.path.join(root, "vault"), tree)
    return step_dir, os.path.join(root, "vault", fp)


# ---------------------------------------------------------------------------
# Shared helpers


def orbax_restore(path: str):
    with ocp.StandardCheckpointer() as ckptr:
        return ckptr.restore(path)


def ts_items(path: str) -> dict[bytes, bytes]:
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}"}).result()
    return {k: bytes(kv.read(k).result().value) for k in kv.list().result()}


def assert_same_tree(got, want, path: str = "") -> None:
    """Leaf for leaf, bit for bit: dtype, shape and bytes; a port bfloat16
    tensor against an ``ml_dtypes`` array by its bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}/{i}")
    elif isinstance(want, np.ndarray):
        if isinstance(got, torch.Tensor):
            assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16", path
            got = got.view(torch.int16).numpy()
            want = want.view(np.int16)
        assert isinstance(got, np.ndarray), (path, type(got))
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
        assert got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.fixture(scope="module")
def orbax_dirs(tmp_path_factory):
    """Checkpoints Orbax wrote: a ``TrainConfig()`` trainer's at step 0, a
    ``routed`` bundle in a JAX vault, and a tree of every dtype and
    container the format holds (bfloat16 and a 4 MB array among them)."""
    import ml_dtypes

    from igaming_platform_tpu.models.ensemble import init_routed_params
    from igaming_platform_tpu.train.checkpoint import save_checkpoint
    from igaming_platform_tpu.train.promote import vault_save
    from igaming_platform_tpu.train.trainer import Trainer, TrainConfig

    root = tmp_path_factory.mktemp("orbax")
    out = {"trainer": save_checkpoint(str(root / "trainer"), Trainer(TrainConfig()).state)}
    routed = jax.device_get(init_routed_params(jax.random.key(3)))
    out["routed"] = os.path.join(str(root / "vault"), vault_save(str(root / "vault"), routed))
    rng = np.random.default_rng(SEED)
    tree = {"forest_leaves": rng.standard_normal((1000, 64)).astype(np.float32),
            "big": rng.standard_normal((1024, 1024)).astype(np.float32),
            "bf16": rng.standard_normal((5, 7)).astype(ml_dtypes.bfloat16),
            "flags": np.array([True, False, True]), "i8": np.arange(-5, 5, dtype=np.int8),
            "u8": np.arange(10, dtype=np.uint8), "f64": np.linspace(0, 1, 3),
            "i64": np.int64(7), "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
            "seq": [np.float32(1.5), {"x": np.zeros(2, np.int32)}],
            "tup": (np.ones(2, np.float32),),
            "none": None, "empty_dict": {}, "empty_list": [], "py": {"b": True, "i": 3, "f": 1.5}}
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(str(root / "dtypes"), tree)
    out["dtypes"] = str(root / "dtypes")
    out["trainer_fixture"] = trainer_fixture()
    out["vault_fixture"] = vault_fixture()
    return out


# ---------------------------------------------------------------------------
# zstd and CRC-32C


def _payload(name: str) -> bytes:
    rng = np.random.default_rng(SEED)
    return {"empty": b"", "one_byte": b"\x7f",
            "f32_100k": rng.standard_normal(25_000).astype(np.float32).tobytes(),
            "zeros_1m": bytes(1 << 20)}[name]


@pytest.mark.parametrize("checksum", [False, True], ids=["plain", "checksum"])
@pytest.mark.parametrize("payload", ["empty", "one_byte", "f32_100k", "zeros_1m"])
@pytest.mark.parametrize("level", [1, 3, 19])
def test_zstd_decodes_as_zstandard(level, payload, checksum):
    data = _payload(payload)
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    assert zstd.decompress(frame) == data


@pytest.mark.parametrize("case", ["blocks", "frames", "raw_blocks", "dictionary", "bad_checksum",
                                  "truncated"])
def test_zstd_frames(case):
    rng = np.random.default_rng(SEED)
    text = b"".join(b"account %d bet %d; " % (i % 97, rng.integers(0, 500)) for i in range(40_000))
    ints = np.arange(300_000, dtype=np.int32).tobytes()
    if case == "blocks":  # several blocks a frame: repeat tables and offsets across them
        for level in (1, 19):
            cobj = zstandard.ZstdCompressor(level=level, write_checksum=True).compressobj()
            frame = b"".join(cobj.compress(text[i:i + 50_000]) + cobj.flush(
                zstandard.COMPRESSOBJ_FLUSH_BLOCK) for i in range(0, len(text), 50_000))
            frame += cobj.flush()
            assert zstd.decompress(frame) == text
            assert zstd.decompress(zstandard.ZstdCompressor(level=level).compress(ints)) == ints
    elif case == "frames":  # concatenated frames around a skippable one
        c = zstandard.ZstdCompressor(level=3)
        skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"hello"
        assert zstd.decompress(c.compress(text) + skippable + c.compress(ints)) == text + ints
    elif case == "raw_blocks":  # the port's frames, read by zstandard
        for data in (b"", b"x", text, bytes(300_000), ints):
            frame = zstd.compress(data)
            assert zstandard.ZstdDecompressor().decompress(frame, max_output_size=1 << 24) == data
            assert zstd.decompress(frame) == data
    elif case == "dictionary":
        samples = [(b"account %d bet %d; " % (i, 7 * i)) * 20 for i in range(500)]
        d = zstandard.train_dictionary(2048, samples)
        frame = zstandard.ZstdCompressor(dict_data=d).compress(samples[3])
        with pytest.raises(ValueError, match="dictionary"):
            zstd.decompress(frame)
    elif case == "bad_checksum":
        frame = bytearray(zstandard.ZstdCompressor(write_checksum=True).compress(text))
        frame[-1] ^= 0xFF
        with pytest.raises(ValueError, match="checksum"):
            zstd.decompress(bytes(frame))
    else:
        frame = zstandard.ZstdCompressor(level=3).compress(text)
        for n in (3, 5, 8, len(frame) // 2, len(frame) - 1):
            with pytest.raises(ValueError, match="zstd"):
                zstd.decompress(frame[:n])


def test_crc32c_matches_google_crc32c():
    rng = np.random.default_rng(SEED)
    assert crc32c.crc32c(b"123456789") == 0xE3069283
    for n in (0, 1, 7, 8, 9, 63, 64, 1000, 100_003):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert crc32c.crc32c(data) == google_crc32c.value(data), n
    assert crc32c.crc32c(b"56789", crc32c.crc32c(b"1234")) == 0xE3069283


# ---------------------------------------------------------------------------
# OCDBT and the checkpointer


def _small_node_db(path: str) -> dict[bytes, bytes]:
    """A database tensorstore writes with nodes of at most 300 bytes and
    values over 8 bytes out of line: a B+tree of height 2."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}", "config": {
        "max_decoded_node_bytes": 300, "max_inline_value_bytes": 8,
        "compression": {"id": "zstd"}}}).result()
    items = {b"key%03d/x" % i: bytes([i]) * (3 if i % 3 else 20) for i in range(60)}
    with ts.Transaction() as txn:
        for k, v in items.items():
            kv.with_transaction(txn).write(k, v).result()
    return items


@pytest.mark.parametrize("case", ["trainer", "routed", "dtypes", "trainer_fixture",
                                  "vault_fixture", "small_nodes", "port_written"])
def test_ocdbt_reads_as_tensorstore(case, orbax_dirs, tmp_path):
    if case == "small_nodes":
        path = str(tmp_path / "db")
        items = _small_node_db(path)
    elif case == "port_written":
        path = str(tmp_path / "db")
        rng = np.random.default_rng(SEED)
        items = {b"": b"empty key", b"a/.zarray": b"{}", b"inline": b"x" * 1024,
                 b"indirect": b"y" * 1025, b"zz": b"", b"big": rng.bytes(300_000)}
        ocdbt.write(path, items)
    else:
        path = orbax_dirs[case]
        items = None
    want = ts_items(path)
    if items is not None:
        assert want == items
    assert ocdbt.read_all(path) == want


def test_ocdbt_walks_a_tree_of_height_two(tmp_path):
    path = str(tmp_path / "db")
    items = _small_node_db(path)
    heights = []
    walk = ocdbt._walk

    def spy(files, rel, offset, length, height, prefix, out):
        heights.append(height)
        return walk(files, rel, offset, length, height, prefix, out)

    ocdbt._walk = spy
    try:
        assert ocdbt.read_all(path) == items
    finally:
        ocdbt._walk = walk
    assert max(heights) >= 2 and heights.count(0) > 2


@pytest.mark.parametrize("dtype", ["float32", "int8", "bool"])
def test_zarr_reads_chunked_arrays(dtype, tmp_path):
    """An array tensorstore writes in several chunks, edge chunks padded,
    one chunk left unwritten (zeros, the null fill)."""
    from igaming_platform_tpu_torch.utils.orbax import zarr

    rng = np.random.default_rng(SEED)
    want = (rng.standard_normal((10, 7)) * 50).astype(dtype)
    want[6:9, 4:] = 0
    base = {"driver": "ocdbt", "base": f"file://{tmp_path}"}
    arr = ts.open({"driver": "zarr", "kvstore": {**base, "path": "a/"},
                   "metadata": {"shape": [10, 7], "chunks": [3, 4],
                                "dtype": np.dtype(dtype).str if dtype != "bool" else "|b1",
                                "compressor": {"id": "zstd", "level": 3},
                                "fill_value": None}, "create": True}).result()
    for i in range(0, 10, 3):
        for j in range(0, 7, 4):
            if (i, j) != (6, 4):
                box = (slice(i, min(i + 3, 10)), slice(j, min(j + 4, 7)))
                arr[box].write(want[box]).result()
    items = ocdbt.read_all(str(tmp_path))
    assert b"a/2.1" not in items and b"a/3.1" in items
    got = zarr.read_array(items, "a")
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("case", ["trainer", "routed", "dtypes", "trainer_fixture",
                                  "vault_fixture"])
def test_restore_tree_bit_equal_to_orbax(case, orbax_dirs, tmp_path):
    want = orbax_restore(orbax_dirs[case])
    got = restore_tree(orbax_dirs[case])
    assert_same_tree(got, want)
    again = save_tree(str(tmp_path / "port"), got)
    assert not [p for p in os.listdir(tmp_path) if p.startswith(".")]
    assert_same_tree(orbax_restore(again), want)
    assert_same_tree(restore_tree(again), want)
    assert ts_items(again) == ocdbt.read_all(again)


@pytest.mark.parametrize("case", ["zarr3", "not_ocdbt", "bad_crc", "missing_data_file",
                                  "exists"])
def test_unreadable_checkpoints_raise(case, orbax_dirs, tmp_path):
    path = str(tmp_path / "ckpt")
    shutil.copytree(orbax_dirs["vault_fixture"], path)
    meta_path = os.path.join(path, "_METADATA")
    with open(meta_path) as f:
        meta = json.load(f)
    if case == "exists":
        with pytest.raises(FileExistsError):
            save_tree(path, {"a": np.zeros(2)})
        return
    if case in ("zarr3", "not_ocdbt"):
        meta["use_zarr3" if case == "zarr3" else "use_ocdbt"] = case == "zarr3"
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        match = "zarr3" if case == "zarr3" else "not an OCDBT"
    elif case == "bad_crc":
        manifest = os.path.join(path, "manifest.ocdbt")
        raw = bytearray(open(manifest, "rb").read())
        raw[-1] ^= 1
        open(manifest, "wb").write(bytes(raw))
        match = "CRC"
    else:
        shutil.rmtree(os.path.join(path, "ocdbt.process_0"))
        match = "missing"
    with pytest.raises(ValueError, match=match):
        restore_tree(path)


# ---------------------------------------------------------------------------
# Trainer checkpoints across packages


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_training_loop_resumes_across_packages(writer, tmp_path):
    """One package's loop trains 2 steps and checkpoints; the other
    package's loop resumes it. Then both loops resume the same checkpoint
    and run 3 steps on the same stream."""
    from igaming_platform_tpu.train import checkpoint as jcheckpoint
    from igaming_platform_tpu.train import loop as jloop
    from igaming_platform_tpu.train import trainer as jtrainer
    from igaming_platform_tpu_torch.train import checkpoint, loop, trainer

    kw = dict(batch_size=64, trunk=(32, 32))
    ckpt = str(tmp_path / "ckpt")
    jt = jtrainer.Trainer(jtrainer.TrainConfig(**kw))
    if writer == "jax":
        jloop.TrainingLoop(jt, config=jloop.LoopConfig(checkpoint_dir=ckpt)).run_steps(2)
        jcheckpoint.save_checkpoint(ckpt, jt.state)
    else:
        pt = trainer.Trainer(trainer.TrainConfig(**kw), device="cpu")
        pt.state = convert.trainer_state_from_jax(jax.device_get(jt.state.params),
                                                  jax.device_get(jt.state.opt_state), 0)
        loop.TrainingLoop(pt, config=loop.LoopConfig(checkpoint_dir=ckpt)).run_steps(2)
        checkpoint.save_checkpoint(ckpt, pt.state)
    assert sorted(os.listdir(ckpt)) == ["step_00000002"]
    cfg = dict(checkpoint_dir=ckpt, checkpoint_every=0, swap_every=0)
    jl = jloop.TrainingLoop(config=jloop.LoopConfig(**cfg),
                            train_config=jtrainer.TrainConfig(**kw, seed=5))
    pl = loop.TrainingLoop(config=loop.LoopConfig(**cfg),
                           train_config=trainer.TrainConfig(**kw, seed=5), device="cpu")
    assert jl.trainer.state.step == pl.trainer.state.step == 2
    assert int(pl.trainer.state.opt_state.count) == 2
    want_tree = jax.device_get(jl.trainer.state.params)
    assert_same_tree(convert.multitask_to_tree(pl.trainer.state.params), want_tree)
    for _ in range(3):
        jm, pm = jl.run_steps(1), pl.run_steps(1)
        for k in ("loss", "fraud_loss", "ltv_loss", "churn_loss"):
            np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, err_msg=k)
    got = convert.multitask_to_tree(pl.trainer.state.params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jax.device_get(jl.trainer.state.params))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    # The JAX restore_trainer reads what the port saves, moments included.
    checkpoint.save_checkpoint(str(tmp_path / "out"), pl.trainer.state)
    fresh = jtrainer.Trainer(jtrainer.TrainConfig(**kw, seed=9))
    assert jcheckpoint.restore_trainer(fresh, str(tmp_path / "out")) and fresh.state.step == 5
    adam = jax.device_get(fresh.state.opt_state)[0]
    assert int(adam.count) == 5
    state = pl.trainer.state
    assert_same_tree(jax.device_get(adam.mu),
                     convert.multitask_to_tree(state.params, state.opt_state.mu))


# ---------------------------------------------------------------------------
# The params vault and replay across packages


def _serving_tree(backend: str) -> tuple[dict, str]:
    """A JAX serving tree of ``backend`` and the backend (an int8 one
    quantized by the JAX package; the routed bundle with its ``mock``
    None, as the JAX engine holds it)."""
    from igaming_platform_tpu.models.ensemble import init_routed_params
    from igaming_platform_tpu.models.multitask import init_multitask
    from igaming_platform_tpu.ops.quantize import quantize_checkpoint
    from test_torch_ensemble import jax_tree

    if backend == "routed":
        return jax.device_get(init_routed_params(jax.random.key(SEED), trunk=(64, 64))), backend
    tree = {**jax_tree("mlp+gbdt"),
            "multitask": jax.device_get(init_multitask(jax.random.key(SEED), trunk=(64, 64)))}
    if backend.endswith("_int8"):
        base = backend[:-len("_int8")]
        tree, backend = quantize_checkpoint({k: tree[k] for k in convert.BACKEND_KEYS[base]}, base)
        tree = jax.device_get(tree)
    return {k: tree[k] for k in convert.BACKEND_KEYS[backend]}, backend


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("backend", ["mlp+gbdt", "multitask", "mlp+gbdt_int8", "multitask_int8",
                                     "routed"])
def test_vault_across_packages(backend, writer, tmp_path):
    from igaming_platform_tpu.serve.ledger import params_fingerprint as jfingerprint
    from igaming_platform_tpu.train import promote as jpromote
    from igaming_platform_tpu_torch.serve.scorer import params_fingerprint
    from igaming_platform_tpu_torch.train import promote

    tree, backend = _serving_tree(backend)
    params = convert.from_jax_params(backend, tree)
    vault = str(tmp_path / "vault")
    if writer == "jax":
        fp = jpromote.vault_save(vault, tree)
        assert fp == jfingerprint(tree) == convert.jax_fingerprint(tree)
        got = promote.vault_load(vault, fp, backend)
        assert params_fingerprint(got) == params_fingerprint(params)
        assert_same_tree(convert.to_jax_params(got), convert.to_jax_params(params))
    else:
        fp = promote.vault_save(vault, params)
        assert fp == params_fingerprint(params) and os.path.isdir(os.path.join(vault, fp))
        back = jpromote.vault_load(vault, fp)
        assert params_fingerprint(convert.from_jax_params(backend, back)) == fp
        assert jfingerprint(back) == convert.jax_fingerprint(convert.to_jax_params(params))
        assert promote.vault_load(vault, fp, backend) is not None
    with pytest.raises(ValueError, match="holds"):
        promote.vault_load(vault, fp, "mock")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_replay_resolves_vault_entries_of_either_package(writer, tmp_path, monkeypatch):
    """A ledger scored across a swap by one package's ``mlp+gbdt`` engine,
    its trees in that package's vault: the port's replay resolves both
    fingerprints through the vault and re-scores every record."""
    from test_torch_gbdt import _forest
    from torch_ledger_common import engines, pin_ledgers, requests, seed_stores

    from igaming_platform_tpu.serve import ledger as jl
    from igaming_platform_tpu.train import promote as jpromote
    from igaming_platform_tpu_torch.serve import ledger as pl
    from igaming_platform_tpu_torch.tools import replay
    from igaming_platform_tpu_torch.train import promote

    pin_ledgers(monkeypatch)
    first, _ = _serving_tree("mlp+gbdt")
    second = {**first, "gbdt": _forest(12)}
    jeng, teng = engines(first, "mlp+gbdt", seed_stores())
    eng, mod = (jeng, jl) if writer == "jax" else (teng, pl)
    (jeng if writer == "port" else teng).close()
    d = str(tmp_path / "wal")
    vault = os.path.join(d, "params-vault")
    eng.ledger = led = mod.DecisionLedger(d)
    fps = []
    try:
        for tree in (first, second):
            if tree is second:
                eng.swap_params(tree if writer == "jax" else
                                convert.from_jax_params("mlp+gbdt", tree))
            if writer == "jax":
                fps.append(jpromote.vault_save(vault, tree))
            else:
                fps.append(promote.vault_save(vault, eng.get_params()))
            assert fps[-1] == eng.params_fingerprint
            eng.score_batch(requests(40, seed=len(fps))[0 if writer == "jax" else 1])
        assert led.flush(5.0)
    finally:
        led.close()
        eng.close()
    assert sorted(os.listdir(vault)) == sorted(fps)
    verdict = replay.replay_directory(d, batch=32, tiers=(8,), device="cpu",
                                      max_mismatch_samples=80)
    assert verdict["params_fingerprint_mismatch"] == 0
    assert verdict["replayed_by_params_fp"] == {fps[0]: 40, fps[1]: 40}
    if writer == "port":
        assert verdict["mismatches"] == 0 and verdict["ok"], verdict["mismatch_samples"]
    else:
        # The JAX engine scored on XLA's CPU: the port's float32 sums agree
        # with it to the packages' ml_score tolerance, not bit for bit
        # (tests/test_torch_ensemble.py), and every other field is equal.
        for m in verdict["mismatch_samples"]:
            was, redo = m["recorded"], m["recomputed"]
            bits = np.array([was.pop("ml_score_bits"), redo.pop("ml_score_bits")], np.uint32)
            assert was == redo, m
            assert abs(float(np.diff(bits.view(np.float32))[0])) <= 1e-6, m
    # --params pins a vault entry's directory as it is.
    verdict = replay.replay_directory(d, batch=32, tiers=(8,), device="cpu",
                                      params=os.path.join(vault, fps[0]),
                                      vault_dir=str(tmp_path / "empty"))
    assert verdict["replayed_by_params_fp"] == {fps[0]: 40}


# ---------------------------------------------------------------------------
# The committed fixtures


def test_committed_fixtures_match_their_generator(tmp_path):
    step_dir, entry = build_fixtures(str(tmp_path))
    assert os.path.basename(step_dir) == "step_00000003"
    assert os.path.basename(entry) == os.path.basename(vault_fixture())
    assert_same_tree(orbax_restore(trainer_fixture()), orbax_restore(step_dir))
    assert_same_tree(orbax_restore(vault_fixture()), orbax_restore(entry))
    size = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(FIXTURES) for f in fs)
    assert size < 200_000, size


if __name__ == "__main__":  # write the fixtures again
    shutil.rmtree(FIXTURES, ignore_errors=True)
    print(build_fixtures(FIXTURES))
