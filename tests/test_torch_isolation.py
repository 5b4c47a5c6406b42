"""The port stands alone: no module of igaming_platform_tpu_torch, and not
chip_smoke.py, imports jax, flax, optax, orbax, ml_dtypes, msgpack, grpc,
protobuf, yaml (the card's machine has no PyYAML: the bonus rules are read by
the port's own reader), the JAX package or the repository's ``tools``
(``tools/export_params_npz.py`` converts JAX checkpoints on the JAX side;
it lives outside the port and imports nothing of it).

No exceptions: the port speaks gRPC through its own transport
(``serve/grpc_wire.py``), so ``GRPC_ALLOWED`` is empty and nothing in the
package, ``chip_smoke.py`` or ``tools/export_reflection_descriptors.py``
imports ``grpc``, at any level; grpcio is a test peer only.

Checked twice: an AST walk over every import statement (including imports
inside functions), and a fresh interpreter that imports every module of the
port and then inspects ``sys.modules``, where ``grpc`` must be absent too.
``igaming_platform_tpu_torch`` is the port itself and is not a match for
``igaming_platform_tpu``.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "igaming_platform_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes", "msgpack", "grpc",
             "google.protobuf", "igaming_platform_tpu", "tools", "yaml")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


# (file, function or Class.method) whose body may import grpc: none, since the
# port has its own gRPC transport.
GRPC_ALLOWED: set[tuple[str, str]] = set()


def _imported(node):
    if isinstance(node, ast.Import):
        yield from (alias.name for alias in node.names)
    elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
        yield node.module
    elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
          and node.func.attr == "import_module" and node.args
          and isinstance(node.args[0], ast.Constant)):
        yield node.args[0].value


def _imports(path: Path):
    """(module, the top-level function or ``Class.method`` it is imported
    in, or None)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    funcs = (ast.FunctionDef, ast.AsyncFunctionDef)
    scopes = []
    for top in tree.body:
        if isinstance(top, ast.ClassDef):
            scopes += [(f"{top.name}.{node.name}" if isinstance(node, funcs) else None, node)
                       for node in top.body]
        else:
            scopes.append((top.name if isinstance(top, funcs) else None, top))
    for func, scope in scopes:
        for node in ast.walk(scope):
            for module in _imported(node):
                yield module, func


def _allowed(path: Path, module: str, func: str | None) -> bool:
    rel = str(path.relative_to(REPO))
    return module == "grpc" and (rel, func) in GRPC_ALLOWED


def test_matcher():
    assert _forbidden("jax.numpy") and _forbidden("igaming_platform_tpu.serve")
    assert _forbidden("google.protobuf.message") and _forbidden("grpc")
    assert not _forbidden("igaming_platform_tpu_torch.serve") and not _forbidden("jaxtyping_x")
    assert _forbidden("tools.export_params_npz")
    assert _forbidden("optax") and _forbidden("orbax.checkpoint") and _forbidden("ml_dtypes")
    assert _forbidden("msgpack") and not _forbidden("optaxish")
    assert _forbidden("yaml") and not _forbidden("yamlish")
    assert not _forbidden("igaming_platform_tpu_torch.tools.replay")


@pytest.mark.parametrize("tool,reads", [
    ("export_params_npz.py", "igaming_platform_tpu.train.checkpoint"),
    ("export_reflection_descriptors.py", "igaming_platform_tpu.proto_gen.risk.v1")])
def test_checkpoint_converter_stays_outside_the_port(tool, reads):
    """The JAX-side exporters (a checkpoint's params, reflection's
    descriptors) live outside the port and import nothing of it."""
    converter = REPO / "tools" / tool
    assert converter.exists() and PORT not in converter.parents
    imported = {m for m, _ in _imports(converter)}
    assert reads in imported
    assert not [m for m in imported if m.startswith("igaming_platform_tpu_torch")]


def test_no_forbidden_import_statement():
    sources = _sources()
    assert len(sources) >= 20 and (REPO / "chip_smoke.py").exists()
    bad = [(str(p.relative_to(REPO)), m, f) for p in sources for m, f in _imports(p)
           if _forbidden(m) and not _allowed(p, m, f)]
    assert not bad, bad
    assert not GRPC_ALLOWED
    exporter = REPO / "tools" / "export_reflection_descriptors.py"
    speaking = [(str(p.relative_to(REPO)), m) for p in [*sources, exporter]
                for m, _ in _imports(p) if m == "grpc" or m.startswith("grpc.")]
    assert not speaking, speaking
    for rel in ("serve/grpc_wire.py", "serve/h2.py", "serve/hpack.py"):
        assert (PORT / rel).exists(), rel


PLANE = ("obs/metrics.py", "obs/tracing.py", "obs/flight.py", "obs/otlp.py", "obs/slo.py",
         "obs/perfmodel.py", "obs/drift.py", "serve/deadline.py", "serve/supervisor.py",
         "utils/logging.py", "obs/hostprof.py", "obs/runtime_telemetry.py", "core/devices.py",
         "serve/reflection.py", "obs/devtrace.py")


WALLET_SIDE = ("serve/amqp.py", "serve/amqp_testing.py", "serve/ipintel.py", "core/money.py",
               *(f"platform/{m}.py" for m in (
                   "__init__", "domain", "migrations", "repository", "outbox", "wallet",
                   "bonus", "cashback", "reconcile", "seed", "risk_adapter", "app")))


@pytest.mark.parametrize("rel", WALLET_SIDE)
def test_wallet_side_stands_alone(rel):
    """The wallet side's modules, held as the operations plane's are below;
    the port's bonus rules sit beside them."""
    test_operations_plane_stands_alone(rel)
    assert (PORT / "platform" / "configs" / "bonus_rules.yaml").exists()


STORES = ("platform/pgwire.py", "platform/pg_testing.py", "platform/pg_store.py",
          "platform/server.py", "serve/redis_store.py", "serve/clickhouse.py",
          "serve/batch_refresh.py", "serve/wallet_codec.py", "serve/ledger.py",
          "serve/ltv_job.py")


@pytest.mark.parametrize("rel", STORES)
def test_stores_and_wallet_front_stand_alone(rel):
    """The stores of record, the batch refresh and the wallet front, held as
    the operations plane's modules are below; the Postgres rig the card's
    phase 16 starts is the port's own, and that phase imports nothing
    forbidden at any level."""
    test_operations_plane_stands_alone(rel)
    smoke = REPO / "chip_smoke.py"
    phase = [m for m, f in _imports(smoke) if f in ("phase_stores", "stores_pg", "stores_ledger",
                                                    "stores_refresh", "stores_redis")]
    assert "igaming_platform_tpu_torch.platform.pg_testing" in phase
    assert not [m for m in phase if _forbidden(m)]


MULTI_DEVICE = (*(f"parallel/{m}.py" for m in (
    "__init__", "mesh", "collectives", "sharding", "ep", "state_sharding", "distributed")),
    "serve/multihost.py", "serve/router.py", "obs/fleetview.py")


@pytest.mark.parametrize("rel", MULTI_DEVICE)
def test_multi_device_side_stands_alone(rel):
    """The mesh, collectives, sharding, routed experts, slot-sharded state,
    the gloo bootstrap, the multi-host front, the router and the fleet
    view, held as the operations plane's modules are below; phase 17 of
    the card's script imports nothing forbidden at any level."""
    test_operations_plane_stands_alone(rel)
    smoke = REPO / "chip_smoke.py"
    phase = [m for m, f in _imports(smoke) if f is not None and f.startswith("fleet_")
             or f == "phase_multi_device"]
    assert not [m for m in phase if _forbidden(m)]


MULTI_DEVICE_TRAINING = ("parallel/pipeline.py", "train/pp.py", "train/routed.py",
                         "ops/gbdt_matmul.py", "train/trainer.py", "train/abuse_train.py",
                         "models/ensemble.py", "train/eval.py", "ops/dense.py")


@pytest.mark.parametrize("rel", MULTI_DEVICE_TRAINING)
def test_multi_device_training_stands_alone(rel):
    """The pipeline, the pipeline trainer, the routed trainer, the matmul
    forest and the mesh trainers, held as the operations plane's modules
    are below; phase 18 of the card's script imports nothing forbidden at
    any level."""
    test_operations_plane_stands_alone(rel)
    smoke = REPO / "chip_smoke.py"
    phase = [m for m, f in _imports(smoke) if f is not None and f.startswith("mesh_train_")
             or f == "phase_train_mesh"]
    assert "igaming_platform_tpu_torch.train.fraudgen" in phase
    assert not [m for m in phase if _forbidden(m)]


WIRE = ("serve/hpack.py", "serve/h2.py", "serve/grpc_wire.py", "serve/grpc_server.py",
        "platform/risk_adapter.py")


@pytest.mark.parametrize("rel", WIRE)
def test_grpc_transport_stands_alone(rel):
    """The port's gRPC transport (HPACK, HTTP/2, gRPC) and the modules that
    serve and dial over it, held as the operations plane's modules are
    below: the transport imports only the standard library and itself."""
    test_operations_plane_stands_alone(rel)
    if rel in WIRE[:3]:
        port = [m for m, _ in _imports(PORT / rel) if m.startswith("igaming_platform_tpu_torch")]
        assert set(port) <= {"igaming_platform_tpu_torch.serve",
                             "igaming_platform_tpu_torch.serve.hpack",
                             "igaming_platform_tpu_torch.serve.h2"}, (rel, port)


@pytest.mark.parametrize("rel", PLANE)
def test_operations_plane_stands_alone(rel):
    """The operations plane's modules, held one by one: each is the port's
    own copy, imports nothing forbidden at any level, and imports no module
    of the package that does (its imports of the port resolve to files)."""
    path = PORT / rel
    assert path.exists(), rel
    imported = [m for m, _ in _imports(path)]
    assert not [m for m, f in _imports(path) if _forbidden(m) and not _allowed(path, m, f)], rel
    for m in imported:
        if m.startswith("igaming_platform_tpu_torch."):
            target = REPO.joinpath(*m.split("."))
            assert target.with_suffix(".py").exists() or target.is_dir(), (rel, m)


def test_importing_every_module_loads_none_of_them():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, check=True)
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    for m in ("serve.scorer", "serve.device_cache", "serve.session_state", "serve.wire",
              "serve.grpc_server", "serve.server", "serve.ltv_job", "models.ltv", "ops.dense",
              "train.trainer", "train.checkpoint", "train.online", "train.eval",
              "obs.metrics", "obs.tracing", "obs.flight", "obs.otlp", "obs.slo",
              "obs.perfmodel", "serve.deadline", "serve.supervisor", "utils.logging",
              "obs.hostprof", "obs.runtime_telemetry", "core.devices", "serve.reflection",
              "serve.amqp", "serve.amqp_testing", "serve.ipintel", "core.money",
              "platform.app", "platform.risk_adapter", "platform.bonus", "platform.seed",
              "platform.pgwire", "platform.pg_testing", "platform.pg_store", "platform.server",
              "serve.redis_store", "serve.clickhouse", "serve.batch_refresh",
              "serve.wallet_codec", "parallel.mesh", "parallel.collectives",
              "parallel.sharding", "parallel.ep", "parallel.state_sharding",
              "parallel.distributed", "serve.multihost", "serve.router", "obs.fleetview",
              "obs.devtrace", "serve.hpack", "serve.h2", "serve.grpc_wire"):
        assert f"igaming_platform_tpu_torch.{m}" in loaded, m
    assert not [m for m in loaded if _forbidden(m)]
