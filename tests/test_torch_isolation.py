"""The port stands alone: no module of igaming_platform_tpu_torch, and not
chip_smoke.py, imports jax, flax, optax, orbax, ml_dtypes, msgpack, grpc,
protobuf, the JAX package or the repository's ``tools``
(``tools/export_params_npz.py`` converts JAX checkpoints on the JAX side;
it lives outside the port and imports nothing of it).

One exception: ``serve/grpc_server.py`` imports ``grpc`` inside the body of
``serve_risk`` and ``make_risk_stub``, the optional gRPC binding, which only
runs when a caller asks for a gRPC port. Nothing else may import it, at any
level.

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
             "google.protobuf", "igaming_platform_tpu", "tools")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


# (file, function) whose body may import grpc: the optional gRPC binding.
GRPC_ALLOWED = {("igaming_platform_tpu_torch/serve/grpc_server.py", "serve_risk"),
                ("igaming_platform_tpu_torch/serve/grpc_server.py", "make_risk_stub")}


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
    """(module, the top-level function it is imported in, or None)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for top in tree.body:
        func = top.name if isinstance(top, (ast.FunctionDef, ast.AsyncFunctionDef)) else None
        for node in ast.walk(top):
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
    assert not _forbidden("igaming_platform_tpu_torch.tools.replay")


def test_checkpoint_converter_stays_outside_the_port():
    converter = REPO / "tools" / "export_params_npz.py"
    assert converter.exists() and PORT not in converter.parents
    imported = {m for m, _ in _imports(converter)}
    assert "igaming_platform_tpu.train.checkpoint" in imported
    assert not [m for m in imported if m.startswith("igaming_platform_tpu_torch")]


def test_no_forbidden_import_statement():
    sources = _sources()
    assert len(sources) >= 20 and (REPO / "chip_smoke.py").exists()
    bad = [(str(p.relative_to(REPO)), m, f) for p in sources for m, f in _imports(p)
           if _forbidden(m) and not _allowed(p, m, f)]
    assert not bad, bad
    binding = PORT / "serve" / "grpc_server.py"
    assert ("grpc", "serve_risk") in set(_imports(binding))  # the exception is still needed


PLANE = ("obs/metrics.py", "obs/tracing.py", "obs/flight.py", "obs/otlp.py", "obs/slo.py",
         "obs/perfmodel.py", "obs/drift.py", "serve/deadline.py", "serve/supervisor.py",
         "utils/logging.py")


@pytest.mark.parametrize("rel", PLANE)
def test_operations_plane_stands_alone(rel):
    """The operations plane's modules, held one by one: each is the port's
    own copy, imports nothing forbidden at any level, and imports no module
    of the package that does (its imports of the port resolve to files)."""
    path = PORT / rel
    assert path.exists(), rel
    imported = [m for m, _ in _imports(path)]
    assert not [m for m in imported if _forbidden(m)], rel
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
              "obs.perfmodel", "serve.deadline", "serve.supervisor", "utils.logging"):
        assert f"igaming_platform_tpu_torch.{m}" in loaded, m
    assert not [m for m in loaded if _forbidden(m)]
