"""The fraud-scoring step: normalize -> ML -> rules -> ensemble -> action, in PyTorch.

Counterpart of ``igaming_platform_tpu/models/ensemble.py`` (reference
pipeline: engine.go:262-323). One function over a [B, 30] batch on one
device; PyTorch runs it eagerly, op by op, where the JAX package compiles
it into one XLA program.

Backends: ``mock``, ``mlp``, ``gbdt``, ``mlp+gbdt``, ``multitask``, their
int8 variants ``mlp_int8``, ``gbdt_int8``, ``mlp+gbdt_int8`` and
``multitask_int8`` (``ops/quantize.py``), and ``routed``: all four experts
as a routed mixture (``parallel/ep.py``), over the mesh's ``expert`` axis
when it holds one shard per expert, else the unsharded dense reference.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from igaming_platform_tpu_torch.core.config import ScoringConfig
from igaming_platform_tpu_torch.core.device import resolve_device
from igaming_platform_tpu_torch.core.enums import ACTION_APPROVE, ACTION_BLOCK, ACTION_REVIEW
from igaming_platform_tpu_torch.core.features import normalize, standardize_for_model
from igaming_platform_tpu_torch.models import gbdt as gbdt_mod
from igaming_platform_tpu_torch.models import mlp as mlp_mod
from igaming_platform_tpu_torch.models.mock_model import mock_predict
from igaming_platform_tpu_torch.models.multitask import fraud_predict
from igaming_platform_tpu_torch.models.rules import apply_rules
from igaming_platform_tpu_torch.ops.quantize import gbdt_predict_int8, mlp_predict_int8

BACKENDS = ("mock", "mlp", "gbdt", "mlp+gbdt", "multitask",
            "mlp_int8", "gbdt_int8", "mlp+gbdt_int8", "multitask_int8", "routed")

# Bit index of ML_HIGH_RISK in the reason mask (REASON_BIT_ORDER[8]).
ML_HIGH_RISK_BIT = 8

# Guards against float32 sitting an ulp below the float64 value Go computes
# before its int() truncation.
_TRUNC_EPS = 1e-4


def combine(
    rule_score: torch.Tensor,
    ml_score: torch.Tensor,
    reason_mask: torch.Tensor,
    cfg: ScoringConfig,
    thresholds: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ensemble + action decision (engine.go:285-310).

    ``thresholds`` is an optional [2] int32 tensor (block, review): the
    runtime-tunable thresholds enter as data, so changing them rebuilds
    nothing. Without it the config's values apply.

    The float32 association is the JAX package's:
    ``((rule_weight*rule) + ((ml_weight*ml)*100)) + _TRUNC_EPS``, then floor.

    Returns (final_score [B] i32, action [B] i32, reason_mask [B] i32).
    """
    final = torch.floor(
        cfg.rule_weight * rule_score.to(torch.float32)
        + cfg.ml_weight * ml_score * 100.0
        + _TRUNC_EPS
    ).to(torch.int32)
    final = torch.clamp_max(final, 100)

    # ML_HIGH_RISK appended when ml > 0.7 (engine.go:285-287).
    reason_mask = reason_mask | torch.where(ml_score > 0.7, 1 << ML_HIGH_RISK_BIT, 0).to(torch.int32)

    if thresholds is None:
        block, review = cfg.block_threshold, cfg.review_threshold
    else:
        block, review = thresholds[0], thresholds[1]

    action = torch.where(
        final >= block,
        ACTION_BLOCK,
        torch.where(final >= review, ACTION_REVIEW, ACTION_APPROVE),
    ).to(torch.int32)
    return final, action, reason_mask


def routed_experts() -> tuple[list, tuple[str, ...]]:
    """The expert set of ``ml_backend="routed"``: each fn maps (params_i,
    RAW [B, 30]) -> [B] probability and normalizes for itself (the mock in
    ref-compat mode, the trained experts through the production
    pipeline)."""

    def prep(x):
        return standardize_for_model(normalize(x))

    fns = [
        lambda p, x: mock_predict(normalize(x, ref_compat=True)),
        lambda p, x: mlp_mod.mlp_predict(p, prep(x)),
        lambda p, x: gbdt_mod.gbdt_predict(p, prep(x)),
        lambda p, x: fraud_predict(p, prep(x)),
    ]
    return fns, ("mock", "mlp", "gbdt", "multitask")


ROUTED_PARAM_KEYS = ("router", "mlp", "gbdt", "multitask")


class SoftForest(torch.nn.Module):
    """A forest to train through its soft-split relaxation: ``feat`` frozen
    (a buffer), ``thr``, ``leaves`` and ``bias`` float32 parameters."""

    def __init__(self, params: dict):
        super().__init__()
        self.register_buffer("feat", torch.as_tensor(params["feat"], dtype=torch.int32).clone())
        for k in ("thr", "leaves", "bias"):
            setattr(self, k, torch.nn.Parameter(
                torch.as_tensor(params[k], dtype=torch.float32).clone().contiguous()))

    def params(self) -> dict:
        return {"feat": self.feat, "thr": self.thr, "leaves": self.leaves, "bias": self.bias}

    def serving(self) -> dict:
        """The hard forest's params (the forest kernel's), detached."""
        return {k: v.detach().clone().contiguous() for k, v in self.params().items()}


class TrainRouted(torch.nn.Module):
    """The routed bundle to train (``train/routed.py``): the router [30, E]
    as a float32 parameter, ``TrainMLP``, a ``SoftForest`` and
    ``TrainMultiTask``; the mock expert has no params. ``serving()`` gives
    the bundle ``ml_backend="routed"`` serves."""

    def __init__(self, router: torch.Tensor, mlp, forest: SoftForest, multitask):
        super().__init__()
        self.router = torch.nn.Parameter(torch.as_tensor(router, dtype=torch.float32).clone())
        self.mlp, self.forest, self.multitask = mlp, forest, multitask

    def serving(self) -> dict:
        return {"router": self.router.detach().clone(), "mock": None,
                "mlp": self.mlp.serving(), "gbdt": self.forest.serving(),
                "multitask": self.multitask.serving()}


def init_routed_train_params(seed: int = 0, *, mlp_hidden=(128, 128), n_trees: int = 64,
                             depth: int = 4, trunk=(256, 256)) -> TrainRouted:
    """A fresh trainable routed bundle on the CPU, drawn from
    ``torch.Generator().manual_seed(seed)`` with the JAX
    ``init_routed_params`` distributions (router of scale 0.01, the MLP,
    forest and multitask inits): not the numbers of a JAX key."""
    from igaming_platform_tpu_torch.core.features import NUM_FEATURES
    from igaming_platform_tpu_torch.models.multitask import init_multitask
    from igaming_platform_tpu_torch.parallel.ep import init_router

    gen = torch.Generator().manual_seed(seed)
    router = init_router(gen, NUM_FEATURES, len(routed_experts()[0]), scale=0.01)
    mlp = mlp_mod.init_mlp(gen, hidden=mlp_hidden)
    forest = SoftForest(gbdt_mod.init_gbdt(gen, n_trees=n_trees, depth=depth))
    return TrainRouted(router, mlp, forest, init_multitask(gen, trunk=trunk))


def init_routed_params(seed: int = 0, *, mlp_hidden=(128, 128), n_trees: int = 64,
                       depth: int = 4, trunk=(256, 256)) -> dict:
    """A fresh serving bundle for ``ml_backend="routed"`` on the CPU: the
    serving assembly of ``init_routed_train_params``'s draws."""
    return init_routed_train_params(seed, mlp_hidden=mlp_hidden, n_trees=n_trees, depth=depth,
                                    trunk=trunk).serving()


def routed_splits_rows(mesh) -> bool:
    """Whether ``routed_ml`` runs expert-parallel over ``mesh`` (an expert
    axis of one shard per expert), splitting the rows itself."""
    from igaming_platform_tpu_torch.parallel.mesh import AXIS_EXPERT

    return mesh is not None and int(mesh.shape.get(AXIS_EXPERT, 1)) == len(routed_experts()[0])


def routed_ml(params: Any, x_raw: torch.Tensor, mesh=None) -> torch.Tensor:
    """The routed mixture's probability for raw rows: over ``mesh``'s expert
    axis (rows split over every populated row axis, capacity sized to the
    worst case so no row loses its score to a drop) when it holds one shard
    per expert, else ``dense_reference`` (``make_score_fn`` refuses an
    expert axis of another size)."""
    from igaming_platform_tpu_torch.parallel.ep import dense_reference, routed_ensemble_forward
    from igaming_platform_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_EXPERT

    fns, keys = routed_experts()
    eparams = tuple(params.get(k) for k in keys)
    if routed_splits_rows(mesh):
        row_axes = tuple(a for a in (AXIS_DATA, AXIS_EXPERT) if int(mesh.shape.get(a, 1)) > 1)
        return routed_ensemble_forward(params["router"], eparams, x_raw, mesh=mesh,
                                       expert_fns=fns, k=2, capacity_factor=float(len(fns)),
                                       shard_rows_over=row_axes)["prob"]
    return dense_reference(params["router"], eparams, x_raw, expert_fns=fns, k=2)


def check_routed_mesh(mesh) -> None:
    """A populated expert axis that cannot hold the expert set is a config
    error: silently running dense would leave the operator believing
    expert parallelism is on."""
    from igaming_platform_tpu_torch.parallel.mesh import AXIS_EXPERT

    n = len(routed_experts()[0])
    expert_size = int(mesh.shape.get(AXIS_EXPERT, 1)) if mesh is not None else 1
    if expert_size > 1 and expert_size != n:
        raise ValueError(f"mesh expert axis is {expert_size} but the routed ensemble has "
                         f"{n} experts (set MESH_EXPERT={n})")


def make_score_fn(
    cfg: ScoringConfig,
    ml_backend: str = "mock",
    device: str | torch.device = "cuda",
    mesh=None,
) -> Callable[..., dict[str, torch.Tensor]]:
    """Build the scoring step for an ML backend, on ``device``.

    Backends:
      - "mock": reference-parity deterministic scorer (no params)
      - "mlp": fraud MLP (``params["mlp"]``, an ``MLP``)
      - "gbdt": oblivious forest (``params["gbdt"]``, a dict of tensors)
      - "mlp+gbdt": mean of the MLP and GBDT probabilities
      - "multitask": fraud head of the multi-task net (``params["multitask"]``)
      - "mlp_int8", "gbdt_int8", "mlp+gbdt_int8", "multitask_int8": the same
        with int8 params (``ops/quantize.py``; the multitask variant is its
        fraud path as an int8 MLP)
      - "routed": the four experts as a routed mixture (``routed_ml``);
        params carry ``ROUTED_PARAM_KEYS``; ``mesh`` gives its expert axis

    The returned fn has signature ``f(params, x_raw, blacklisted,
    thresholds=None)``: ``x_raw`` a [B, 30] float32 raw batch, ``blacklisted``
    [B] bool, both numpy arrays or tensors; params must already sit on
    ``device`` (``convert.params_to``). It returns a dict of [B] tensors on
    ``device``: score, action, rule_score, ml_score, reason_mask.

    The mock backend normalizes in ref-compat mode (identity log1p), the
    data its thresholds were written against; the trained backends use the
    real log1p plus the model-side squash.
    """
    if ml_backend not in BACKENDS:
        raise ValueError(f"unknown ml backend: {ml_backend}")
    if ml_backend == "routed":
        check_routed_mesh(mesh)
    dev = resolve_device(device)
    ref_compat = ml_backend == "mock"

    def score_fn(
        params: Any,
        x_raw,
        blacklisted,
        thresholds: torch.Tensor | None = None,
    ) -> dict[str, torch.Tensor]:
        x_raw = torch.as_tensor(x_raw, dtype=torch.float32, device=dev)
        blacklisted = torch.as_tensor(blacklisted, dtype=torch.bool, device=dev)
        if thresholds is not None:
            thresholds = torch.as_tensor(thresholds, dtype=torch.int32, device=dev)
        xn = normalize(x_raw, ref_compat=ref_compat)
        if not ref_compat:
            xn = standardize_for_model(xn)

        if ml_backend == "mock":
            ml = mock_predict(xn)
        elif ml_backend == "mlp":
            ml = mlp_mod.mlp_predict(params["mlp"], xn)
        elif ml_backend == "gbdt":
            ml = gbdt_mod.gbdt_predict(params["gbdt"], xn)
        elif ml_backend == "mlp_int8":
            ml = mlp_predict_int8(params["mlp_int8"], xn)
        elif ml_backend == "gbdt_int8":
            ml = gbdt_predict_int8(params["gbdt_int8"], xn)
        elif ml_backend == "mlp+gbdt":
            ml = 0.5 * (mlp_mod.mlp_predict(params["mlp"], xn)
                        + gbdt_mod.gbdt_predict(params["gbdt"], xn))
        elif ml_backend == "mlp+gbdt_int8":
            ml = 0.5 * (mlp_predict_int8(params["mlp_int8"], xn)
                        + gbdt_predict_int8(params["gbdt_int8"], xn))
        elif ml_backend == "multitask":
            ml = fraud_predict(params["multitask"], xn)
        elif ml_backend == "routed":
            ml = routed_ml(params, x_raw, mesh)
        else:
            ml = mlp_predict_int8(params["multitask_int8"], xn)

        rule_score, mask = apply_rules(x_raw, blacklisted, cfg)
        final, action, mask = combine(rule_score, ml, mask, cfg, thresholds)
        return {
            "score": final,
            "action": action,
            "rule_score": rule_score,
            "ml_score": ml,
            "reason_mask": mask,
        }

    return score_fn
