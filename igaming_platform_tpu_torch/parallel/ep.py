"""Expert parallelism: routed sub-batches and an all-to-all combine.

Counterpart of ``igaming_platform_tpu/parallel/ep.py``. The fraud
ensemble's scorers (mock heuristic, MLP, GBDT, multitask net) are the
experts; a linear router gates each row to its top-k experts; rows go
to capacity-bounded per-expert sub-batches over the ``expert`` axis with
one all-to-all each way (the GShard/Switch dispatch layout); each expert
shard runs only its own expert, and the results come back and combine as
a gate-weighted sum per row. A pick past an expert's capacity is dropped,
and the row's weights renormalise over its surviving picks; with enough
capacity nothing drops and the routed forward equals ``dense_reference``.

Ties: ``jax.lax.top_k`` puts the lower index first among equal gates, and
dispatch positions (so capacity drops) follow that order. ``torch.topk``
promises no order among ties, and its order differs between the CPU and a
card, so ``top_k`` here is a stable descending sort: equal gates keep
index order, on every device. The router's product runs ``dense_f32``
(``ops/dense.py``): one sum order on the card and the CPU, whatever the
batch, so a row's picks do not depend on the shard it lands in.

The dispatch writes each kept row into its slot of the [E, C, F] buffer
(the JAX one-hot einsum, which adds only zeros besides that row), and the
combine adds a row's weighted picks in priority order.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Sequence

import torch

from igaming_platform_tpu_torch.parallel import collectives as coll
from igaming_platform_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_EXPERT, Mesh


def init_router(gen: torch.Generator, in_dim: int, n_experts: int,
                scale: float = 0.1) -> torch.Tensor:
    """Linear gate weights [in_dim, n_experts], normal times ``scale``."""
    return torch.randn((in_dim, n_experts), generator=gen, dtype=torch.float32) * scale


def gate_probs(router_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Softmax router over experts: [B, F] -> [B, E]. Raw features reach
    the router, so its logits run to thousands and most gates underflow:
    XLA flushes a subnormal result to zero (on the CPU and the TPU), torch
    keeps it, so the gates are flushed here too. A gate that underflowed
    then ties at zero, and the lower index takes the pick, as in JAX.
    Differentiable in ``router_w`` (``dense_f32_train``): a flushed gate
    passes no gradient."""
    from igaming_platform_tpu_torch.ops.dense import dense_f32_train

    x = torch.as_tensor(x, dtype=torch.float32).contiguous()
    zero = torch.zeros(router_w.shape[1], dtype=torch.float32, device=x.device)
    g = torch.softmax(dense_f32_train(x, router_w, zero), dim=-1)
    return torch.where(g < torch.finfo(torch.float32).tiny, torch.zeros_like(g), g)


def top_k(gates: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values [B, k], indices [B, k]) in descending order, equal gates in
    index order (``jax.lax.top_k``'s order), on any device."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _dispatch_masks(gates: torch.Tensor, k: int, capacity: int):
    """GShard dispatch in the priority order: every row's first choice
    before any row's second. Returns (expert [b, k], position [b, k],
    kept [b, k] bool, weights [b, k]): the expert of each pick, its slot in
    that expert's buffer (earlier picks of that expert in the flattened
    (k, b) order), whether it fits in ``capacity``, and its gate
    renormalised over the row's kept picks."""
    b, e = gates.shape
    top_vals, top_idx = top_k(gates, k)
    flat_idx = top_idx.t().reshape(-1)  # [k*b], priority-major
    onehot = torch.nn.functional.one_hot(flat_idx, e).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=0) - 1).mul_(onehot).sum(dim=-1)  # [k*b]
    pos_kb = pos.reshape(k, b).t()
    kept = pos_kb < capacity
    surviving = torch.where(kept, top_vals, torch.zeros_like(top_vals))
    denom = torch.clamp_min(surviving.sum(dim=-1, keepdim=True), 1e-9)
    return top_idx, pos_kb, kept, surviving / denom


def dispatch_tensors(gates: torch.Tensor, k: int, capacity: int):
    """The JAX function's outputs: (dispatch [b, E, C] one-hot, combine
    [b, E, C] gate-weighted, kept [b, k]) in float32, for tests."""
    b, e = gates.shape
    top_idx, pos, kept, weights = _dispatch_masks(gates, k, capacity)
    disp = torch.zeros((b, e, capacity), dtype=torch.float32, device=gates.device)
    comb = torch.zeros_like(disp)
    rows = torch.arange(b, device=gates.device)
    for j in range(k):
        m = kept[:, j]
        r, ex, p = rows[m], top_idx[m, j], pos[m, j]
        disp[r, ex, p] += 1.0
        comb[r, ex, p] += weights[m, j]
    return disp, comb, kept


def routed_ensemble_forward(
    router_w: torch.Tensor,
    expert_params: Sequence[Any],
    x: torch.Tensor,
    *,
    mesh: Mesh,
    expert_fns: Sequence[Callable[[Any, torch.Tensor], torch.Tensor]],
    k: int = 2,
    capacity_factor: float = 1.5,
    shard_rows_over: tuple[str, ...] = (AXIS_EXPERT,),
) -> dict[str, torch.Tensor]:
    """Routed scoring: [B, F] -> per-row probability, over ``mesh``.

    ``expert_fns[i](expert_params[i], rows) -> [rows]`` runs on expert shard
    i; there must be one per ``expert`` coordinate, and B must divide by the
    product of the ``shard_rows_over`` axes, which split the rows (row block
    ``d * E + e`` on shard (d, e) for ``(data, expert)``; the all-to-all runs
    within each data group). Returns {"prob": [B], "load": [E] rows sent to
    each expert, "dropped": picks past capacity}, on ``x``'s device."""
    n_experts = int(mesh.shape[AXIS_EXPERT])
    if len(expert_fns) != n_experts:
        raise ValueError(f"{len(expert_fns)} expert fns for expert axis of {n_experts}")
    split = {ax: int(mesh.shape[ax]) for ax in shard_rows_over}
    row_split = math.prod(split.values())
    x = torch.as_tensor(x, dtype=torch.float32)
    b_total, feat_dim = x.shape
    if b_total % row_split:
        raise ValueError(f"batch {b_total} must divide by the row-sharding product "
                         f"({row_split}); pad the batch (serving tiers already do)")
    b_local = b_total // row_split
    capacity = int(math.ceil(capacity_factor * k * b_local / n_experts))
    n_data = split.get(AXIS_DATA, 1)
    # Without ``expert`` among the row axes every expert shard of a data
    # group holds the group's rows and routes them alike (as the JAX
    # program's replicated shards do); shard 0's combine answers.
    rows_over_expert = AXIS_EXPERT in split
    home = x.device
    probs, loads, dropped = [], [], []
    for d in range(n_data):
        dd = d if AXIS_DATA in split else 0
        devs = [mesh.devices[dd, 0, 0, e] for e in range(n_experts)]
        blocks = []
        for e in range(n_experts):
            blk = d * (n_experts if rows_over_expert else 1) + (e if rows_over_expert else 0)
            blocks.append(x[blk * b_local:(blk + 1) * b_local].to(devs[e]))
        dispatched, plans = [], []
        for xl, dev in zip(blocks, devs):
            gates = gate_probs(coll.on_device(router_w, dev), xl)
            top_idx, pos, kept, weights = _dispatch_masks(gates, k, capacity)
            # Slot ``capacity`` takes the dropped picks and is cut off: a
            # kept pick owns its (expert, slot) alone.
            buf = torch.zeros((n_experts, capacity + 1, feat_dim), dtype=torch.float32,
                              device=dev)
            for j in range(k):
                m = kept[:, j]
                buf[torch.where(m, top_idx[:, j], torch.zeros_like(top_idx[:, j])),
                    torch.where(m, pos[:, j], torch.full_like(pos[:, j], capacity))] = xl
            dispatched.append(buf[:, :capacity].contiguous())
            plans.append((top_idx, pos, kept, weights))
            # Masked by arithmetic: a boolean selection would wait for the
            # stream to learn its size.
            loads.append((torch.nn.functional.one_hot(top_idx, n_experts)
                          * kept.unsqueeze(-1)).sum(dim=(0, 1)).to(torch.float32).to(home))
            dropped.append((~kept).sum().to(home))
        received = coll.all_to_all(dispatched, split_axis=0, concat_axis=0, devices=devs)
        # Each expert's params on its own shard's device (a copy kept after
        # the first call when that is another card; none on a logical mesh).
        outs = [fn(coll.on_device(p, dev), r.reshape(n_experts * capacity, feat_dim))
                .to(torch.float32)
                for fn, p, r, dev in zip(expert_fns, expert_params, received, devs)]
        returned = coll.all_to_all([o.reshape(n_experts, capacity) for o in outs],
                                   split_axis=0, concat_axis=0, devices=devs)
        for e, ((top_idx, pos, kept, weights), ret) in enumerate(zip(plans, returned)):
            if e and not rows_over_expert:
                break
            prob = torch.zeros(top_idx.shape[0], dtype=torch.float32, device=ret.device)
            for j in range(k):
                got = ret[top_idx[:, j], torch.where(kept[:, j], pos[:, j],
                                                     torch.zeros_like(pos[:, j]))]
                prob = prob + torch.where(kept[:, j], weights[:, j] * got,
                                          torch.zeros_like(got))
            probs.append(prob.to(home))
    return {"prob": torch.cat(probs), "load": coll.psum(loads, devices=[home])[0],
            "dropped": coll.psum(dropped, devices=[home])[0]}


def topk_mix(gates: torch.Tensor, expert_outs: torch.Tensor, k: int):
    """Per-row renormalised top-k gate-weighted mix: (mix [B], top_idx [B, k])."""
    top_vals, top_idx = top_k(gates, k)
    weights = top_vals / torch.clamp_min(top_vals.sum(dim=-1, keepdim=True), 1e-9)
    picked = torch.gather(expert_outs, -1, top_idx)
    mix = picked[:, 0] * weights[:, 0]
    for j in range(1, k):
        mix = mix + picked[:, j] * weights[:, j]
    return mix, top_idx


def dense_reference(router_w: torch.Tensor, expert_params: Sequence[Any], x: torch.Tensor, *,
                    expert_fns: Sequence[Callable], k: int = 2) -> torch.Tensor:
    """Unrouted reference: every expert scores every row; per-row top-k
    gate-weighted mix. Equals the routed forward when capacity drops
    nothing."""
    x = torch.as_tensor(x, dtype=torch.float32)
    gates = gate_probs(router_w, x)
    all_out = torch.stack([fn(p, x).to(torch.float32)
                           for fn, p in zip(expert_fns, expert_params)], dim=-1)
    return topk_mix(gates, all_out, k)[0]
