"""The sequence model's initial weights, made by the benchmark from the seed.

One ``torch.Generator`` on the run's device draws every weight in one call,
in float32, the type they are served in; the leaves are views into that draw,
scaled as the port's ``init_sequence_model`` scales them (He-normal
feed-forward and embedding, 1/sqrt(d) for qkv, the output and the head;
biases zero, layer norms one and zero). Both the program and the plain
reference start from these numbers.
"""

from __future__ import annotations

import math

import torch


def leaf_specs(cfg: dict) -> list[tuple[str, tuple[int, ...], str, float]]:
    """(name, shape, kind, scale) of every leaf, in one fixed order; kind is
    "normal", "ones" or "zeros"."""
    d, ff = cfg["d_model"], cfg["d_ff"]

    def dense(name, k, n, scale):
        return [(f"{name}.w", (k, n), "normal", scale), (f"{name}.b", (n,), "zeros", 0.0)]

    def norm(name):
        return [(f"{name}.scale", (d,), "ones", 0.0), (f"{name}.bias", (d,), "zeros", 0.0)]

    specs = dense("embed", cfg["in_dim"], d, math.sqrt(2.0 / cfg["in_dim"]))
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}"
        specs += norm(f"{p}.ln1") + dense(f"{p}.wqkv", d, 3 * d, math.sqrt(1.0 / d))
        specs += dense(f"{p}.wo", d, d, math.sqrt(1.0 / d)) + norm(f"{p}.ln2")
        specs += dense(f"{p}.w1", d, ff, math.sqrt(2.0 / d))
        specs += dense(f"{p}.w2", ff, d, math.sqrt(2.0 / ff))
    return specs + norm("ln_f") + dense("head", d, 1, math.sqrt(1.0 / d))


def make_params(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """{leaf name: float32 tensor on ``device``}, drawn from ``seed``."""
    specs = leaf_specs(cfg)
    total = sum(math.prod(shape) for _, shape, kind, _ in specs if kind == "normal")
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(total, generator=gen, dtype=torch.float32, device=device)
    out, at = {}, 0
    for name, shape, kind, scale in specs:
        if kind == "normal":
            n = math.prod(shape)
            out[name] = draw[at:at + n].view(shape) * scale
            at += n
        else:
            fill = torch.ones if kind == "ones" else torch.zeros
            out[name] = fill(shape, dtype=torch.float32, device=device)
    return out
