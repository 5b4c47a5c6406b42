"""The yardstick's arithmetic: the card's peaks and the work of each kernel.

Frozen here so that no change to the program moves a denominator. The
formulas follow the pattern of the port's ``obs/perfmodel.py`` (its
``dense_work`` and ``attention_work``), copied, not imported. Every input byte is counted once and every output byte once,
whatever a kernel reads again.

One ops bound serves every kernel: the card's dense bf16 tensor-core rate,
so a share reads the same work whatever precision path implements it.
"""

from __future__ import annotations

# NVIDIA H100 SXM (80GB HBM3) data sheet: dense bf16 989 TFLOP/s without
# sparsity, HBM3 3.35 TB/s, both at the full 700 W power limit.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def dense_work(rows: int, k: int, n: int) -> tuple[float, float]:
    """(operations, bytes) of one dense layer ``x @ w + b``: 2*B*K*N; x, w,
    the bias and the output once each, four bytes an element."""
    return 2.0 * rows * k * n, 4.0 * (rows * k + k * n + n + rows * n)


def attention_work(bh: int, s: int, dh: int) -> tuple[float, float]:
    """(operations, bytes) of one attention forward: 4*BH*S^2*Dh; q, k, v
    read and O and the row logsumexp written, once each."""
    return 4.0 * bh * s * s * dh, float(4 * bh * s * dh * 4 + bh * s * 4)


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def roofline_percent(bound_s: float, kernel_s: float) -> float | None:
    """The share of its roofline that the measured kernel time reaches, in
    percent; None when nothing was measured."""
    if kernel_s <= 0.0 or bound_s <= 0.0:
        return None
    return 100.0 * bound_s / kernel_s


# --- the sequence model (models/sequence.py's SequenceModel) -------------------

def sequence_dense_shapes(cfg: dict, batch: int, seq_len: int) -> list[tuple[int, int, int]]:
    """The (rows, K, N) of every forward dense layer of one call, in order:
    the embedding, each layer's qkv, output, and feed-forward pair, the
    head."""
    d, ff, n = cfg["d_model"], cfg["d_ff"], batch * seq_len
    shapes = [(n, cfg["in_dim"], d)]
    for _ in range(cfg["n_layers"]):
        shapes += [(n, d, 3 * d), (n, d, d), (n, d, ff), (n, ff, d)]
    shapes.append((batch, d, 1))
    return shapes


def sequence_attention_shape(cfg: dict, batch: int, seq_len: int) -> tuple[int, int, int]:
    """(BH, S, Dh) of one layer's attention."""
    h = cfg["n_heads"]
    return batch * h, seq_len, cfg["d_model"] // h


def sequence_score_flops(cfg: dict, batch: int, seq_len: int) -> float:
    """Model operations of one forward: its dense and attention products."""
    dense = sum(dense_work(*s)[0] for s in sequence_dense_shapes(cfg, batch, seq_len))
    att = sequence_attention_shape(cfg, batch, seq_len)
    return dense + cfg["n_layers"] * attention_work(*att)[0]
