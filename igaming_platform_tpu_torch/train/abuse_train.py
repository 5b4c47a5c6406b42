"""Train the bonus-abuse sequence detector on synthetic behaviour patterns.

Counterpart of ``igaming_platform_tpu/train/abuse_train.py``. Until
production labels exist, training data is synthesised from behaviourally
distinct generators (a numpy copy of the JAX package's: one seed gives the
same batches bit for bit):

- normal play: deposits followed by varied bets/wins at human cadence,
  mixed game weights;
- abuse patterns: bonus_grant -> minimal low-weight wagering -> immediate
  withdrawal cycles; rapid uniform min-bets to clear wagering; deposit ->
  instant withdraw churn.

``train_abuse_detector`` runs Adam on the mean sigmoid cross-entropy of the
``SequenceModel``'s logit, as the JAX trainer runs ``optax.adam`` on
``optax.sigmoid_binary_cross_entropy``. On a card every step launches, per
layer, the flash-attention forward kernel and the two backward kernels (dQ,
dK/dV) through ``ops/flash_attention.FlashAttention``. The loss stays on the
device and is read once, at the end, as the JAX jit loop reads it.

Not ported yet: the mesh (data-parallel batch) and the sequence-sharded
``seq_mode``s, ring and Ulysses.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from igaming_platform_tpu_torch.core.device import resolve_device
from igaming_platform_tpu_torch.models.sequence import (
    EVENT_DIM,
    TX_TYPE_INDEX,
    SeqConfig,
    SequenceModel,
    init_sequence_model,
)


@dataclass(frozen=True)
class AbuseTrainConfig:
    steps: int = 200
    batch_size: int = 64
    seq_len: int = 64
    learning_rate: float = 1e-3
    # The detector's serving width: 2 heads of 32.
    model: SeqConfig = SeqConfig(d_model=64, n_heads=2, n_layers=2, d_ff=128)
    seed: int = 0


def _event(amount, dt, tx_type, game_weight=1.0, balance_ratio=0.5):
    e = np.zeros(EVENT_DIM, dtype=np.float32)
    e[0] = np.log1p(max(amount, 0.0))
    e[1] = np.log1p(max(dt, 0.0))
    e[2 + TX_TYPE_INDEX.get(tx_type, 7)] = 1.0
    e[10] = game_weight
    e[11] = balance_ratio
    return e


def _normal_sequence(rng: np.random.Generator, seq_len: int) -> np.ndarray:
    events = []
    for _ in range(seq_len):
        r = rng.random()
        if r < 0.1:
            events.append(_event(rng.gamma(2, 5000), rng.gamma(2, 3600), "deposit"))
        elif r < 0.75:
            events.append(_event(rng.gamma(2, 800), rng.gamma(2, 60),
                                 "bet", game_weight=rng.choice([1.0, 0.5, 0.2])))
        elif r < 0.95:
            events.append(_event(rng.gamma(2, 1200), rng.gamma(2, 30), "win"))
        else:
            events.append(_event(rng.gamma(2, 8000), rng.gamma(2, 86400), "withdraw"))
    return np.stack(events)


def _abuse_sequence(rng: np.random.Generator, seq_len: int) -> np.ndarray:
    pattern = rng.integers(0, 3)
    events = []
    if pattern == 0:
        # bonus -> minimal grinding at low weights -> withdraw, repeated
        while len(events) < seq_len:
            events.append(_event(2000, 60, "bonus_grant"))
            for _ in range(min(6, seq_len - len(events))):
                events.append(_event(100, rng.gamma(2, 5), "bonus_wager", game_weight=0.1))
            if len(events) < seq_len:
                events.append(_event(2000, 30, "withdraw", balance_ratio=0.95))
    elif pattern == 1:
        # metronomic min-bets to clear wagering
        for _ in range(seq_len):
            events.append(_event(100, 2.0, "bet", game_weight=1.0, balance_ratio=0.9))
    else:
        # deposit -> instant withdraw churn
        while len(events) < seq_len:
            events.append(_event(5000, rng.gamma(2, 20), "deposit"))
            if len(events) < seq_len:
                events.append(_event(4900, rng.gamma(2, 60), "withdraw", balance_ratio=0.98))
    return np.stack(events[:seq_len])


def make_abuse_batch(rng: np.random.Generator, batch: int, seq_len: int):
    x = np.zeros((batch, seq_len, EVENT_DIM), dtype=np.float32)
    y = np.zeros((batch,), dtype=np.float32)
    for i in range(batch):
        if rng.random() < 0.5:
            x[i] = _abuse_sequence(rng, seq_len)
            y[i] = 1.0
        else:
            x[i] = _normal_sequence(rng, seq_len)
    return x, y


def make_optimizer(model: SequenceModel, learning_rate: float) -> torch.optim.Adam:
    """Adam with ``optax.adam``'s defaults: the same update,
    lr * m_hat / (sqrt(v_hat) + eps)."""
    return torch.optim.Adam(model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def train_step(model: SequenceModel, opt: torch.optim.Optimizer, x, y) -> torch.Tensor:
    """One optimizer step on a batch (numpy or tensors); returns the batch's
    loss before the step as a tensor on the model's device, unread. The
    gradients stay in ``.grad`` until the next step."""
    dev = model.head.w.device
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    opt.zero_grad(set_to_none=True)
    loss = F.binary_cross_entropy_with_logits(model(x)["abuse_logit"], y)
    loss.backward()
    opt.step()
    return loss.detach()


def train_abuse_detector(cfg: AbuseTrainConfig = AbuseTrainConfig(), mesh=None,
                         seq_mode: str = "dense", device: str | torch.device = "cuda"):
    """Returns (model, metrics): the trained ``SequenceModel`` on ``device``
    and {"final_loss", "eval_accuracy", "losses"}, ``losses`` being every
    step's loss. Runs on the card unless ``device="cpu"``."""
    if mesh is not None or seq_mode in ("ring", "ulysses"):
        raise NotImplementedError(
            "training over a mesh (data or sequence sharding) is not ported yet")
    if seq_mode != "dense":
        raise ValueError(f"unknown seq_mode: {seq_mode}")
    if cfg.steps < 1:
        raise ValueError(f"steps must be at least 1, got {cfg.steps}")
    dev = resolve_device(device)
    model = init_sequence_model(cfg.model, seed=cfg.seed).to(dev)
    opt = make_optimizer(model, cfg.learning_rate)

    rng = np.random.default_rng(cfg.seed)
    losses = []
    for _ in range(cfg.steps):
        x, y = make_abuse_batch(rng, cfg.batch_size, cfg.seq_len)
        losses.append(train_step(model, opt, x, y))

    # Held-out accuracy.
    x_eval, y_eval = make_abuse_batch(np.random.default_rng(cfg.seed + 1), 256, cfg.seq_len)
    with torch.inference_mode():
        pred = model(torch.from_numpy(x_eval).to(dev))["abuse"].cpu().numpy()
    acc = float(np.mean((pred >= 0.5) == (y_eval >= 0.5)))
    losses = torch.stack(losses).cpu().tolist()
    return model, {"final_loss": losses[-1], "eval_accuracy": acc, "losses": losses}
