"""Continuous training loop: train, checkpoint, hot-swap into serving.

Counterpart of ``igaming_platform_tpu/train/loop.py``: a background
trainer checkpoints (``train/checkpoint.py``) and swaps fresh params into a
live engine (``TorchScoringEngine.swap_params`` with ``{"multitask": ...}``),
in place of an offline train, export and redeploy cycle. On start it
resumes from the newest checkpoint in its directory.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass

from igaming_platform_tpu_torch.train.checkpoint import restore_trainer, save_checkpoint
from igaming_platform_tpu_torch.train.data import make_stream
from igaming_platform_tpu_torch.train.trainer import TrainConfig, Trainer

logger = logging.getLogger(__name__)


@dataclass
class LoopConfig:
    checkpoint_dir: str = "checkpoints"
    checkpoint_every: int = 500  # steps
    swap_every: int = 100  # steps
    max_steps: int | None = None


class TrainingLoop:
    """Background trainer with checkpointing and live param swaps."""

    def __init__(self, trainer: Trainer | None = None, *, engine=None,
                 config: LoopConfig | None = None, train_config: TrainConfig | None = None,
                 device: str = "cuda"):
        """``engine``: a ``TorchScoringEngine`` with ``ml_backend="multitask"``,
        or None. ``device`` places a trainer made here."""
        self.trainer = trainer or Trainer(train_config, device=device)
        self.engine = engine
        self.config = config or LoopConfig()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.last_metrics: dict[str, float] = {}
        self.swaps = 0
        self.checkpoints = 0

        if restore_trainer(self.trainer, self.config.checkpoint_dir):
            logger.info("resumed from checkpoint at step %d", self.trainer.state.step)

    def run_steps(self, steps: int) -> dict[str, float]:
        """The loop body, in the caller's thread: the next batch's copy
        overlaps the current step, and metrics are read back every ten
        steps and at swap and checkpoint boundaries."""
        if steps <= 0:
            return self.last_metrics
        trainer = self.trainer
        data = make_stream(trainer.cfg.batch_size, seed=trainer.cfg.seed + trainer.state.step)
        pending = trainer.put_batch(next(data), side=True)
        metrics_dev = None
        materialized = True
        for i in range(steps):
            if self._stop.is_set():
                break
            current = pending
            if i + 1 < steps:
                pending = trainer.put_batch(next(data), side=True)
            metrics_dev = trainer.train_step_device(current)
            materialized = False
            step = trainer.state.step
            at_swap = self.config.swap_every and step % self.config.swap_every == 0
            at_ckpt = self.config.checkpoint_every and step % self.config.checkpoint_every == 0
            if at_swap or at_ckpt or i + 1 >= steps or i % 10 == 0:
                self.last_metrics = trainer.materialize_metrics(metrics_dev)
                materialized = True
            if at_swap:
                self._swap()
            if at_ckpt:
                save_checkpoint(self.config.checkpoint_dir, trainer.state)
                self.checkpoints += 1
        if metrics_dev is not None and not materialized:
            # A stop() mid-stride leaves the last step's metrics unread.
            self.last_metrics = trainer.materialize_metrics(metrics_dev)
        return self.last_metrics

    def _swap(self) -> None:
        if self.engine is not None:
            self.engine.swap_params({"multitask": self.trainer.export_params()})
            self.swaps += 1

    def start(self) -> "TrainingLoop":
        def body():
            self.run_steps(self.config.max_steps or (1 << 62))

        self._thread = threading.Thread(target=body, name="training-loop", daemon=True)
        self._thread.start()
        return self

    def stop(self, save: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        if save:
            save_checkpoint(self.config.checkpoint_dir, self.trainer.state)
            self.checkpoints += 1
