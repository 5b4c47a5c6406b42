"""Driver ``score_sequence``: the abuse detector's forward over batches of
histories, closed loop, one caller.

Set-up builds the program's ``SequenceModel`` from weights the benchmark
draws from the seed (``data/sequence_params.py``) and a pool of batches of
wagering histories on the card (``data/abuse_patterns.py``), and scores
each pool batch once, which loads every kernel. Every call of the window
is the model's forward under ``torch.inference_mode()`` on the next pool
batch, as ``benchmarks/configs.py``'s config 3 runs the forward on a batch
already on the device; each call's abuse logits are kept. The window ends
on a device synchronise: every call counted has completed inside it.

Once the window has closed and the program is freed, the plain reference
(``reference/sequence.py``) scores each pool batch, and every logit the
window produced is compared with the reference's for its batch.
"""

from __future__ import annotations

import sys
import time

import torch

from portbench import compare, devtime
from portbench.data.abuse_patterns import EVENT_DIM, fill_pool
from portbench.data.sequence_params import make_params
from portbench.reference import sequence as ref_seq


def build_model(cfg: dict, params: dict):
    """The program's ``SequenceModel`` from the benchmark's leaves (copied,
    so that the reference reads leaves the program never held)."""
    from igaming_platform_tpu_torch.models import sequence as seq

    def affine(name):
        return seq.Affine(params[f"{name}.w"].clone(), params[f"{name}.b"].clone())

    def norm(name):
        return seq.LayerNorm(params[f"{name}.scale"].clone(), params[f"{name}.bias"].clone())

    layers = [seq.Block(cfg["n_heads"], norm(f"layers.{i}.ln1"), affine(f"layers.{i}.wqkv"),
                        affine(f"layers.{i}.wo"), norm(f"layers.{i}.ln2"),
                        affine(f"layers.{i}.w1"), affine(f"layers.{i}.w2"))
              for i in range(cfg["n_layers"])]
    sc = seq.SeqConfig(d_model=cfg["d_model"], n_heads=cfg["n_heads"], n_layers=cfg["n_layers"],
                       d_ff=cfg["d_ff"], in_dim=cfg["in_dim"], max_len=cfg["max_len"])
    return seq.SequenceModel(sc, affine("embed"), layers, norm("ln_f"), affine("head"))


class Scorer:
    """The program's model of a run, its pool, and the answers of its window."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        b, s, n = traffic["batch"], traffic["seq_len"], traffic["pool_batches"]
        pool_x = torch.empty((n, b, s, EVENT_DIM), dtype=torch.float32)
        fill_pool(seed, pool_x.numpy(), torch.empty((n, b)).numpy())
        self.pool_x = pool_x.to(device)
        self.init = make_params(cfg, seed, device)
        self.model = build_model(cfg, self.init).to(device)
        self.answers: list[torch.Tensor] = []

    def call(self, i: int) -> torch.Tensor:
        """The program's forward on pool batch ``i``: its abuse logits."""
        with torch.inference_mode():
            return self.model(self.pool_x[i % self.pool_x.shape[0]])["abuse_logit"]

    def warm(self) -> None:
        for i in range(self.pool_x.shape[0]):
            self.answers.append(self.call(i))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float, traced: bool) -> dict:
        """Calls back to back for ``seconds``; returns the window's counts."""
        start, calls = len(self.answers), 0
        with devtime.Window(traced) as tw:
            t_open = time.time()
            deadline = time.perf_counter() + seconds
            while time.perf_counter() < deadline:
                self.answers.append(self.call(start + calls))
                calls += 1
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t_close = time.time()
        return {"t_open": t_open, "window_s": t_close - t_open, "calls": calls,
                "trace": tw.summary()}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_side(self, tf32: bool = False) -> torch.Tensor:
        """The plain reference's logits, [pool batches, B]."""
        return ref_seq.score(self.init, self.cfg, self.pool_x, self.traffic["reference_block"],
                             tf32=tf32)

    def program_side(self) -> torch.Tensor:
        """Every answer kept, [calls, B], call i of pool batch i mod n."""
        return torch.stack(self.answers)

    def readings(self, side: torch.Tensor | None = None,
                 ref: torch.Tensor | None = None) -> tuple[dict[str, float], torch.Tensor]:
        """The numbers compared and each answer's gap: the program's answers
        (or ``side``, [calls, B], standing in for them) against the sound
        reference's (computed here when not given)."""
        side = self.program_side() if side is None else side
        ref = self.reference_side() if ref is None else ref
        return compare.scoring_readings(side, ref)


def run(job) -> dict:
    cfg, traffic = job.config, job.traffic
    t0 = time.perf_counter()
    sc = Scorer(cfg, traffic, job.seed, job.device)
    t1 = time.perf_counter()
    sc.warm()
    print(f"setup: pool, weights and model {t1 - t0:.2f} s, warm calls "
          f"{time.perf_counter() - t1:.2f} s", file=sys.stderr, flush=True)
    win = sc.window(job.seconds, job.trace)
    peak = torch.cuda.max_memory_allocated(job.device) if job.device.type == "cuda" else 0
    sc.release()
    t0 = time.perf_counter()
    readings, gaps = sc.readings()
    ok, table = compare.judge(readings, traffic["limits"])
    # A window's answer fails when its gap is over the limit or not a number.
    failed = int((~(gaps[-win["calls"]:] <= traffic["limits"]["logit_gap"])).sum()) \
        if win["calls"] else 0
    print(f"judged {gaps.numel()} answers in {time.perf_counter() - t0:.2f} s",
          file=sys.stderr, flush=True)
    rows = win["calls"] * traffic["batch"]
    return {
        "t_open": win["t_open"],
        "attempted": rows,
        "failed": failed,
        "correct": ok,
        "compared": table,
        "memory_peak_bytes": peak,
        "end_to_end": {"events_per_s": rows * traffic["seq_len"] / win["window_s"]},
        "trace": win["trace"],
        "layer": {"steps": win["calls"], "batch": traffic["batch"],
                  "seq_len": traffic["seq_len"]},
    }
