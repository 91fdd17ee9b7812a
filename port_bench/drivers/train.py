"""Training: whole optimizer steps back to back through the port's
``train/step.py::make_train_step`` over ``train/optimizer.py``'s AdamW and
cosine schedule, fed as the port's trainer feeds them: each step's batch
from ``data/memmap.py``'s ``sharded_sample`` over a flat token file, moved
to the device; the loss read to the host every ``log_interval`` steps.

Traffic keys: ``micro_batch`` rows, ``grad_accum`` micro-batches a step,
``corpus_tokens`` random ids in the token file (written at set-up under
``TMPDIR``, removed at the end), ``log_interval``, ``check_rows`` (rows of
a micro-batch the reference runs at once). The configuration's ``train``
section gives dropout, the optimizer and the schedule.

Set-up builds the step and drives it through the first ``CHECK_STEPS``
steps; the window continues from there with the same object. The check
follows those steps in the plain reference (fp32, TF32 off) on the same
weights and the same batches, drawn again by the reference's own rule
from the same file: ``loss_gap`` the worst relative gap of a step's loss;
``grad_gap`` the worst leaf's gap between the norms of the first step's
clipped gradient (the program's read from AdamW's first moment after one
step, ``exp_avg / (1 - beta1)``); ``change_gap`` the worst leaf's gap
between the norms of the parameters' change over the steps, over leaves
whose reference gradient norm is at least a thousandth of the median
leaf's (the rest move by round-off alone under Adam).
"""

from __future__ import annotations

import math
import os
import shutil
import statistics
import tempfile
import time

import numpy as np
import torch

from port_bench.harness import check, program, weights
from port_bench.reference import batches, gpt_ref
from port_bench.reference.precision import Precision, ieee_fp32

END_TO_END = ("train_tok_s",)
CHECK_STEPS = 3


class Run:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.model_cfg = config["model"]
        self.opt = config["train"]
        self.t = traffic
        self.seed, self.device = seed, torch.device(device)
        self.block = self.model_cfg["block_size"]
        self.shape = (traffic["grad_accum"], traffic["micro_batch"])
        self.tmp = None
        self.it = 0

    # -- the program -------------------------------------------------------
    def setup(self) -> None:
        from ai_music_generation_tpu_torch.data.memmap import BinDataset
        from ai_music_generation_tpu_torch.train.optimizer import (
            cosine_warmup_schedule, make_optimizer,
        )
        from ai_music_generation_tpu_torch.train.step import make_train_step

        t0 = time.perf_counter()
        self.tmp = tempfile.mkdtemp(prefix="port_bench_")
        self.corpus = os.path.join(self.tmp, "train.bin")
        rng = np.random.default_rng([self.seed, 3])
        rng.integers(0, self.model_cfg["vocab_size"],
                     size=self.t["corpus_tokens"],
                     dtype=np.uint16).tofile(self.corpus)
        self.data = BinDataset(self.corpus, dtype=np.uint16)
        o = self.opt
        self.model, w0 = program.build_gpt(
            self.model_cfg, self.seed, self.device, dropout=o["dropout"])
        self.optimizer = make_optimizer(self.model, o["learning_rate"],
                                        o["weight_decay"], o["beta1"],
                                        o["beta2"])
        schedule = cosine_warmup_schedule(o["learning_rate"],
                                          o["warmup_iters"],
                                          o["lr_decay_iters"], o["min_lr"])
        self.step_fn = make_train_step(self.model, self.optimizer, schedule,
                                       o["grad_clip"])
        params = dict(self.model.named_parameters())
        program.sync(self.device)
        t1 = time.perf_counter()
        losses = []
        for s in range(CHECK_STEPS):
            losses.append(self.step()["loss"])
            if s == 0:
                self.grad_norms = {
                    k: _norm(self.optimizer.state.get(p, {}).get("exp_avg"))
                    / (1.0 - o["beta1"]) for k, p in params.items()}
        with torch.no_grad():
            self.change_norms = {
                k: float(torch.linalg.vector_norm(p - w0[k]))
                for k, p in params.items()}
        self.losses = [float(x) for x in losses]
        self.phases = {"corpus_model_and_weights": t1 - t0,
                       "first_steps": time.perf_counter() - t1}

    def batch(self, it: int):
        x, y = self.data.sharded_sample(self.seed, it, self.shape, self.block,
                                        (0, 1))
        return (torch.from_numpy(x).to(self.device),
                torch.from_numpy(y).to(self.device))

    def step(self) -> dict:
        x, y = self.batch(self.it)
        metrics = self.step_fn(x, y, self.it, self.seed)
        self.it += 1
        return metrics

    def window_run(self, seconds: float) -> dict:
        steps = failed = 0
        start = time.perf_counter()
        while True:
            with torch.profiler.record_function("port_bench.train_step"):
                metrics = self.step()
            steps += 1
            if (self.it - 1) % self.t["log_interval"] == 0:
                if not math.isfinite(float(metrics["loss"])):
                    failed += 1
                if time.perf_counter() - start >= seconds:
                    break
        program.sync(self.device)
        elapsed = time.perf_counter() - start
        return {"steps": steps, "elapsed": elapsed, "attempted": steps,
                "failed": failed}

    def tokens_per_step(self) -> int:
        return self.shape[0] * self.shape[1] * self.block

    def end_to_end(self, window: dict) -> dict:
        return {"train_tok_s": window["steps"] * self.tokens_per_step()
                / window["elapsed"]}

    def release(self) -> None:
        self.model = self.optimizer = self.step_fn = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def close(self) -> None:
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
            self.tmp = None

    # -- the check ---------------------------------------------------------
    def reference(self, prec: Precision) -> dict:
        _, w = weights.make(self.model_cfg, self.seed, self.device)
        feed = []
        for s in range(CHECK_STEPS):
            x, y = batches.draw(self.corpus, np.uint16, self.seed, s,
                                *self.shape, self.block)
            feed.append((torch.from_numpy(x).to(self.device),
                         torch.from_numpy(y).to(self.device)))
        o = self.opt
        cfg = dict(self.model_cfg, dropout=o["dropout"])

        def schedule(it):
            # linear warm-up, then cosine to min_lr (nanoGPT's get_lr)
            if it < o["warmup_iters"]:
                return o["learning_rate"] * (it + 1) / (o["warmup_iters"] + 1)
            ratio = (it - o["warmup_iters"]) / (o["lr_decay_iters"]
                                                - o["warmup_iters"])
            return o["min_lr"] + 0.5 * (1 + math.cos(math.pi * ratio)) * (
                o["learning_rate"] - o["min_lr"])

        with ieee_fp32():
            return gpt_ref.train_three_steps(
                w, cfg, o, feed, schedule, self.seed, prec,
                self.t["check_rows"], CHECK_STEPS)

    def _gaps(self, losses, grads, changes, ref) -> dict:
        loss_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(losses, ref["losses"]))
        median = statistics.median(ref["grad_norms"].values())
        moved = [k for k, g in ref["grad_norms"].items()
                 if g >= 1e-3 * median]
        grad_gap, grad_leaf = check.worst_leaf_gap(grads, ref["grad_norms"])
        change_gap, change_leaf = check.worst_leaf_gap(
            changes, ref["change_norms"], moved)
        self.worst = {"grad_gap": grad_leaf, "change_gap": change_leaf,
                      "left_out": sorted(set(ref["grad_norms"]) - set(moved))}
        return {"loss_gap": loss_gap, "grad_gap": grad_gap,
                "change_gap": change_gap}

    def check(self) -> dict:
        ref = self.reference(Precision("fp32"))
        return self._gaps(self.losses, self.grad_norms, self.change_norms,
                          ref)

    def control(self) -> dict:
        """The reference in float8 in the program's place."""
        ref = self.reference(Precision("fp32"))
        low = self.reference(Precision("fp32").lowered())
        return self._gaps(low["losses"], low["grad_norms"],
                          low["change_norms"], ref)


def _norm(t) -> float:
    return 0.0 if t is None else float(torch.linalg.vector_norm(t.float()))

