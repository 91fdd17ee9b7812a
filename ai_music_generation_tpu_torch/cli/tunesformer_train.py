"""TunesFormer trainer, the port of
``ai_music_generation_tpu/cli/tunesformer_train.py`` (behaviour-compatible
with ref: tunesformer/train.py):

    python -m ai_music_generation_tpu_torch.cli.tunesformer_train \\
        --data_path=data.json --out_dir=tf_out [--device=cpu] [--k=v ...]

- ``data.json`` items {'control code', 'abc notation'} (from
  ``cli/add_control_codes.py``); training text = control code + the abc
  body with its first line dropped (ref :64); patch-encoded with bos/eos
  patches, empty encodes skipped;
- a 90/10 split shuffled by ``random.Random(seed)``, whose state then
  orders every epoch's batches (full batches; eval wraps its tail into one
  more batch);
- ``optax_adamw`` (optax.adamw's defaults) under ``hf_cosine_schedule``
  (10% warmup), the NaN guard on the device (``train/tunes_step.py``),
  dropout keyed by ``dropout_key(seed + 7, step_count)``, optional patch
  subsampling drawn per step from ``np.random.default_rng((seed,
  step_count, b))``; epoch means skip NaN losses;
- ``logs.txt`` in the JAX CLI's format, and at each new best eval loss
  ``<out_dir>/weights.pth`` in the reference trainer's format
  (``models/tunesformer_export.py::save_reference_checkpoint``: the model,
  the AdamW moments and count, the schedule state, epoch, best_epoch,
  min_eval_loss, model_args), which the JAX package's ``load_tunesformer``
  and the port's read; ``--load_from_checkpoint=True`` resumes from it,
  ``--torch_init=<weights.pth>`` fine-tunes from a reference checkpoint's
  weights (fresh optimizer and epoch).

Differences from the JAX CLI: the checkpoint is the reference's
``weights.pth``, not an orbax directory (which needs JAX); a resume replays
the split generator's shuffles of the epochs before the checkpoint, so it
continues the uninterrupted run's batch order (the JAX CLI restarts it);
the losses are summed on the device (in fp64, the JAX CLI's host sums) and
read once an epoch; ``ms_per_iter`` is the median time between the ends
of an epoch's steps (CUDA events on the card).

Under ``torchrun`` (one process per card; gloo with ``--device=cpu``) the
JAX CLI's mesh rule applies: over ``world`` processes, ``n_data = world //
n_model``, and the steps run sharded (``train/tunes_step.py::
shard_tunesformer_step``: the batch on the data axis, tensor parallelism
over ``--n_model``) when ``world > 1``, ``world % n_model == 0`` and the
batch divides over ``n_data``; else each process trains a whole replica
(rank 0 says so). Without a process group ``--n_model > 1`` raises, as
``train/trainer.py`` does. Only rank 0 prints and
writes; ``weights.pth`` holds the whole model and optimizer state whatever
the mesh, and a resume loads it into any mesh.
"""

from __future__ import annotations

import itertools
import json
import os
import random
import statistics
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ai_music_generation_tpu_torch.parallel.distributed import (
    initialize_distributed,
    is_main_process,
    shutdown,
)
from ai_music_generation_tpu_torch.tokenizers.patchilizer import Patchilizer
from ai_music_generation_tpu_torch.train.optimizer import (
    adamw_count,
    hf_cosine_schedule,
)
from ai_music_generation_tpu_torch.utils.configurator import apply_overrides

DEFAULTS = dict(
    data_path="data.json",
    out_dir="tf_out",
    num_epochs=32,  # ref config.py:7
    learning_rate=5e-5,  # ref config.py:8
    batch_size=8,
    patch_length=128,
    patch_size=32,
    patch_layers=9,
    char_layers=3,
    n_embd=768,
    n_head=12,
    share_weights=False,
    load_from_checkpoint=False,
    torch_init="",  # a reference weights.pth to fine-tune from (weights only)
    patch_sampling_batch_size=0,  # ref config.py:9; 0 = full context
    n_model=1,  # model axis of the mesh under torchrun (tensor parallel)
    seed=42,
    eval_ratio=0.1,
    dtype="bfloat16",
    max_examples=0,  # 0 = all (debug knob)
    device="cuda",
)
WEIGHTS = "weights.pth"


def encode_dataset(items, patch_length, patch_size):
    """Pre-encode items to padded [patch_length, patch_size] int32 arrays
    (ref MyDataset, train.py:59-74); the FIRST LINE of 'abc notation' is
    dropped as the reference drops it (train.py:64)."""
    p = Patchilizer()
    out = []
    for item in items:
        text = item["control code"] + "\n".join(
            item["abc notation"].split("\n")[1:])
        patches = p.encode(text, patch_length, patch_size,
                           add_special_patches=True)
        if not patches or not np.asarray(patches).sum():
            continue
        arr = np.zeros((patch_length, patch_size), np.int32)
        arr[: len(patches)] = np.asarray(patches, np.int32)
        out.append(arr)
    return out


def split_items(data: list, seed: int, eval_ratio: float):
    """(the split's ``random.Random(seed)``, eval items, train items):
    ``data`` shuffled in place, its first ``len * eval_ratio`` items for
    eval. The generator goes on to order the epochs' batches."""
    rng = random.Random(seed)
    rng.shuffle(data)
    split = int(len(data) * eval_ratio)
    return rng, data[:split], data[split:]


def epoch_batches(arrs, shuffle_rng, B, pad_to_full=False):
    """One epoch's full [B, P, S] batches in a fresh shuffled order; with
    ``pad_to_full`` the tail wraps around so a small eval set still gives
    one (slightly example-weighted) batch."""
    idx = list(range(len(arrs)))
    shuffle_rng.shuffle(idx)
    for lo in range(0, len(idx) - B + 1, B):
        yield np.stack([arrs[i] for i in idx[lo: lo + B]])
    rem = len(idx) % B
    if pad_to_full and rem and idx:
        tail = list(itertools.islice(itertools.cycle(idx), len(idx) - rem,
                                     len(idx) - rem + B))
        yield np.stack([arrs[i] for i in tail])


def patch_indices_for(seed, step_count, B, psbs, patch_length):
    """[B, psbs] int32 sorted conditioning rows of one step (ref
    :126-135): row b from ``np.random.default_rng((seed, step_count, b))``."""
    return np.sort(np.stack([
        np.random.default_rng((seed, step_count, b)).choice(
            patch_length - 1, size=psbs, replace=False)
        for b in range(B)]), axis=1).astype(np.int32)


class _StepClock:
    """The times between the ends of an epoch's steps: CUDA events on the
    card (no host sync until :meth:`ms`), the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def ms(self) -> list[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b)
                    for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def main(argv=None):
    """Train; returns a dict: ``min_eval_loss``, ``best_epoch`` and the
    run's ``epochs`` (epoch, train_loss, eval_loss, steps, ms_per_iter)."""
    argv = sys.argv[1:] if argv is None else argv
    c = apply_overrides(dict(DEFAULTS), argv)
    joined = not dist.is_initialized()  # leave a caller's group up
    initialize_distributed(c["device"])
    try:
        return _train(c)
    finally:
        if joined:
            shutdown()


def _train(c):
    if int(c["n_model"]) > 1 and not dist.is_initialized():
        raise RuntimeError(
            "--n_model > 1 trains over a mesh: start under torchrun "
            "(main() joins the process group)")
    from ai_music_generation_tpu_torch.models.convert import (
        init_tunesformer_weights,
    )
    from ai_music_generation_tpu_torch.models.tunesformer import (
        TunesFormer, TunesFormerConfig,
    )
    from ai_music_generation_tpu_torch.models.tunesformer_export import (
        save_reference_checkpoint,
    )
    from ai_music_generation_tpu_torch.models.tunesformer_import import (
        load_reference_checkpoint, optimizer_state_from_reference,
        read_reference,
    )
    from ai_music_generation_tpu_torch.parallel.mesh import make_mesh
    from ai_music_generation_tpu_torch.train.optimizer import optax_adamw
    from ai_music_generation_tpu_torch.train.tunes_step import (
        make_tunesformer_eval_step, make_tunesformer_train_step,
        shard_tunesformer_step,
    )
    from ai_music_generation_tpu_torch.utils.device import resolve_device

    device = resolve_device(c["device"])
    main = is_main_process()
    say = print if main else (lambda *a, **k: None)
    os.makedirs(c["out_dir"], exist_ok=True)

    with open(c["data_path"]) as f:
        say("Loading Data...")
        data = json.load(f)
    if c["max_examples"]:
        data = data[: c["max_examples"]]
    rng_py, eval_items, train_items = split_items(data, c["seed"],
                                                  c["eval_ratio"])
    train_arrs = encode_dataset(train_items, c["patch_length"],
                                c["patch_size"])
    eval_arrs = encode_dataset(eval_items, c["patch_length"], c["patch_size"])
    say(f"train {len(train_arrs)} / eval {len(eval_arrs)} examples")

    cfg = TunesFormerConfig(
        patch_length=c["patch_length"], patch_size=c["patch_size"],
        patch_layers=c["patch_layers"], char_layers=c["char_layers"],
        n_embd=c["n_embd"], n_head=c["n_head"],
        share_weights=c["share_weights"],
        dtype=torch.bfloat16 if c["dtype"] == "bfloat16" else torch.float32)
    # weights are made on the CPU (the same bits whatever the device)
    model = TunesFormer(cfg, device="cpu")
    if c["torch_init"]:
        model.load_state_dict(load_reference_checkpoint(c["torch_init"], cfg))
        say(f"initialized from reference checkpoint {c['torch_init']}")
    else:
        init_tunesformer_weights(model,
                                 torch.Generator().manual_seed(c["seed"]))
    model.to(device)
    say(f"Parameter Number: {sum(p.numel() for p in model.parameters())}")

    B = c["batch_size"]
    steps_per_epoch = max(1, len(train_arrs) // B)
    total_steps = c["num_epochs"] * steps_per_epoch
    schedule = hf_cosine_schedule(c["learning_rate"], total_steps / 10,
                                  total_steps)
    optimizer = optax_adamw(model.parameters())
    train_step = make_tunesformer_train_step(model, optimizer, schedule)
    eval_step = make_tunesformer_eval_step(model)
    step_count = 0

    best_epoch, min_eval_loss, pre_epoch = 0, 100.0, 0
    path = os.path.join(c["out_dir"], WEIGHTS)
    if c["load_from_checkpoint"] and os.path.exists(path):
        ckpt, _ = read_reference(path)
        model.load_state_dict(load_reference_checkpoint(path, cfg))
        optimizer.load_state_dict(optimizer_state_from_reference(
            ckpt, model, optimizer))
        pre_epoch = int(ckpt["epoch"])
        best_epoch = int(ckpt["best_epoch"])
        min_eval_loss = float(ckpt["min_eval_loss"])
        step_count = pre_epoch * steps_per_epoch
        # the earlier epochs' shuffles, so the batch order continues
        for _ in range(pre_epoch):
            rng_py.shuffle(list(range(len(train_arrs))))
            rng_py.shuffle(list(range(len(eval_arrs))))
        say(f"Successfully Loaded Checkpoint from Epoch {pre_epoch}")

    # the JAX CLI's mesh rule (its :154-173)
    world = dist.get_world_size() if dist.is_initialized() else 1
    n_model = max(int(c["n_model"]), 1)
    n_data = world // n_model
    plan = None
    if world > 1 and world % n_model == 0 and B % n_data == 0:
        mesh = make_mesh(n_data, n_model, device.type)
        say(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        train_step, eval_step, model, optimizer, plan = (
            shard_tunesformer_step(mesh, model, schedule,
                                   optimizer.state_dict()))
    elif world > 1:
        say(f"no mesh ({world} processes, --n_model={n_model}, batch {B}): "
            f"every process trains a whole replica on its own")

    psbs = c["patch_sampling_batch_size"]
    epochs = []
    for epoch in range(pre_epoch + 1, c["num_epochs"] + 1):
        say("-" * 21 + f"Epoch {epoch}" + "-" * 21)
        tl = torch.zeros((), dtype=torch.float64, device=device)
        tn = torch.zeros((), dtype=torch.int64, device=device)
        clock = _StepClock(device)
        clock.mark()
        for batch in epoch_batches(train_arrs, rng_py, B):
            patch_indices = None
            if psbs and psbs < c["patch_length"] - 1:
                patch_indices = torch.from_numpy(patch_indices_for(
                    c["seed"], step_count, len(batch), psbs,
                    c["patch_length"])).to(device)
            loss = train_step(torch.from_numpy(batch).to(device),
                              step_count, c["seed"] + 7, patch_indices)
            step_count += 1
            ok = torch.isfinite(loss)
            tl += torch.where(ok, loss.double(), 0.0)
            tn += ok
            clock.mark()
        steps_ms = clock.ms()
        el = torch.zeros((), dtype=torch.float64, device=device)
        en = torch.zeros((), dtype=torch.int64, device=device)
        for batch in epoch_batches(eval_arrs, rng_py, B, pad_to_full=True):
            loss = eval_step(torch.from_numpy(batch).to(device))
            ok = torch.isfinite(loss)
            el += torch.where(ok, loss.double(), 0.0)
            en += ok
        train_loss = float(tl) / max(int(tn), 1)
        eval_loss = float(el) / max(int(en), 1)
        ms = statistics.median(steps_ms) if steps_ms else float("nan")
        say(f"train_loss: {train_loss:.4f} eval_loss: {eval_loss:.4f} "
            f"({len(steps_ms)} steps, {ms:.2f} ms/iter)")
        if main:
            with open(os.path.join(c["out_dir"], "logs.txt"), "a") as f:
                f.write(
                    f"Epoch {epoch}\ntrain_loss: {train_loss}\neval_loss: "
                    f"{eval_loss}\ntime: {time.asctime()}\n\n")
        epochs.append(dict(epoch=epoch, train_loss=train_loss,
                           eval_loss=eval_loss, steps=len(steps_ms),
                           ms_per_iter=ms))
        if eval_loss < min_eval_loss:
            best_epoch, min_eval_loss = epoch, eval_loss
            lr = float(schedule(adamw_count(optimizer)))
            whole, whole_opt = model, optimizer
            if plan is not None:  # every rank gathers
                state, opt_state = plan.gather_state(model, optimizer)
            if main and plan is not None:  # a whole copy on the CPU
                whole = TunesFormer(cfg, device="cpu")
                whole.load_state_dict(state)
                whole_opt = optax_adamw(whole.parameters())
                whole_opt.load_state_dict(opt_state)
            if main:
                save_reference_checkpoint(
                    path, whole, epoch=epoch, best_epoch=best_epoch,
                    min_eval_loss=min_eval_loss, optimizer=whole_opt,
                    base_lr=c["learning_rate"], lr=lr)
            if plan is not None:  # the file is there for every rank
                dist.barrier()
    say(f"Best Eval Epoch : {best_epoch}")
    say(f"Min Eval Loss : {min_eval_loss}")
    return dict(min_eval_loss=min_eval_loss, best_epoch=best_epoch,
                epochs=epochs)


if __name__ == "__main__":
    main()
