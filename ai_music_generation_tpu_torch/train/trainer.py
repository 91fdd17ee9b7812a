"""Training orchestration on one card or a mesh: init or resume, the train
loop, evaluation, checkpoints. The port of ``ai_music_generation_tpu/train/
trainer.py`` (and, through it, of nanoGPT's train.py):

- the config defaults and flag names, a config file plus ``--k=v``
  overrides (``cli/train.py``);
- ``vocab_size`` from the dataset's meta.pkl, else 50304;
- ``init_from``: ``scratch`` (``init_weights`` from a generator seeded with
  ``seed`` on the run's device), ``resume`` (``last_iter_ckpt.pt``, the
  architecture forced from its ``model_args``), ``<path>.pt`` (fine-tune
  from a nanoGPT checkpoint's weights and architecture; optimizer and
  iteration start fresh), ``gpt2*`` (a HF GPT-2, ``models/hf_import.py``:
  a local directory or a hub name; its architecture, block_size
  ``n_positions`` uncropped, optimizer and iteration fresh);
- the cosine LR with warmup, AdamW decay groups and the optax clip
  (``train/optimizer.py``), accumulation over micro-steps
  (``train/step.py``);
- evaluation every ``eval_interval`` into ``losses.jsonl``, ``ckpt.pt``
  (best val, or always) and ``last_iter_ckpt.pt`` (``train/checkpoint.py``);
- the MFU EMA after the first 5 iterations of the process.

Without a process group the trainer runs on one card (``device``, "cuda"
by default): the micro-batch is ``batch_size`` and ``grad_accum`` is
``gradient_accumulation_steps``. Under ``torchrun`` (``cli/train.py``
joins the group, ``parallel/distributed.py``) it trains over a (data,
model) mesh of every rank, ``n_model`` on the model axis (tensor and
expert parallelism) and the rest on data (DDP, or FSDP2 with ``fsdp``),
with the JAX batch arithmetic: the micro-batch is ``batch_size * n_data``
rows, each rank's ``batch_size`` of them drawn by ``sharded_sample`` from
the global batch, ``grad_accum`` is ``gradient_accumulation_steps //
n_data``, and an accumulation that is neither 1 nor divisible by
``n_data`` raises, as in JAX. Only the main process prints and writes;
checkpoints hold the whole state whatever the mesh (``train/
checkpoint.py``), and the MFU counts the mesh's tokens over its cards.
``dtype`` is the compute type. MoE (``n_expert > 0``, ``models/moe.py``)
trains as in JAX: the loss the step reports includes the aux term,
``model_args`` carries ``MOE_KEYS`` and a resume restores the MoE
architecture from them.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

import torch
import torch.distributed as dist

from ai_music_generation_tpu_torch.data.memmap import BinDataset, load_meta
from ai_music_generation_tpu_torch.models.convert import init_weights
from ai_music_generation_tpu_torch.models.gpt import (
    GPT,
    GPTConfig,
    estimate_mfu,
    peak_flops_for,
)
from ai_music_generation_tpu_torch.models.nanogpt_ckpt import (
    MOE_KEYS,
    model_state,
    read_ckpt,
)
from ai_music_generation_tpu_torch.parallel.distributed import (
    is_main_process,
)
from ai_music_generation_tpu_torch.parallel.mesh import Layout, make_mesh
from ai_music_generation_tpu_torch.parallel.sharding import parallelize
from ai_music_generation_tpu_torch.train import checkpoint as ckpt_lib
from ai_music_generation_tpu_torch.train.optimizer import (
    cosine_warmup_schedule,
    make_optimizer,
)
from ai_music_generation_tpu_torch.train.step import (
    make_eval_step,
    make_train_step,
)
from ai_music_generation_tpu_torch.utils.configurator import config_snapshot
from ai_music_generation_tpu_torch.utils.device import resolve_device

# The JAX trainer's defaults (the reference's names, so its config files
# apply unchanged), with "device" added
DEFAULTS: dict[str, Any] = dict(
    out_dir="out",
    eval_interval=2000,
    log_interval=1,
    eval_iters=200,
    eval_only=False,
    always_save_checkpoint=True,
    init_from="scratch",  # 'scratch' | 'resume' | '<path>.pt' | 'gpt2*'
    wandb_log=False,
    wandb_project="owt",
    wandb_run_name="gpt2",
    dataset="openwebtext",
    gradient_accumulation_steps=5 * 8,
    batch_size=12,
    block_size=1024,
    n_layer=12,
    n_head=12,
    n_embd=768,
    dropout=0.0,
    bias=False,
    learning_rate=6e-4,
    max_iters=600000,
    weight_decay=1e-1,
    beta1=0.9,
    beta2=0.95,
    grad_clip=1.0,
    decay_lr=True,
    warmup_iters=2000,
    lr_decay_iters=600000,
    min_lr=6e-5,
    seed=1337,
    data_root="data",  # datasets live at <data_root>/<dataset>/
    n_model=1,  # model axis of the mesh (tensor / expert parallelism)
    fsdp=False,  # FSDP2 over the data axis (else DDP)
    n_expert=0,  # Mixture-of-Experts: experts per block MLP (0 = dense)
    n_kv_head=0,  # grouped-query attention: K/V heads (0 = n_head)
    expert_top_k=2,
    capacity_factor=1.25,
    moe_aux_coef=0.01,
    dtype="bfloat16",  # compute type: 'bfloat16' | 'float32'
    eval_dataset="",  # optional override of the eval dataset dir
    device="cuda",  # 'cuda' | 'cpu'
)

ARCH_KEYS = ("n_layer", "n_head", "n_embd", "block_size", "bias", "vocab_size")
# ride model_args only when set (MoE, GQA), so dense checkpoints keep
# nanoGPT's exact key set
OPT_ARCH_KEYS = MOE_KEYS + ("n_kv_head",)


class Trainer:
    def __init__(self, config: dict[str, Any]):
        self.c = dict(DEFAULTS)
        self.c.update(config)
        c = self.c
        self.device = resolve_device(c["device"])
        self.layout = self.plan = None
        self.n_data, self.data_rank = 1, 0
        if dist.is_initialized():
            self.layout = Layout(make_mesh(n_model=c["n_model"],
                                           device=self.device.type))
            self.n_data, self.data_rank = (self.layout.n_data,
                                           self.layout.data_rank)
        elif c["n_model"] > 1 or c["fsdp"]:
            raise RuntimeError(
                "n_model > 1 and fsdp train over a mesh: start under "
                "torchrun (cli/train.py joins the process group)")
        self.main = is_main_process()
        os.makedirs(c["out_dir"], exist_ok=True)
        # the reference's rule (nanoGPT/train.py:96-99), as JAX applies it:
        # accum is split over the data axis; 1 widens the batch instead
        accum = c["gradient_accumulation_steps"]
        if accum != 1 and accum % self.n_data != 0:
            raise ValueError(
                f"gradient_accumulation_steps={accum} must be 1 (widened-"
                f"batch mode) or divisible by the data-parallel size "
                f"{self.n_data} (ref nanoGPT/train.py:96-99)")
        self.grad_accum = max(1, accum // self.n_data)
        self.micro_batch = c["batch_size"] * self.n_data
        self.tokens_per_iter = (self.grad_accum * self.micro_batch
                                * c["block_size"])

        data_dir = os.path.join(c["data_root"], c["dataset"])
        self.train_data = BinDataset(os.path.join(data_dir, "train.bin"))
        eval_dir = (os.path.join(c["data_root"], c["eval_dataset"])
                    if c["eval_dataset"] else data_dir)
        self.val_data = BinDataset(os.path.join(eval_dir, "val.bin"))

        meta = load_meta(os.path.join(data_dir, "meta.pkl"))
        self.meta_vocab_size = meta.get("vocab_size") if meta else None

        self.iter_num = 0
        self.best_val_loss = 1e9
        self._build_model_and_state()

    # -- init / resume ----------------------------------------------------
    def _model_args(self) -> dict:
        c = self.c
        args = dict(
            n_layer=c["n_layer"], n_head=c["n_head"], n_embd=c["n_embd"],
            block_size=c["block_size"], bias=c["bias"],
            vocab_size=self.meta_vocab_size or 50304,
        )
        if c["n_expert"] > 0:
            args.update({k: c[k] for k in MOE_KEYS})
        if c["n_kv_head"]:
            args["n_kv_head"] = c["n_kv_head"]
        return args

    def _arch_from(self, model_args: dict, source: dict) -> None:
        """The architecture keys of a checkpoint's model_args win over the
        config's (the reference's resume rule)."""
        model_args.update({k: source[k] for k in ARCH_KEYS})
        for k in OPT_ARCH_KEYS:  # only on MoE / GQA checkpoints
            if source.get(k) is not None:
                model_args[k] = source[k]

    def _build_model_and_state(self):
        c = self.c
        model_args = self._model_args()
        out_dir = c["out_dir"]
        ckpt = state = None
        if c["init_from"] == "resume":
            if not ckpt_lib.checkpoint_exists(out_dir, ckpt_lib.LAST):
                hint = ""
                if ckpt_lib.checkpoint_exists(out_dir, ckpt_lib.BEST):
                    hint = (" — found only a best-val ckpt.pt there; to "
                            "fine-tune from it pass --init_from="
                            f"{os.path.join(out_dir, ckpt_lib.BEST)}")
                elif os.path.exists(os.path.join(out_dir, "last_iter_ckpt",
                                                 "meta.json")):
                    hint = (" — found the JAX package's orbax checkpoint "
                            "(last_iter_ckpt/), which needs jax; convert it "
                            "with `python -m ai_music_generation_tpu.cli."
                            "convert_ckpt gpt to-torch` (weights only) and "
                            "fine-tune via --init_from=<path>.pt")
                raise FileNotFoundError(
                    f"init_from=resume but no {ckpt_lib.LAST} in {out_dir}"
                    f"{hint}")
            ckpt = ckpt_lib.load_checkpoint(out_dir, ckpt_lib.LAST)
            self._arch_from(model_args, ckpt["model_args"])
        elif c["init_from"].startswith("gpt2"):
            # HF GPT-2 weight import (ref: train.py:196-203)
            from ai_music_generation_tpu_torch.models.hf_import import (
                from_pretrained,
            )

            hf_config, state = from_pretrained(c["init_from"], c["dropout"])
            model_args.update(
                n_layer=hf_config.n_layer, n_head=hf_config.n_head,
                n_embd=hf_config.n_embd, block_size=hf_config.block_size,
                bias=hf_config.bias, vocab_size=hf_config.vocab_size,
            )
        elif c["init_from"].endswith(".pt"):
            ckpt = read_ckpt(c["init_from"])
            self._arch_from(model_args, ckpt["model_args"])
            self._print(f"initializing from reference checkpoint "
                        f"{c['init_from']} (trained to iter "
                        f"{ckpt.get('iter_num', 0)})")
        elif c["init_from"] != "scratch":
            raise ValueError(f"unknown init_from {c['init_from']!r}")

        dtype = torch.bfloat16 if c["dtype"] == "bfloat16" else torch.float32
        self.model_args = model_args
        self.gpt_config = GPTConfig(dropout=c["dropout"], dtype=dtype,
                                    **model_args)
        self.model = GPT(self.gpt_config, device=self.device)
        if ckpt is not None:
            state = model_state(ckpt)
        if state is None:
            init_weights(self.model, torch.Generator(self.device).manual_seed(
                c["seed"]))
        else:
            self.model.load_state_dict(state)
        self.n_params = self.model.num_params()
        self.module = self.model
        if self.layout is not None:
            self.module, self.plan = parallelize(self.model, self.layout,
                                                 c["fsdp"])

        self.schedule = (
            cosine_warmup_schedule(c["learning_rate"], c["warmup_iters"],
                                   c["lr_decay_iters"], c["min_lr"])
            if c["decay_lr"] else (lambda it: c["learning_rate"]))
        self.optimizer = make_optimizer(self.model, c["learning_rate"],
                                        c["weight_decay"], c["beta1"],
                                        c["beta2"])
        if c["init_from"] == "resume":
            if self.plan is None:
                self.optimizer.load_state_dict(ckpt["optimizer"])
            else:
                self.plan.load_optimizer_state(self.model, self.optimizer,
                                               ckpt["optimizer"])
            self.iter_num = ckpt["iter_num"]
            self.best_val_loss = ckpt["best_val_loss"]
        self._train_step = make_train_step(self.model, self.optimizer,
                                           self.schedule, c["grad_clip"],
                                           self.plan)
        self._eval_step = make_eval_step(self.model, self.plan)
        # the mesh's peak: every card of the process group
        self.peak_flops = peak_flops_for(self.device) * (
            1 if self.layout is None else dist.get_world_size())
        self._print(f"number of parameters: {self.n_params/1e6:.2f}M")

    def _print(self, *args) -> None:
        if self.main:
            print(*args)

    # -- data --------------------------------------------------------------
    def get_batch(self, split: str, it: int, for_accum: bool = True):
        """(x, y) for one optimizer iteration ([grad_accum, micro_batch,
        T]) or one eval batch ([micro_batch, T]), int32 on the device; on a
        mesh this rank's ``batch_size`` rows of the micro-batch."""
        c = self.c
        ds = self.train_data if split == "train" else self.val_data
        # a seed stream per split
        seed = c["seed"] + (0 if split == "train" else 101)
        shape = ((self.grad_accum, self.micro_batch) if for_accum
                 else (self.micro_batch,))
        x, y = ds.sharded_sample(seed, it, shape, c["block_size"],
                                 (self.data_rank, self.n_data))
        return (torch.from_numpy(x).to(self.device),
                torch.from_numpy(y).to(self.device))

    # -- eval ---------------------------------------------------------------
    def estimate_loss(self) -> dict[str, float]:
        """Mean loss over eval_iters batches per split, in eval() mode."""
        out = {}
        for split in ("train", "val"):
            losses = [
                self._eval_step(*self.get_batch(
                    split, 10_000_000 + self.iter_num + k, for_accum=False))
                for k in range(self.c["eval_iters"])]
            out[split] = float(torch.stack(losses).mean())
        return out

    # -- checkpoint ----------------------------------------------------------
    def _save(self, name: str):
        ckpt_lib.save_checkpoint(
            self.c["out_dir"], name, self.model, self.optimizer,
            self.iter_num, self.best_val_loss, config_snapshot(self.c),
            self.plan)

    # -- main loop ------------------------------------------------------------
    def run(self) -> float:
        c = self.c
        losses_path = os.path.join(c["out_dir"], "losses.jsonl")
        running_mfu = -1.0
        local_iter = 0  # iterations of this process (early ones warm up)
        t0 = time.time()

        if c["wandb_log"] and self.main:
            try:
                import wandb

                wandb.init(project=c["wandb_project"],
                           name=c["wandb_run_name"], config=c)
            except ImportError:
                print("wandb not available; skipping wandb logging")
                c["wandb_log"] = False

        while True:
            if self.iter_num % c["eval_interval"] == 0:
                losses = self.estimate_loss()
                self._print(
                    f"step {self.iter_num}: train loss {losses['train']:.4f}, "
                    f"val loss {losses['val']:.4f}"
                )
                rec = {
                    "iter": self.iter_num,
                    "train/loss": losses["train"],
                    "val/loss": losses["val"],
                    "lr": float(self.schedule(self.iter_num)),
                    "mfu": running_mfu * 100,
                }
                if self.main:
                    with open(losses_path, "a") as f:
                        f.write(json.dumps(rec) + "\n")
                if c["wandb_log"] and self.main:
                    import wandb

                    wandb.log(rec)
                if (losses["val"] < self.best_val_loss
                        or c["always_save_checkpoint"]):
                    self.best_val_loss = min(self.best_val_loss,
                                             losses["val"])
                    if self.iter_num > 0:
                        self._save(ckpt_lib.BEST)
                if self.iter_num > 0:
                    self._save(ckpt_lib.LAST)
            if self.iter_num == 0 and c["eval_only"]:
                break

            x, y = self.get_batch("train", self.iter_num)
            metrics = self._train_step(x, y, self.iter_num, c["seed"])

            if self.iter_num % c["log_interval"] == 0:
                # float() waits for every step enqueued since the last log,
                # so dt is the window's wall per iteration
                loss = float(metrics["loss"])
                window = max(1, c["log_interval"]) if self.iter_num > 0 else 1
                dt = (time.time() - t0) / window
                if local_iter >= 5:
                    mfu = estimate_mfu(
                        self.gpt_config, self.n_params,
                        self.micro_batch * self.grad_accum, dt,
                        self.peak_flops)
                    running_mfu = (mfu if running_mfu == -1.0
                                   else 0.9 * running_mfu + 0.1 * mfu)
                self._print(
                    f"iter {self.iter_num}: loss {loss:.4f}, time "
                    f"{dt*1000:.2f}ms, mfu {running_mfu*100:.2f}%"
                )
                t0 = time.time()

            self.iter_num += 1
            local_iter += 1
            if self.iter_num > c["max_iters"]:
                break
        return self.best_val_loss
