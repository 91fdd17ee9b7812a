"""Training checkpoints in the reference trainer's contract: the port of
``ai_music_generation_tpu/train/checkpoint.py``.

The JAX package writes orbax directories ``ckpt/`` and ``last_iter_ckpt/``;
the port writes what their docstring cites, nanoGPT's files (train.py:
316-329):

- ``<out_dir>/ckpt.pt``            best validation loss (or every eval with
  ``always_save_checkpoint``);
- ``<out_dir>/last_iter_ckpt.pt``  the latest, written at every eval;

each ``{model, optimizer, model_args, iter_num, best_val_loss, config}``
with the trainer's AdamW ``state_dict`` (``models/nanogpt_ckpt.py::
save_ckpt``). ``cli/sample.py`` samples from ``ckpt.pt``; resume reads
``last_iter_ckpt.pt`` and takes the architecture from its ``model_args``.
Reading an orbax checkpoint needs jax and stays with the JAX package.

Checkpoints do not depend on the topology (the JAX contract,
train/checkpoint.py:60-95): a model split over a mesh (``plan``,
``parallel/sharding.py``) gathers its whole parameters and AdamW moments on
every rank, and the main process writes the same file as one card; on
resume every rank loads the file into its own layout
(``MeshPlan.load_optimizer_state``).
"""

from __future__ import annotations

import os
from typing import Any

import torch
import torch.distributed as dist

from ai_music_generation_tpu_torch.models.gpt import GPT
from ai_music_generation_tpu_torch.models.nanogpt_ckpt import (
    read_ckpt,
    save_ckpt,
)
from ai_music_generation_tpu_torch.parallel.distributed import (
    is_main_process,
)

BEST = "ckpt.pt"
LAST = "last_iter_ckpt.pt"


def save_checkpoint(out_dir: str, name: str, model: GPT,
                    optimizer: torch.optim.Optimizer, iter_num: int,
                    best_val_loss: float, config: dict[str, Any],
                    plan=None) -> None:
    """Write ``<out_dir>/<name>``; a partial file never replaces a whole
    one (written beside it, then renamed). With ``plan`` every rank must
    call it (it gathers); the main process writes, and no rank returns
    before the file is there."""
    state = optimizer_state = None
    if plan is not None:
        state, optimizer_state = plan.gather_state(model, optimizer)
    if is_main_process():
        path = os.path.join(out_dir, name)
        save_ckpt(path + ".tmp", model, iter_num, best_val_loss, config,
                  optimizer, state=state, optimizer_state=optimizer_state)
        os.replace(path + ".tmp", path)
    if plan is not None:
        dist.barrier()


def load_checkpoint(out_dir: str, name: str = BEST) -> dict:
    """The checkpoint dict, every tensor on the CPU."""
    return read_ckpt(os.path.join(out_dir, name))


def checkpoint_exists(out_dir: str, name: str = BEST) -> bool:
    return os.path.exists(os.path.join(out_dir, name))
