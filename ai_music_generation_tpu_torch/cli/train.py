"""Training CLI of the port, flag-compatible with
``ai_music_generation_tpu/cli/train.py`` (and, through it, with the
reference trainer):

    python -m ai_music_generation_tpu_torch.cli.train \\
        ai_music_generation_tpu_torch/configs/<exp>.py --batch_size=32

A positional argument is a Python config file executed over the defaults;
``--key=value`` flags override single keys. The run trains on the CUDA card;
``--device=cpu`` trains on the CPU (the tests do), and without a card and
without that flag it raises. It writes ``<out_dir>/ckpt.pt``,
``last_iter_ckpt.pt`` and ``losses.jsonl``; ``--init_from=resume``
continues from ``last_iter_ckpt.pt``. ``--n_expert=4 --expert_top_k=2
--capacity_factor=1.25 --moe_aux_coef=0.01`` trains a Mixture-of-Experts
GPT (``models/moe.py``), as the JAX CLI does.

Under ``torchrun`` the same command trains over a (data, model) mesh of
one process per card (NCCL; gloo with ``--device=cpu``):

    torchrun --nproc_per_node=4 -m ai_music_generation_tpu_torch.cli.train \
        ai_music_generation_tpu_torch/configs/irishman_char.py \
        --n_model=2 --fsdp=True

``--n_model`` cards share each model (tensor and expert parallelism), the
rest split the batch (DDP, or FSDP2 with ``--fsdp=True``); only rank 0
prints and writes.
"""

import sys

import torch.distributed as dist

from ai_music_generation_tpu_torch.parallel.distributed import (
    initialize_distributed,
    is_main_process,
    shutdown,
)
from ai_music_generation_tpu_torch.train.trainer import DEFAULTS, Trainer
from ai_music_generation_tpu_torch.utils.configurator import apply_overrides


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    config = apply_overrides(dict(DEFAULTS), argv)
    joined = not dist.is_initialized()  # leave a caller's group up
    info = initialize_distributed(config["device"])
    try:
        trainer = Trainer(config)
        if is_main_process():
            if info["process_count"] > 1:
                print(f"processes: {info['process_count']}")
            print(f"tokens per iteration will be: "
                  f"{trainer.tokens_per_iter:,}")
        best = trainer.run()
        if is_main_process():
            print(f"best val loss: {best:.4f}")
        return best
    finally:
        if joined:
            shutdown()


if __name__ == "__main__":
    main()
