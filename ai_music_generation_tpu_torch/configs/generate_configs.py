"""Generator for the experiment config grid (26 files).

The reference ships 26 hand-edited config files (ref: nanoGPT/config/*.py)
that are variations of a "baby GPT" template. This script regenerates the
whole grid with the same names and hyperparameter values — run it after
changing the template:

    python -m ai_music_generation_tpu_torch.configs.generate_configs

The port's copy of ``ai_music_generation_tpu/configs/generate_configs.py``:
it writes the port's ``configs/``, whose files equal the JAX package's
value for value (tests/test_torch_host_copies.py) and apply unchanged to
the port's trainer ``DEFAULTS``.
"""

from __future__ import annotations

import os

HERE = os.path.dirname(os.path.abspath(__file__))

BABY = dict(
    eval_interval=250, eval_iters=200, log_interval=10,
    always_save_checkpoint=False,
    wandb_log=False, wandb_run_name="mini-gpt",
    gradient_accumulation_steps=1, batch_size=64, block_size=256,
    n_layer=6, n_head=6, n_embd=384, dropout=0.2,
    learning_rate=1e-3, max_iters=5000, lr_decay_iters=5000, min_lr=1e-4,
    beta2=0.99, warmup_iters=100,
)


def baby(name, dataset, **kw):
    c = dict(BABY)
    c.update(out_dir=f"out-{name.replace('_', '-')}", wandb_project=name.replace("_", "-"),
             dataset=dataset)
    c.update(kw)
    if "lr_decay_iters" not in kw and "max_iters" in kw:
        c["lr_decay_iters"] = kw["max_iters"]
    return c


# value parity with ref: nanoGPT/config/*.py (same experiment grid)
CONFIGS: dict[str, dict] = {
    # music configs
    "bach": baby("bach", "bach", eval_interval=100),
    "bach_512_context": baby("bach_512_context", "bach", eval_interval=100,
                             block_size=512),
    "bach_512_context_augmented": baby(
        "bach_512_context_augmented", "bach_augmented", eval_interval=100,
        block_size=512, wandb_project="bach-512-context"),
    "bach_no_offsets": baby("bach_no_offsets", "bach_no_offsets",
                            eval_interval=100),
    "bach_no_offsets_512_context": baby(
        "bach_no_offsets_512_context", "bach_no_offsets", eval_interval=100,
        block_size=512),
    "bach_from_irishman": baby(
        "bach_from_irishman", "bach", init_from="resume", eval_interval=50,
        always_save_checkpoint=True, max_iters=410250, wandb_project="bach"),
    "bach_from_irishman_512_context": baby(
        "bach_from_irishman_512_context", "bach", init_from="resume",
        eval_interval=50, block_size=512, max_iters=352250, wandb_project="bach"),
    "bach_from_synthetic": baby(
        "bach_from_synthetic", "bach", init_from="resume", eval_interval=50,
        max_iters=154500 + 5000, wandb_project="bach"),
    "bach_from_synthetic_512_context": baby(
        "bach_from_synthetic_512_context", "bach", init_from="resume",
        eval_interval=50, block_size=512, max_iters=53750 + 5000,
        wandb_project="bach"),
    "irishman_char": baby("irishman_char", "irishman", max_iters=500000),
    "irishman_char_1k_context": baby(
        "irishman_char_1k_context", "irishman", block_size=1024,
        max_iters=1000000, wandb_project="out-irishman-char-1k-context"),
    "irishman_whitespace": baby("irishman_whitespace", "irishman_whitespace"),
    "irishman_midi": baby("irishman_midi", "irishman_midi", max_iters=500000),
    "irishman_midi_512_context": baby(
        "irishman_midi_512_context", "irishman_midi", block_size=512,
        max_iters=500000),
    "irishman_midi_no_offsets": baby(
        "irishman_midi_no_offsets", "irishman_midi_no_offsets", max_iters=500000),
    "synthetic_4_parts_from_irishman": baby(
        "synthetic_4_parts_from_irishman", "synthetic_4_parts_from_irishman",
        max_iters=500000),
    "synthetic_4_parts_from_irishman_resampled": baby(
        "synthetic_4_parts_from_irishman_resampled",
        "synthetic_4_parts_from_irishman_resampled", max_iters=500000),
    "synthetic_4_parts_from_irishman_resampled_512_context": baby(
        "synthetic_4_parts_from_irishman_resampled_512_context",
        "synthetic_4_parts_from_irishman_resampled", block_size=512,
        max_iters=500000),
    "synthetic_4_parts_from_irishman_no_same_key": baby(
        "synthetic_4_parts_from_irishman_no_same_key",
        "synthetic_4_parts_from_irishman_no_same_key", max_iters=500000,
        out_dir="synthetic-4-parts-from-irishman-no-same-key"),
    # vendored nanoGPT experiment shapes
    "train_shakespeare_char": baby("shakespeare_char", "shakespeare_char",
                                   out_dir="out-shakespeare-char",
                                   wandb_project="shakespeare-char"),
    "finetune_shakespeare": dict(
        out_dir="out-shakespeare", eval_interval=5, eval_iters=40,
        wandb_log=False, wandb_project="shakespeare",
        wandb_run_name="ft-run", dataset="shakespeare",
        init_from="gpt2-xl", always_save_checkpoint=False, batch_size=1,
        gradient_accumulation_steps=32, max_iters=20, learning_rate=3e-5,
        decay_lr=False,
    ),
    "train_gpt2": dict(
        wandb_log=True, wandb_project="owt", wandb_run_name="gpt2-124M",
        batch_size=12, block_size=1024, gradient_accumulation_steps=5 * 8,
        max_iters=600000, lr_decay_iters=600000, eval_interval=1000,
        eval_iters=200, log_interval=10, weight_decay=1e-1,
    ),
    "eval_gpt2": dict(batch_size=8, eval_iters=500, eval_only=True,
                      wandb_log=False, init_from="gpt2"),
    "eval_gpt2_medium": dict(batch_size=8, eval_iters=500, eval_only=True,
                             wandb_log=False, init_from="gpt2-medium"),
    "eval_gpt2_large": dict(batch_size=8, eval_iters=500, eval_only=True,
                            wandb_log=False, init_from="gpt2-large"),
    "eval_gpt2_xl": dict(batch_size=8, eval_iters=500, eval_only=True,
                         wandb_log=False, init_from="gpt2-xl"),
}


def render(name: str, config: dict) -> str:
    lines = [f"# experiment config: {name} (value parity with ref nanoGPT/config/{name}.py)"]
    for k, v in config.items():
        lines.append(f"{k} = {v!r}")
    return "\n".join(lines) + "\n"


def main(out_dir: str = HERE) -> int:
    for name, config in CONFIGS.items():
        with open(os.path.join(out_dir, f"{name}.py"), "w") as f:
            f.write(render(name, config))
    print(f"wrote {len(CONFIGS)} configs to {out_dir}")
    return len(CONFIGS)


if __name__ == "__main__":
    main()
