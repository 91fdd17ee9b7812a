"""The int8 KV cache's quality on a trained model: the port of
``docs/experiments/int8_quality.py``.

    python -m ai_music_generation_tpu_torch.experiments.int8_quality \\
        [--work_dir=studies_out] [--device=cuda] [--reuse]

The bench widths (6L/6H/384d, block 256) with MHA, trained on the
measure-random corpus at batch 32 for 1,500 iterations
(``decode_studies.measure_random_checkpoint``; gqa_quality's KH=6 is the
same training), decoded with a bf16 cache and with the int8 cache (K1 in
each mode):

(a) token agreement of the two caches' 64 conditioned 200-token
    generations (same prompts, seed 42);
(b) the teacher NLL of each set under the trained model (all-position
    logits, fp32 log-softmax, generated positions only);
(c) the structural metrics of each set through the eval pipeline without
    WAVs (inner and conditioned similarities);
(d) each cache's tokens/s at ``--batch`` (4096) x
    8-token random prompts, 500 new tokens (CUDA events).

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import os

from ai_music_generation_tpu_torch.experiments import decode_studies as ds

CACHES = ("bf16", "int8")


def throughput(models: dict, sizes: ds.Sizes) -> dict:
    """Each model's tokens/s at the bench shape (its own Generator)."""
    from ai_music_generation_tpu_torch.decode.generate import Generator

    out = {}
    for name, model in models.items():
        gen = Generator(model, max_new_tokens=sizes.new,
                        temperature=ds.TEMPERATURE, top_k=ds.TOP_K)
        out[name] = ds.timed_generate(
            gen, ds.random_prompts(model.config.vocab_size, sizes.batch, 0),
            sizes.reps, seed=0)
        ds.free(model.transformer.wte.weight.device)
    return out


def run(work_dir: str, sizes: ds.Sizes = ds.Sizes(), device: str = "cuda",
        reuse: bool = False) -> dict:
    trained = ds.measure_random_checkpoint(work_dir, sizes, device, reuse,
                                           n_kv_head=0)
    models = {"bf16": ds.variant(trained, kv_quantized=False),
              "int8": ds.variant(trained, kv_quantized=True)}
    del trained["model"]
    meta = ds.load_dataset_meta(trained["dataset"])
    prompts = ds.conditioned_prompts(trained["tunes"], meta["stoi"],
                                     sizes.n_gen, sizes.prompt)
    gens = {name: ds.quality_generations(m, prompts, sizes.gen_new)
            for name, m in models.items()}
    score = models["bf16"]
    result = dict(
        study="int8_quality", device=device,
        train=ds.train_summary(trained), n_gen=len(prompts),
        agreement=ds.agreement(gens["bf16"], gens["int8"], sizes.prompt),
        teacher_nll={name: ds.teacher_nll(score, g, sizes.prompt)
                     for name, g in gens.items()},
        structural={name: ds.structural_metrics(
            ds.write_abc(g, meta["itos"],
                         os.path.join(work_dir, f"int8_abc_{name}")),
            os.path.join(work_dir, f"int8_eval_{name}"), device)
            for name, g in gens.items()})
    result["throughput"] = throughput(models, sizes)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ds.add_common_flags(ap)
    args, sizes = ds.parse(ap, argv)
    return ds.print_result(run(args.work_dir, sizes, args.device,
                               args.reuse))


if __name__ == "__main__":
    main()
