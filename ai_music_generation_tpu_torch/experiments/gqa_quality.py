"""Grouped-query attention's quality on trained models: the port of
``docs/experiments/gqa_quality.py``.

    python -m ai_music_generation_tpu_torch.experiments.gqa_quality \\
        [--work_dir=studies_out] [--device=cuda] [--reuse]

KH=6 (MHA) and KH=2 at the bench widths trained on the identical corpus,
schedule and init seed (``decode_studies.measure_random_checkpoint``: the
KH=6 training is int8_quality's, the KH=2 one the realpath flagship's; a
harness that ran those reuses them with ``--reuse``):

(a) each model's final train and val loss;
(b) 64 conditioned 200-token generations of each (int8 cache, seed 42),
    both sets scored under the KH=6 teacher;
(c) the structural metrics of each set (the eval pipeline without WAVs);
(d) each model's tokens/s at ``--batch`` (4096) x
    8-token random prompts, 500 new tokens, int8 cache (K1 at KH=6 and at
    KH=2).

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import os

from ai_music_generation_tpu_torch.experiments import decode_studies as ds
from ai_music_generation_tpu_torch.experiments.int8_quality import (
    throughput,
)

def run(work_dir: str, sizes: ds.Sizes = ds.Sizes(), device: str = "cuda",
        reuse: bool = False) -> dict:
    models, trains, teacher = {}, {}, None
    for kh in (sizes.n_head, 2):  # MHA (the teacher), then KH=2
        trained = ds.measure_random_checkpoint(
            work_dir, sizes, device, reuse,
            n_kv_head=0 if kh == sizes.n_head else kh)
        trains[kh] = ds.train_summary(trained)
        models[kh] = ds.variant(trained, kv_quantized=True)
        if kh == sizes.n_head:
            teacher = ds.variant(trained, kv_quantized=False)
        del trained["model"]
        ds.free(device)
    meta = ds.load_dataset_meta(trained["dataset"])
    prompts = ds.conditioned_prompts(trained["tunes"], meta["stoi"],
                                     sizes.n_gen, sizes.prompt)
    gens = {kh: ds.quality_generations(m, prompts, sizes.gen_new)
            for kh, m in models.items()}
    result = dict(
        study="gqa_quality", device=device, n_gen=len(prompts),
        train={str(kh): t for kh, t in trains.items()},
        teacher_nll={str(kh): ds.teacher_nll(teacher, g, sizes.prompt)
                     for kh, g in gens.items()},
        structural={str(kh): ds.structural_metrics(
            ds.write_abc(g, meta["itos"],
                         os.path.join(work_dir, f"gqa_abc_kh{kh}")),
            os.path.join(work_dir, f"gqa_eval_kh{kh}"), device)
            for kh, g in gens.items()})
    result["throughput"] = {str(kh): t
                            for kh, t in throughput(models, sizes).items()}
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ds.add_common_flags(ap)
    args, sizes = ds.parse(ap, argv)
    return ds.print_result(run(args.work_dir, sizes, args.device,
                               args.reuse))


if __name__ == "__main__":
    main()
