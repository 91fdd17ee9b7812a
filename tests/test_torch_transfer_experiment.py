"""The port's transfer experiment (``cli/transfer_experiment.py``) against
the JAX package's, and run for real on the CPU.

With both packages' ``cli.train.main`` replaced by a recorder, both
experiments build the same corpora, texts, splits and union-vocab data
(``.bin`` bytes, ``meta.pkl`` unpickled: a pickled dict's bytes are not the
contract) and hand the three legs the same flags, the port adding only
``--device``. Then the port's experiment trains a tiny model on the CPU in
a fresh interpreter in which any import of jax or of the JAX package
fails: three finished legs, finite losses, a transfer leg that resumed.
"""

import json
import math
import os
import pickle
import subprocess
import sys

import pytest
import torch

from ai_music_generation_tpu.cli import train as jax_train
from ai_music_generation_tpu.cli import transfer_experiment as jax_exp
from ai_music_generation_tpu_torch.cli import train
from ai_music_generation_tpu_torch.cli import transfer_experiment as exp

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--n_melodies=12", "--n_chorales=6", "--pretrain_iters=4",
         "--finetune_iters=2", "--seed=3"]


def _recorder(calls, work_dir):
    """A stand-in for ``cli.train.main``: records argv (the work dir as
    ``<w>``) and writes one val loss per leg into its out_dir."""
    def main(argv):
        calls.append([a.replace(work_dir, "<w>") for a in argv])
        out = next(a.split("=", 1)[1] for a in argv
                   if a.startswith("--out_dir="))
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "losses.jsonl"), "a") as f:
            f.write(json.dumps({"iter": 0, "val/loss": 1.0 + len(calls)})
                    + "\n")
        return 1.0
    return main


def _files(root):
    """Every file under ``root`` but the prepared data: relative path ->
    bytes."""
    out = {}
    for base, _, names in os.walk(root):
        for name in names:
            rel = os.path.relpath(os.path.join(base, name), root)
            if not rel.startswith("data" + os.sep):
                with open(os.path.join(root, rel), "rb") as f:
                    out[rel] = f.read()
    return out


def _data(root):
    """The prepared data: each ``.bin``'s bytes, each ``meta.pkl``
    unpickled."""
    out = {}
    for ds in ("melody", "bach"):
        d = os.path.join(root, "data", ds)
        assert sorted(os.listdir(d)) == ["meta.pkl", "train.bin", "val.bin"]
        for name in ("train.bin", "val.bin"):
            with open(os.path.join(d, name), "rb") as f:
                out[ds, name] = f.read()
        with open(os.path.join(d, "meta.pkl"), "rb") as f:
            out[ds, "meta"] = pickle.load(f)
    return out


def test_corpora_data_and_legs_equal_jax(tmp_path, monkeypatch, capsys):
    runs = {}
    for side, mod, train_mod, extra in (
            ("jax", jax_exp, jax_train, []),
            ("port", exp, train, ["--device=cpu"])):
        w = str(tmp_path / side)
        calls = []
        monkeypatch.setattr(train_mod, "main", _recorder(calls, w))
        doc = str(tmp_path / f"{side}.md")
        result = mod.main([f"--work_dir={w}", f"--doc_out={doc}"] + SMALL
                          + extra)
        with open(doc) as f:
            runs[side] = dict(result=result, calls=calls, doc=f.read(),
                              files=_files(w), data=_data(w),
                              printed=capsys.readouterr().out.replace(
                                  w, "<w>"))
    jax, port = runs["jax"], runs["port"]
    assert port["calls"] == [argv + ["--device=cpu"]
                             for argv in jax["calls"]]
    assert [c[:2] for c in port["calls"]] == [
        ["--dataset=melody", "--out_dir=<w>/out_melody"],
        ["--dataset=bach", "--out_dir=<w>/out_transfer"],
        ["--dataset=bach", "--out_dir=<w>/out_scratch"]]
    assert "--init_from=resume" in port["calls"][1]
    assert "--dtype=bfloat16" in port["calls"][0]
    assert port["data"] == jax["data"]
    assert port["data"]["melody", "meta"] == port["data"]["bach", "meta"]
    assert port["files"] == jax["files"]
    assert sum(k.startswith("midi_melody") for k in port["files"]) == 12
    assert sum(k.startswith("text_bach") for k in port["files"]) == 6
    for key in ("result", "doc", "printed"):
        assert port[key] == jax[key], key
    assert port["result"] == {"melody": 2.0, "transfer": 3.0,
                              "scratch": 4.0}


def test_no_card_raises_before_writing(tmp_path, monkeypatch):
    """Without a card and without --device=cpu the experiment raises and
    writes nothing: it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = tmp_path / "exp"
    with pytest.raises(RuntimeError, match="--device=cpu"):
        exp.main([f"--work_dir={w}"] + SMALL)
    assert not w.exists()


GUARDED = """
import importlib.abc, json, math, sys
attempts = []
class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax",
                                  "ai_music_generation_tpu"):
            attempts.append(name)
            raise ImportError(f"the port imported {name}")
sys.meta_path.insert(0, NoJax())
import torch
torch.set_num_threads(1)
from ai_music_generation_tpu_torch.cli.transfer_experiment import main
result = main(sys.argv[1:])
print(json.dumps({"result": result, "attempts": attempts, "loaded": sorted(
    m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "ai_music_generation_tpu"))}))
"""


def test_trains_three_legs_on_the_cpu_without_jax(tmp_path):
    w = tmp_path / "exp"
    proc = subprocess.run(
        [sys.executable, "-c", GUARDED, f"--work_dir={w}", "--device=cpu",
         "--n_layer=1", "--n_head=2", "--n_embd=32", "--block_size=64",
         "--batch_size=4", "--eval_interval=2"] + SMALL,
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-4000:]
    report = json.loads(proc.stdout.splitlines()[-1])
    assert report["attempts"] == [] and report["loaded"] == []
    legs = {}
    for leg in ("melody", "transfer", "scratch"):
        out = w / f"out_{leg}"
        assert (out / "last_iter_ckpt.pt").exists()
        with open(out / "losses.jsonl") as f:
            legs[leg] = [json.loads(line) for line in f]
        assert all(math.isfinite(r["val/loss"]) for r in legs[leg])
        assert report["result"][leg] == min(r["val/loss"] for r in legs[leg])
    assert [r["iter"] for r in legs["melody"]] == [0, 2, 4]
    # the transfer leg resumed at the melody leg's last iteration
    assert [r["iter"] for r in legs["transfer"]] == [4, 6]
    assert [r["iter"] for r in legs["scratch"]] == [0, 2]
    assert "transfer " in proc.stdout and " scratch at equal bach steps" in \
        proc.stdout
