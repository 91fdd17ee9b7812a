"""The port's project shell (``project/``, ``__main__.py``) on the cases of
tests/test_project_shell.py, the registered pipelines against the JAX
package's, and ``python -m ai_music_generation_tpu_torch run`` in a fresh
interpreter over the repository's shared ``conf/base`` catalog.
"""

import glob
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from ai_music_generation_tpu.__main__ import main as jax_main
from ai_music_generation_tpu.project import framework as jax_framework
from ai_music_generation_tpu_torch.__main__ import main
from ai_music_generation_tpu_torch.data.memmap import BinDataset
from ai_music_generation_tpu_torch.project.framework import (
    DataCatalog,
    Pipeline,
    node,
    register_pipelines,
)
from ai_music_generation_tpu_torch.train.trainer import DEFAULTS
from ai_music_generation_tpu_torch.utils.configurator import apply_overrides

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_pipeline_dependency_order():
    catalog = DataCatalog()
    catalog.save("a", 1)
    calls = []

    def add_one(x):
        calls.append("add_one")
        return x + 1

    def double(x):
        calls.append("double")
        return x * 2

    # declared out of order: runner must topologically order them
    Pipeline([
        node(double, "b", "c", name="double"),
        node(add_one, "a", "b", name="add_one"),
    ]).run(catalog)
    assert calls == ["add_one", "double"]
    assert catalog.load("c") == 4


def test_pipeline_missing_input():
    with pytest.raises(RuntimeError, match="missing inputs"):
        Pipeline([node(lambda x: x, "nope", "out")]).run(DataCatalog())


def test_register_pipelines_equals_jax():
    """The same pipeline names, and each node's name, inputs and outputs;
    the port's nodes are the port's functions."""
    pipelines = register_pipelines()
    jax_pipelines = jax_framework.register_pipelines()
    assert sorted(pipelines) == sorted(jax_pipelines) == [
        "__default__", "data_processing"]
    for name, p in pipelines.items():
        assert [(n.name, n.inputs, n.outputs) for n in p.nodes] == [
            (n.name, n.inputs, n.outputs) for n in jax_pipelines[name].nodes]
        assert all(n.func.__module__.startswith(
            "ai_music_generation_tpu_torch.") for n in p.nodes)
    assert len(pipelines["__default__"].nodes) >= 1


def _project(root, rows="x,y\n1,2\n3,4\n", drop="false"):
    """tests/test_project_shell.py's project layout under ``root``."""
    (root / "conf" / "base").mkdir(parents=True)
    (root / "data" / "01_raw").mkdir(parents=True)
    (root / "data" / "01_raw" / "test-run-data.csv").write_text(rows)
    (root / "conf" / "base" / "catalog.yaml").write_text(
        "test_run_data:\n  type: csv\n  filepath: data/01_raw/test-run-data.csv\n"
        "processed_data:\n  type: csv\n"
        "  filepath: data/02_preprocessed/out.csv\n")
    (root / "conf" / "base" / "parameters.yaml").write_text(
        f"data_processing:\n  drop_duplicates: {drop}\n")


@pytest.mark.parametrize("drop", ["false", "true"])
def test_catalog_yaml_and_cli_equal_jax(tmp_path, monkeypatch, capsys, drop):
    """``main(["run", ...])`` in a project directory writes what the JAX
    entry point writes, and prints the same lines."""
    out = {}
    for side, fn in (("jax", jax_main), ("port", main)):
        root = tmp_path / side
        _project(root, rows="x,y\n1,2\n1,2\n3,4\n", drop=drop)
        monkeypatch.chdir(root)
        fn(["run", "--pipeline", "data_processing"])
        out[side] = ((root / "data" / "02_preprocessed" / "out.csv")
                     .read_text(), capsys.readouterr().out)
    assert out["port"] == out["jax"]
    assert "1,2" in out["port"][0]
    assert out["port"][0].count("1,2") == (1 if drop == "true" else 2)


def test_unknown_pipeline_exits_as_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as jax_exit:
        jax_main(["run", "--pipeline", "nope"])
    with pytest.raises(SystemExit) as port_exit:
        main(["run", "--pipeline", "nope"])
    assert str(port_exit.value) == str(jax_exit.value)
    assert "available: ['__default__', 'data_processing']" in str(
        port_exit.value)


def test_catalog_params_injection(tmp_path, monkeypatch):
    """parameters.yaml values reach nodes via params: inputs (kedro contract)."""
    root = tmp_path
    (root / "conf" / "base").mkdir(parents=True)
    (root / "data" / "01_raw").mkdir(parents=True)
    (root / "data" / "01_raw" / "t.csv").write_text("x,y\n1,2\n1,2\n3,4\n")
    (root / "conf" / "base" / "catalog.yaml").write_text(
        "test_run_data:\n  type: csv\n  filepath: data/01_raw/t.csv\n")
    (root / "conf" / "base" / "parameters.yaml").write_text(
        "data_processing:\n  drop_duplicates: true\n")
    monkeypatch.chdir(root)
    catalog = DataCatalog.from_yaml(str(root / "conf" / "base" /
                                        "catalog.yaml"))
    assert catalog.load("params:data_processing.drop_duplicates") in (
        True, "true")
    assert "data_processing" in catalog.load("parameters")
    with pytest.raises(KeyError, match="not in parameters.yaml"):
        catalog.load("params:nope")
    register_pipelines()["data_processing"].run(catalog)
    assert len(catalog.load("processed_data")) == 2


def test_simple_yaml_fallback_equals_jax(tmp_path, monkeypatch):
    """Without pyyaml both loaders read the same two-level subset, scalars
    typed alike."""
    path = tmp_path / "c.yaml"
    path.write_text("# a comment\na:\n  type: csv  # trailing\n  n: 3\n"
                    "  f: 0.5\n  yes_: yes\n  off_: off\n  none: ~\n"
                    "  q: 'quoted'\nb:\n  filepath: data/x.json\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    from ai_music_generation_tpu_torch.project import framework

    got = framework._load_simple_yaml(str(path))
    assert got == jax_framework._load_simple_yaml(str(path))
    assert got["a"] == {"type": "csv", "n": 3, "f": 0.5, "yes_": True,
                        "off_": False, "none": None, "q": "quoted"}


@pytest.mark.parametrize("dtype,value,suffix", [
    ("json", {"a": [1, 2]}, "json"), ("text", "some text", "txt"),
    ("midi", None, "mid")])
def test_catalog_file_datasets_equal_jax(tmp_path, dtype, value, suffix):
    """save then load of each file type writes the JAX catalog's bytes; the
    MIDI dataset goes through the port's own midi_io."""
    if dtype == "midi":
        from ai_music_generation_tpu_torch.codec.score import score_to_midi
        from ai_music_generation_tpu_torch.data.chorales import (
            synthesize_chorale,
        )

        value = score_to_midi(synthesize_chorale(4))
    files = {}
    for side, cls in (("jax", jax_framework.DataCatalog),
                      ("port", DataCatalog)):
        fp = str(tmp_path / side / f"x.{suffix}")
        catalog = cls({"x": {"type": dtype, "filepath": fp}},
                      base_path=str(tmp_path))
        catalog.save("x", value)
        with open(fp, "rb") as f:
            files[side] = f.read()
        loaded = catalog.load("x")
    assert files["port"] == files["jax"]
    if dtype == "midi":
        assert type(loaded).__module__ == \
            "ai_music_generation_tpu_torch.codec.midi_io"
        assert loaded.notes == value.notes
    else:
        assert loaded == value


def test_all_experiment_configs_apply_cleanly():
    """Every config of the port uses only known trainer keys."""
    configs = glob.glob(os.path.join(
        ROOT, "ai_music_generation_tpu_torch", "configs", "*.py"))
    configs = [c for c in configs
               if "generate_configs" not in c and "__init__" not in c]
    assert len(configs) == 26
    for path in configs:
        merged = apply_overrides(dict(DEFAULTS), [path])
        assert merged["batch_size"] > 0


def test_configurator_rejects_bool_for_int():
    with pytest.raises(TypeError, match="bool"):
        apply_overrides({"n_layer": 12}, ["--n_layer=True"])
    assert apply_overrides({"flag": True}, ["--flag=False"])["flag"] is False
    assert apply_overrides({"lr": 1e-3}, ["--lr=1"])["lr"] == 1.0


def test_bin_dataset_samples_last_window(tmp_path):
    path = tmp_path / "train.bin"
    np.arange(10, dtype=np.uint16).tofile(path)
    ds = BinDataset(str(path))
    draws = np.concatenate([
        ds.global_indices(seed=1, it=i, n=64, block_size=4) for i in range(8)
    ])
    assert draws.max() == 10 - 4 - 1 and draws.min() == 0


def test_pipeline_runs_producer_before_consumer(tmp_path):
    order = []
    catalog = DataCatalog(
        {"inter": {"type": "text.TextDataset",
                   "filepath": str(tmp_path / "inter.txt")}},
        base_path=str(tmp_path))

    def producer():
        order.append("producer")
        return "payload"

    def consumer(x):
        order.append("consumer")
        assert x == "payload"

    Pipeline([
        node(consumer, inputs=["inter"], outputs=[], name="c"),
        node(producer, inputs=[], outputs="inter", name="p"),
    ]).run(catalog)
    assert order == ["producer", "consumer"]

    def bad():
        return "xy"  # one value for two outputs

    with pytest.raises(ValueError, match="2 outputs"):
        Pipeline([node(bad, inputs=[], outputs=["a", "b"], name="bad")]).run(
            DataCatalog({}))


def test_python_dash_m_run_over_the_shared_catalog(tmp_path):
    """``python -m ai_music_generation_tpu_torch run`` in a fresh
    interpreter, in a copy of the repository's ``conf/`` and
    ``data/01_raw/``: exit 0, the JAX entry point's CSV and lines, and no
    jax, JAX package or torch module loaded."""
    outs = {}
    for side, pkg in (("jax", "ai_music_generation_tpu"),
                      ("port", "ai_music_generation_tpu_torch")):
        root = tmp_path / side
        shutil.copytree(os.path.join(ROOT, "conf"), root / "conf")
        shutil.copytree(os.path.join(ROOT, "data", "01_raw"),
                        root / "data" / "01_raw")
        code = (f"import runpy, sys\nsys.argv = ['{pkg}', 'run']\n"
                f"runpy.run_module('{pkg}', run_name='__main__')\n"
                "print(sorted({m.split('.')[0] for m in sys.modules} & "
                "{'jax', 'torch', 'ai_music_generation_tpu', "
                "'ai_music_generation_tpu_torch'}))\n")
        proc = subprocess.run(
            [sys.executable, "-c", code], cwd=root, capture_output=True,
            text=True, timeout=120,
            env={**os.environ, "PYTHONPATH": ROOT})
        assert proc.returncode == 0, proc.stderr
        outs[side] = ((root / "data" / "02_preprocessed" /
                       "processed-test-run-data.csv").read_bytes(),
                      proc.stdout.splitlines()[:-1],
                      proc.stdout.splitlines()[-1])
    assert outs["port"][:2] == outs["jax"][:2]
    assert "pipeline '__default__' completed" in outs["port"][1]
    assert outs["port"][2] == "['ai_music_generation_tpu_torch']"
    proc = subprocess.run(
        [sys.executable, "-m", "ai_music_generation_tpu_torch", "run",
         "--pipeline", "data_processing"], cwd=tmp_path / "port",
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == [
        "Running node: process_data_node",
        "pipeline 'data_processing' completed"]
