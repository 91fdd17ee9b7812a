"""Minimal pipeline framework: the Kedro-shell replacement.

The reference wraps everything in a Kedro project whose only real content is
a pipeline registry, an OmegaConf config loader, a YAML data catalog, and a
single identity pipeline (ref: src/ai_music_generation/settings.py:26-29,
pipeline_registry.py:9-17, pipelines/data_processing/pipeline.py:4-21,
conf/base/catalog.yaml:46-52). This module provides the same orchestration
surface without the kedro dependency:

- :class:`Node` / :class:`Pipeline`: named, dependency-ordered callables over
  a dict-style data catalog;
- :func:`register_pipelines`: auto-discovery of ``create_pipeline()`` in
  ``project/pipelines/*`` packages, with ``__default__`` as the sum of all
  (same contract as kedro's ``find_pipelines``);
- :class:`DataCatalog`: YAML catalog with csv/json/text/midi dataset types;
- ``python -m ai_music_generation_tpu_torch run [--pipeline NAME]`` entry point.

The port's copy of ``ai_music_generation_tpu/project/framework.py``:
``register_pipelines`` discovers the port's ``project/pipelines`` and the
catalog reads MIDI through the port's ``codec/midi_io.py``
(tests/test_torch_project_shell.py).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import pkgutil
from typing import Any, Callable, Iterable, Optional


@dataclasses.dataclass
class Node:
    func: Callable
    inputs: list[str]
    outputs: list[str]
    name: str = ""

    def run(self, catalog: "DataCatalog") -> None:
        args = [catalog.load(i) for i in self.inputs]
        result = self.func(*args)
        if len(self.outputs) == 1:
            result = (result,)
        elif len(self.outputs) > 1:
            # a non-sequence (or wrong-arity) return must fail loudly —
            # zip() over a string/DataFrame silently scattered its ELEMENTS
            # across the output datasets (review finding)
            if not isinstance(result, (tuple, list)) or len(result) != len(self.outputs):
                raise ValueError(
                    f"node {self.name!r} declares {len(self.outputs)} outputs "
                    f"but returned {type(result).__name__}")
        for out_name, value in zip(self.outputs, result or ()):
            catalog.save(out_name, value)


def node(func, inputs, outputs, name="") -> Node:
    if isinstance(inputs, str):
        inputs = [inputs]
    if isinstance(outputs, str):
        outputs = [outputs]
    return Node(func, list(inputs or []), list(outputs or []), name or func.__name__)


class Pipeline:
    def __init__(self, nodes: Iterable[Node]):
        self.nodes = list(nodes)

    def __add__(self, other: "Pipeline") -> "Pipeline":
        return Pipeline(self.nodes + other.nodes)

    def run(self, catalog: "DataCatalog") -> None:
        # a catalog-registered FILE dataset that some node in this pipeline
        # produces is NOT available until that node runs — treating it as
        # available ran consumers first (or fed them a stale file from a
        # previous execution)
        will_produce = {o for nd in self.nodes for o in nd.outputs}
        produced = set(catalog.keys()) - will_produce

        def available(i: str) -> bool:
            return i in produced or i == "parameters" or i.startswith("params:")

        pending = list(self.nodes)
        while pending:
            ready = [n for n in pending if all(available(i) for i in n.inputs)]
            if not ready:
                missing = {i for n in pending for i in n.inputs} - produced
                raise RuntimeError(f"pipeline stuck; missing inputs: {sorted(missing)}")
            for n in ready:
                print(f"Running node: {n.name}")
                n.run(catalog)
                produced.update(n.outputs)
                pending.remove(n)


def pipeline(nodes: Iterable[Node]) -> Pipeline:
    return Pipeline(nodes)


class DataCatalog:
    """YAML-described datasets + in-memory entries + ``params:`` lookups.

    Parameters follow the kedro contract the reference's shell configures but
    never uses (ref: settings.py:26-29, conf/base/paramaters.yaml): a node
    input named ``params:a.b`` resolves to ``parameters["a"]["b"]``.
    """

    def __init__(
        self,
        entries: Optional[dict] = None,
        base_path: str = ".",
        parameters: Optional[dict] = None,
    ):
        self.entries = entries or {}
        self.base_path = base_path
        self.parameters = parameters or {}
        self._memory: dict[str, Any] = {}

    @classmethod
    def from_yaml(
        cls, path: str, parameters_path: Optional[str] = None
    ) -> "DataCatalog":
        entries = _load_simple_yaml(path)
        base = os.path.dirname(os.path.abspath(path))
        if parameters_path is None:
            candidate = os.path.join(base, "parameters.yaml")
            parameters_path = candidate if os.path.exists(candidate) else None
        params = _load_simple_yaml(parameters_path) if parameters_path else {}
        return cls(entries, base_path=base, parameters=params)

    def keys(self):
        return set(self.entries) | set(self._memory)

    def _resolve_param(self, name: str):
        value: Any = self.parameters
        if name != "parameters":  # bare "parameters" = the whole dict
            for part in name.removeprefix("params:").split("."):
                if not isinstance(value, dict) or part not in value:
                    raise KeyError(f"parameter {name!r} not in parameters.yaml")
                value = value[part]
        return value

    def _filepath(self, spec: dict) -> str:
        fp = spec.get("filepath", "")
        if not os.path.isabs(fp):
            # catalog paths are relative to the project root (conf/../..)
            fp = os.path.normpath(os.path.join(self.base_path, "..", "..", fp))
        return fp

    def load(self, name: str):
        if name == "parameters" or name.startswith("params:"):
            return self._resolve_param(name)
        if name in self._memory:
            return self._memory[name]
        spec = self.entries.get(name)
        if spec is None:
            raise KeyError(f"dataset {name!r} not in catalog")
        dtype = spec.get("type", "text")
        fp = self._filepath(spec)
        if dtype.endswith("CSVDataset") or dtype == "csv":
            import pandas as pd

            return pd.read_csv(fp)
        if dtype.endswith("JSONDataset") or dtype == "json":
            with open(fp) as f:
                return json.load(f)
        if dtype == "midi":
            from ai_music_generation_tpu_torch.codec import midi_io

            return midi_io.parse_midi_file(fp)
        with open(fp) as f:
            return f.read()

    def save(self, name: str, value) -> None:
        spec = self.entries.get(name)
        if spec is None:
            self._memory[name] = value
            return
        dtype = spec.get("type", "text")
        fp = self._filepath(spec)
        os.makedirs(os.path.dirname(fp), exist_ok=True)
        if dtype.endswith("CSVDataset") or dtype == "csv":
            value.to_csv(fp, index=False)
        elif dtype.endswith("JSONDataset") or dtype == "json":
            with open(fp, "w") as f:
                json.dump(value, f, indent=2)
        elif dtype == "midi":
            from ai_music_generation_tpu_torch.codec import midi_io

            midi_io.write_midi_file(value, fp)
        else:
            with open(fp, "w") as f:
                f.write(str(value))


def _load_simple_yaml(path: str) -> dict:
    """Tiny two-level YAML subset loader (catalog files only use
    ``name:\\n  key: value`` blocks). Falls back to pyyaml when present."""
    try:
        import yaml  # type: ignore

        with open(path) as f:
            return yaml.safe_load(f) or {}
    except ImportError:
        pass
    entries: dict[str, dict] = {}
    current: Optional[str] = None
    with open(path) as f:
        for raw in f:
            line = raw.split("#")[0].rstrip()
            if not line.strip():
                continue
            if not raw.startswith(" ") and line.endswith(":"):
                current = line[:-1].strip()
                entries[current] = {}
            elif current is not None and ":" in line:
                k, v = line.strip().split(":", 1)
                entries[current][k.strip()] = _coerce_scalar(v.strip())
    return entries


def _coerce_scalar(v: str):
    """YAML scalar typing for the pyyaml-less fallback — without this,
    ``drop_duplicates: false`` reaches nodes as the truthy string 'false'."""
    if v and v[0] in "\"'":
        return v.strip("\"'")
    low = v.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "~", ""):
        return None
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def register_pipelines() -> dict[str, Pipeline]:
    """Auto-discover ``create_pipeline()`` under project/pipelines/*
    (ref contract: pipeline_registry.py:9-17)."""
    import ai_music_generation_tpu_torch.project.pipelines as pkg

    pipelines: dict[str, Pipeline] = {}
    for mod_info in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"{pkg.__name__}.{mod_info.name}.pipeline")
        if hasattr(mod, "create_pipeline"):
            pipelines[mod_info.name] = mod.create_pipeline()
    default = Pipeline([])
    for p in pipelines.values():
        default = default + p
    pipelines["__default__"] = default
    return pipelines
