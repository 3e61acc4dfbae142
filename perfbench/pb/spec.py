"""Finding a cell's pieces by name.

``BENCHMARK.json`` (at the root of the checkout) lists the cells; each
cell has a file ``cells/<cell>.json`` that names its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``,
which names its generator ``traffic/<generator>.py``) and its offered
rate; a configuration's ``model_type`` names its family
(``families/<model_type>.py``) and its plain reference
(``reference/<model_type>.py``); each per-layer metric is a reader
``metrics/<metric>.py``.  Nothing here needs an edit when a later
change adds a cell, a mix, a generator, a configuration, a model family
or a metric as new files.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent.parent      # perfbench/


@dataclass
class Cell:
    name: str
    bench: Dict                    # the BENCHMARK.json entry
    cell: Dict                     # cells/<cell>.json
    config: Dict                   # configs/<config>.json
    mix: Dict                      # traffic/<mix>.json
    end_to_end: List[Dict]         # the metrics this cell reports
    per_layer: List[Dict]

    @property
    def config_name(self) -> str:
        return self.bench["config"]


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path) -> Cell:
    """The cell ``name`` of the checkout at ``root``."""
    bench = _json(root / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    cell = _json(HERE / "cells" / f"{name}.json")
    for key in ("config", "traffic"):
        if cell[key] != entry[key]:
            raise ValueError(f"{name}: cells/{name}.json names {key} "
                             f"{cell[key]!r}, BENCHMARK.json {entry[key]!r}")
    return Cell(
        name=name, bench=entry, cell=cell,
        config=_json(HERE / "configs" / f"{entry['config']}.json"),
        mix=_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def load_module(folder: str, name: str):
    """The module ``<folder>/<name>.py`` under ``perfbench/``, loaded from
    its file (a name may hold ``.`` and ``-``)."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder}/{name}.py")
    key = f"pb_{folder}_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> Callable:
    """``read(ctx)`` of ``metrics/<name>.py``: a number, or None where
    the run gave it nothing to read."""
    return load_module("metrics", name).read


# ---------------------------------------------------------------------------
# the configuration as the program runs it
# ---------------------------------------------------------------------------
def family(c: Dict):
    """``families/<model_type>.py`` of a configuration file."""
    return importlib.import_module("families." + c["model_type"])


def model_config(c: Dict, name: str):
    """The program's ``ModelConfig`` for a configuration file."""
    return family(c).model_config(c, name)


def kv_bytes_per_token(c: Dict) -> int:
    """Cache bytes of one token over every layer, bf16."""
    return family(c).kv_bytes_per_token(c)
