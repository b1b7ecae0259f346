"""Finding a cell's files by name: `BENCHMARK.json` at the root of the
checkout, `configs/<config>.json`, `workloads/<cell>.json`,
`phases/<phase>.py` and `metrics/<metric>.py` beside this file. A file added
there is picked up by its name, with no edit elsewhere.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def workload(name: str, here: Path = HERE) -> dict:
    return _json(here / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase(name: str) -> ModuleType:
    """The phase module `phases/<name>.py`."""
    return importlib.import_module(f"{__package__}.phases.{name}")


def metric_reader(name: str, here: Path = HERE) -> ModuleType:
    """The per-layer reader `metrics/<name>.py` (its name may hold dots)."""
    return _module(here / "metrics" / f"{name}.py",
                   f"{__package__}.metrics." + name.replace(".", "_"))


def applies(metric: dict, cell: str) -> bool:
    """A metric without a `workloads` list is every cell's."""
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if applies(m, cell)]


def per_layer(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["per_layer"] if applies(m, cell)]

