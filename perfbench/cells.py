"""A cell of ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix, one metric
or one cell's limits is a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py`` and ``limits/<cell>.json``. A configuration's
reference is ``reference/<config>.py`` where it has one of its own, and
``reference/policy.py`` otherwise.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file: source, reduced, assumed and ``config``
    traffic: dict
    end_to_end: list[dict]  # the BENCHMARK.json entries of the metrics it reports
    per_layer: list[dict]
    limits: dict[str, float]
    reference: ModuleType  # the configuration's reference (``reference/__init__.py``)

    @property
    def mode(self) -> str:
        return self.traffic["mode"]

    @property
    def batch(self) -> int:
        train = self.config["config"]["train"]
        return train["batch_size_train" if self.mode == "train" else "batch_size_test"]


def _read(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str, reported: set[str] | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def load(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``."""
    bench = _read(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(cells)}")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name=name, chips=int(w["chips"]),
                config=_read(HERE / "configs" / f"{w['config']}.json"),
                traffic=_read(HERE / "traffic" / f"{w['traffic']}.json"),
                end_to_end=e2e, per_layer=per_layer,
                limits=_read(HERE / "limits" / f"{name}.json"),
                reference=reference(w["config"]))


def _module(path: Path, module_name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    return _module(HERE / "metrics" / f"{metric}.py",
                   "perfbench_metric_" + metric.replace(".", "_")).read


def reference(config: str) -> ModuleType:
    """The reference of the configuration ``config``: ``reference/<config>.py``
    where that file exists, ``reference/policy.py`` otherwise."""
    path = HERE / "reference" / f"{config}.py"
    if not path.is_file():
        path = HERE / "reference" / "policy.py"
    return _module(path, "perfbench_reference_" + path.stem.replace(".", "_").replace("-", "_"))
