"""Find a configuration, a cell or a per-layer metric by its name.

``configs/<name>.json``, ``workloads/<cell>.json`` and ``metrics/<name>.py``
under this directory, and ``BENCHMARK.json`` one level up.  A later change
adds a configuration, a cell or a metric by adding its file and its entry;
nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def check_name(name: str) -> str:
    """``name`` when it is a name of the contract (letters, digits, ``_``,
    ``.``, ``-``; at most 64; not starting with ``.`` or ``-``), else
    ``ValueError``: a name never reaches a path unchecked."""
    if not isinstance(name, str) or NAME.fullmatch(name) is None:
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(folder: str, name: str) -> dict:
    path = HERE / folder / f"{check_name(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder[:-1]} named {name!r} ({path})")
    data = json.loads(path.read_text())
    if data.get("name") != name:
        raise ValueError(f"{path} holds {data.get('name')!r}, not {name!r}")
    return data


def load_config(name: str) -> dict:
    return _json("configs", name)


def load_workload(name: str) -> dict:
    return _json("workloads", name)


def load_metric(name: str):
    """The module of ``metrics/<name>.py``; its ``read(ctx)`` gives the value
    or None."""
    path = HERE / "metrics" / f"{check_name(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no metric named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"esbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_benchmark() -> dict:
    return json.loads(BENCHMARK.read_text())


def cell_entry(bench: dict, cell: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"BENCHMARK.json has no cell {cell!r}")


def _applies(metric: dict, cell: str, reported: set[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def cell_metrics(bench: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """The end-to-end and the per-layer metrics a cell reports: those that
    list it under ``workloads``, or list none (a per-layer metric without
    the key: where its ``moves`` metric is reported)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, cell, reported)]
    return e2e, per_layer
