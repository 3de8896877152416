"""Finding a cell's files by name.

``BENCHMARK.json`` at the checkout's root names each cell's
configuration and traffic mix; their files are
``configs/<config>.json`` and ``traffic/<traffic>.json`` under the
benchmark's directory, a metric's reader is ``metrics/<metric>.py``, a
span point ``spans/<span>.json`` (installed only where a metric the cell
reports names it in its ``SPANS``) and a cell's limits for ``correct``
``limits/<workload>.json``.  Adding a cell, a configuration, a mix, a
metric or a span adds files and entries; no code changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]       # the benchmark directory


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list                 # metric entries the cell reports
    per_layer: list
    limits: dict
    root: Path


def _load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(workload: str, bench_json: Path, root: Path = HERE) -> Cell:
    spec = _load_json(bench_json)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_json}")
    w = cells[workload]
    cfg = _load_json(root / "configs" / f"{w['config']}.json")
    cfg["name"] = w["config"]
    tr = _load_json(root / "traffic" / f"{w['traffic']}.json")
    tr["name"] = w["traffic"]
    return Cell(
        name=workload, config=cfg, traffic=tr, chips=int(w["chips"]),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, workload)],
        limits=_load_json(root / "limits" / f"{workload}.json"),
        root=root)


def metric_reader(name: str, root: Path = HERE):
    """The module ``metrics/<name>.py``: ``compute(run) -> float | None``,
    and ``SPANS``, the span points it reads (none if it has no such
    name)."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "tebench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def span_points(metrics: list, root: Path = HERE) -> dict:
    """{span name: {"on": dotted path from the Pipeline, "method": ...,
    "clock": "host" | "sync" | "cuda"}} of the span points that the
    given metric entries' readers name in ``SPANS``, from
    ``spans/<name>.json``."""
    names = set()
    for m in metrics:
        names.update(getattr(metric_reader(m["name"], root), "SPANS", ()))
    return {n: _load_json(root / "spans" / f"{n}.json") for n in sorted(names)}
