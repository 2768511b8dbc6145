"""What a cell is, read from files by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix; ``configs/<config>.json``, ``traffic/<mix>.json`` and
``limits/<workload>.json`` under this benchmark's folder hold the rest.  A
new cell is a new entry and new files: nothing here names a cell.

A configuration may name its architecture (``"architecture": "<name>"``,
the module ``architectures/<name>.py``; ``architectures.DEFAULT`` without
the key) and the program's config (``"program": {"config":
"<module>:<attr>"}``, the module under ``repro_torch``; without it the
config comes from the program's registry by ``"registry"``).  Every model
family of the port is built by its one ``Model`` class.
"""
from __future__ import annotations

import importlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent

@dataclass
class Cell:
    workload: str
    chips: int
    config: dict                 # configs/<config>.json
    traffic: dict                # traffic/<mix>.json
    limits: dict                 # limits/<workload>.json
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)
    bench_dir: Path = BENCH_DIR  # where its architecture's module lies

    @property
    def deployment(self) -> dict:
        return self.traffic["deployment"]

    def metric_names(self, trace: bool) -> List[str]:
        """The metrics this cell reports: its end-to-end metrics untraced,
        its per-layer metrics traced; a metric with a ``workloads`` list
        only in the cells it names."""
        group = self.per_layer if trace else self.end_to_end
        return [m["name"] for m in group
                if self.workload in m.get("workloads", [self.workload])]


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: Path = ROOT) -> dict:
    return _read(root / "BENCHMARK.json")


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    manifest = load_manifest(root)
    entry = next((w for w in manifest["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        names = [w["name"] for w in manifest["workloads"]]
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {names}")
    bench = Path(root) / BENCH_DIR.name
    config = _read(bench / "configs" / f"{entry['config']}.json")
    traffic = _read(bench / "traffic" / f"{entry['traffic']}.json")
    limits = _read(bench / "limits" / f"{workload}.json")
    return Cell(workload, int(entry["chips"]), config, traffic, limits,
                manifest["end_to_end"], manifest["per_layer"], bench)


def _import(ref: str):
    """The object ``"<module>:<attr>"`` names, the module under the
    program's package ``repro_torch``."""
    module, _, attr = ref.partition(":")
    if module.split(".")[0] != "repro_torch" or not attr:
        raise ValueError(f"{ref!r}: a program entry is '<module>:<attr>' "
                         "with the module under repro_torch")
    return getattr(importlib.import_module(module), attr)


def program_config(config: dict):
    """The program's config for ``config``: its ``"program"``'s
    ``"config"`` where given, else ``registry`` through the program's
    registry."""
    ref = config.get("program", {}).get("config")
    if ref is not None:
        return _import(ref)
    from repro_torch.configs import get_config
    return get_config(config["registry"])


def model_config(config: dict, arch, registry: Optional[object] = None):
    """The program's config for ``config`` (``registry`` stands in for
    it), held to the file's ``model`` by its architecture ``arch``
    (raises where they differ)."""
    if registry is None:
        registry = program_config(config)
    bad = arch.mismatches(config["model"], registry)
    if bad:
        raise ValueError(f"{config['name']}: the program's config differs "
                         f"from the benchmark's: {bad}")
    return registry
