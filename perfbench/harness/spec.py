"""What a cell is, read from files by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix; ``configs/<config>.json``, ``traffic/<mix>.json`` and
``limits/<workload>.json`` under this benchmark's folder hold the rest.  A
new cell is a new entry and new files: nothing here names a cell.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent

# The registry config's fields and the published keys that must equal them.
WIDTH_KEYS = {
    "num_hidden_layers": "num_layers",
    "hidden_size": "d_model",
    "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads",
    "head_dim": "head_dim",
    "intermediate_size": "d_ff",
    "vocab_size": "vocab_size",
    "rope_theta": "rope_theta",
    "rms_norm_eps": "norm_eps",
}
ACTIVATIONS = {"silu": "swiglu", "relu2": "squared_relu"}


@dataclass
class Cell:
    workload: str
    chips: int
    config: dict                 # configs/<config>.json
    traffic: dict                # traffic/<mix>.json
    limits: dict                 # limits/<workload>.json
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)

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
                manifest["end_to_end"], manifest["per_layer"])


def registry_mismatches(config: dict, cfg) -> List[str]:
    """Where the program's registry config ``cfg`` departs from the widths
    in ``config`` (empty when they agree).  Keeps a later edit of the
    program's config file from moving the yardstick unseen."""
    model = config["model"]
    out = []
    for key, attr in WIDTH_KEYS.items():
        want = model[key]
        have = getattr(cfg, attr)
        if attr == "head_dim":
            have = cfg.resolved_head_dim
        if float(have) != float(want):
            out.append(f"{key}: file {want}, program {have}")
    act = ACTIVATIONS.get(model["hidden_act"], model["hidden_act"])
    if cfg.activation != act:
        out.append(f"hidden_act: file {model['hidden_act']}, "
                   f"program {cfg.activation}")
    return out


def model_config(config: dict, registry: Optional[object] = None):
    """The program's ``ModelConfig`` for ``config``, from its registry, held
    to the file's widths (raises where they differ)."""
    if registry is None:
        from repro_torch.configs import get_config
        registry = get_config(config["registry"])
    bad = registry_mismatches(config, registry)
    if bad:
        raise ValueError(f"{config['name']}: the program's registry config "
                         f"differs from the benchmark's: {bad}")
    return registry
