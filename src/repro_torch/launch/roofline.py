"""Roofline report: turn dry-run JSONL records into the EXPERIMENTS.md
§Roofline table (three terms, bottleneck, MODEL_FLOPS ratio, suggestion).
Port of ``src/repro/launch/roofline.py``: the same report over the port's
records, with the H100 SXM's constants (``launch/hlo_analysis.py``)."""
from __future__ import annotations

import argparse
import json
import pathlib
from collections import OrderedDict

from repro_torch.launch.hlo_analysis import HBM_BW, LINK_BW, PEAK_FLOPS

SUGGESTIONS = {
    "compute": ("already compute-bound: raise useful-FLOP fraction "
                "(less remat recompute, fewer padded matmuls)"),
    "memory": ("cut HBM traffic: fuse/tile attention (Pallas flash kernel), "
               "seq-shard activations, bf16 collectives"),
    "collective": ("cut link traffic: gather bf16 (not fp32) params, "
                   "2D-shard so gathers shrink, overlap collectives "
                   "with compute"),
}


def load(paths):
    recs = []
    for p in paths:
        for line in pathlib.Path(p).read_text().splitlines():
            if line.strip():
                recs.append(json.loads(line))
    # newest record per (mesh, arch, shape) wins
    dedup = OrderedDict()
    for r in recs:
        if r.get("skipped"):
            continue
        dedup[(r["mesh"], r["arch"], r["shape"])] = r
    return list(dedup.values())


def fmt_row(r):
    rf = r["roofline"]
    return (f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {rf['compute_s']:.3g} | {rf['memory_s']:.3g} "
            f"| {rf['collective_s']:.3g} | {rf['bottleneck']} "
            f"| {rf['roofline_fraction']:.2f} "
            f"| {r['useful_flops_ratio']:.2f} "
            f"| {r['memory']['argument_size_in_bytes']/2**30:.1f} "
            f"| {r['memory']['temp_size_in_bytes']/2**30:.1f} |")


HEADER = ("| arch | shape | mesh | compute (s) | memory (s) | collective (s) "
          "| bottleneck | roofline frac | useful-FLOP ratio | args GiB/dev "
          "| temps GiB/dev |\n"
          "|---|---|---|---|---|---|---|---|---|---|---|")


def report(recs, mesh_filter=None):
    lines = [HEADER]
    for r in sorted(recs, key=lambda r: (r["mesh"], r["arch"], r["shape"])):
        if mesh_filter and r["mesh"] != mesh_filter:
            continue
        lines.append(fmt_row(r))
    return "\n".join(lines)


def summarize(recs):
    out = []
    by_bn = {}
    for r in recs:
        by_bn.setdefault(r["roofline"]["bottleneck"], []).append(r)
    for bn, rs in sorted(by_bn.items()):
        out.append(f"- **{bn}-bound**: {len(rs)} cells — {SUGGESTIONS[bn]}")
    worst = sorted(recs, key=lambda r: r["roofline"]["roofline_fraction"])[:5]
    out.append("- worst roofline fractions: " + ", ".join(
        f"{r['arch']}/{r['shape']}@{r['mesh']}"
        f"={r['roofline']['roofline_fraction']:.2f}" for r in worst))
    most_coll = sorted(recs, key=lambda r: -(r["roofline"]["collective_s"]
                                             / max(sum((r["roofline"]["compute_s"],
                                                        r["roofline"]["memory_s"],
                                                        r["roofline"]["collective_s"])),
                                                   1e-12)))[:5]
    out.append("- most collective-bound: " + ", ".join(
        f"{r['arch']}/{r['shape']}@{r['mesh']}" for r in most_coll))
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("jsonl", nargs="+")
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args()
    recs = load(args.jsonl)
    print(f"# Roofline (H100 SXM constants: {PEAK_FLOPS/1e12:.0f} TFLOP/s, "
          f"{HBM_BW/1e9:.0f} GB/s HBM, {LINK_BW/1e9:.0f} GB/s NVLink)\n")
    print(report(recs, args.mesh))
    print()
    print(summarize(recs))


if __name__ == "__main__":
    main()
