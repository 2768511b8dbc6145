"""Backend parity on the PyTorch port: the analytic simulator against the
port's engine backend, on one GPU at full width.

The port's counterpart of ``benchmarks/bench_backend_parity.py``, with its
three measurements, all driven through the shared ControlPlane:

1. **Router-decision agreement**: each ``parity-*`` scenario, at its
   registered length, on both backends; the share of identical (worker,
   overlap) decisions (must be 1.0), whether the regime sequences are
   equal, PoA-hat on both sides, and the engine's TTFT p50/p99.
2. **Warm vs cold prefill**: the prefill engine's prefix cache on a
   warm-heavy stream against the same stream with the cache off; prefill
   FLOPs and wall time must both drop.
3. **Cache-affinity routing vs round-robin on TTFT**: the same warm-heavy
   stream under KV routing and under round-robin, with a 10 ms per-block
   transfer charge; affinity must win on mean charged TTFT.

Measurements 2 and 3 run their two sides in turns (a, b, b, a, ...; 10
pairs, 2 with ``--smoke``), since the host clock drifts between runs by
as much as the differences measured, and report how many pairs each side
won beside the pooled ratio the gate reads.

    PYTHONPATH=src python benchmarks/bench_torch_backend_parity.py \\
        [--json reports/backend_parity.json]
    PYTHONPATH=src python benchmarks/bench_torch_backend_parity.py \\
        --device cpu --reduced --smoke        # a CPU smoke run

By default it builds full-width Phi-4-mini 3.8B (random bf16 weights from
seed 0) on ``cuda`` and prints the card's name and power limit; without a
CUDA device it exits non-zero.  ``--reduced`` takes the reduced config,
``--smoke`` two scenarios and shorter streams.  Times from a CPU run say
nothing about the card.  Exits 1 if a gate fails.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def decision_agreement(model, params, smoke):
    from repro_torch.serving.scenarios import build_backend, parity_scenarios
    names = parity_scenarios()[:2] if smoke else parity_scenarios()
    out = {}
    for name in names:
        sim = build_backend(name, backend="analytic", seed=0)
        res_a = sim.run()
        reqs_a = sorted(res_a.completed, key=lambda r: r.rid)
        dec_a = [(r.rid, r.decode_worker, round(r.overlap, 12))
                 for r in reqs_a]
        poa_a = [p["poa"] for p in res_a.poll_log if p["poa"] == p["poa"]]
        eng = build_backend(name, backend="engine", seed=0, model=model,
                            params=params)
        t0 = time.perf_counter()
        res_e = eng.run()        # its last step copies tokens to the host
        wall = time.perf_counter() - t0
        dec_e = [(i, w, round(ov, 12)) for i, w, ov in res_e.decisions]
        poa_e = eng.cluster.poa.current_poa(eng.cluster._now())
        # surplus decisions on either side count as disagreement
        agree = sum(a == b for a, b in zip(dec_a, dec_e)) \
            / max(len(dec_a), len(dec_e), 1)
        ttft = [r.ttft for r in res_e.requests]
        out[name] = dict(
            n=len(dec_a), agreement=agree,
            regimes_equal=([(a, b) for _, a, b in sim.detector.transitions]
                           == [(a, b) for _, a, b in
                               res_e.regime_transitions]),
            analytic_poa_mean=(sum(poa_a) / len(poa_a)) if poa_a else None,
            engine_poa=poa_e if poa_e == poa_e else None,
            reused_blocks=res_e.prefill_stats["reused_blocks"],
            total_blocks=res_e.prefill_stats["total_blocks"],
            ttft_p50_s=_pct(ttft, 0.5), ttft_p99_s=_pct(ttft, 0.99),
            wall_s=wall)
        print(f"agreement {name}: {agree:.3f} over {len(dec_a)} decisions, "
              f"regimes equal {out[name]['regimes_equal']}, TTFT p50 "
              f"{out[name]['ttft_p50_s'] * 1e3:.2f} ms p99 "
              f"{out[name]['ttft_p99_s'] * 1e3:.2f} ms, run {wall:.2f} s")
    return out


def in_turns(run, labels, rounds):
    """``run(label)`` in turns a, b, b, a, a, b, ... (``rounds`` pairs),
    so drift of the host clock falls on both sides alike; returns each
    label's results in order, pair k being the k-th of each."""
    out = {label: [] for label in labels}
    for i in range(rounds):
        for label in (labels if i % 2 == 0 else labels[::-1]):
            out[label].append(run(label))
    return out


def paired(a, b):
    """How often ``a`` is below ``b`` pair by pair, with both medians and
    the interquartile spread of ``a``."""
    q = statistics.quantiles(a, n=4) if len(a) > 1 else [a[0]] * 3
    return dict(wins=sum(x < y for x, y in zip(a, b)), pairs=len(a),
                median=statistics.median(a), other_median=statistics.median(b),
                iqr=q[2] - q[0])


def warm_vs_cold(model, params, device, smoke):
    """A warm-heavy two-template stream, prefix cache on against off, in
    turns: FLOPs drop by construction (suffix-only compute), and wall time
    must drop too."""
    from repro_torch.serving.engine import PrefillEngine
    n_prompt = 192 if smoke else 384
    reps = 6 if smoke else 12
    vocab = model.cfg.vocab_size
    stream = [[(tpl * 1_000_003 + 7 * i) % vocab for i in range(n_prompt)]
              for tpl in ((0, 1) * reps)]

    def run(label):
        eng = PrefillEngine(model, params, max_len=n_prompt + 8,
                            cache_entries=16 if label == "warm" else 0,
                            device=device)
        eng.warmup([n_prompt], suffix_lengths=[1])
        for toks in stream:
            eng.prefill(toks)      # ends in the logits' copy to the host
        return eng.stats.as_dict()
    runs = in_turns(run, ("warm", "cold"), 2 if smoke else 10)
    cold, warm = runs["cold"][0], runs["warm"][0]
    walls = {k: [r["wall_s"] for r in v] for k, v in runs.items()}
    flops_ratio = warm["flops"] / max(cold["flops"], 1e-9)
    wall_ratio = sum(walls["warm"]) / max(sum(walls["cold"]), 1e-9)
    pairs = paired(walls["warm"], walls["cold"])
    print(f"warm vs cold prefill ({len(stream)} prompts of {n_prompt}, "
          f"{pairs['pairs']} pairs in turns): flops ratio "
          f"{flops_ratio:.3f}, wall ratio {wall_ratio:.3f}, warm faster in "
          f"{pairs['wins']} of {pairs['pairs']} pairs, median run warm "
          f"{pairs['median'] * 1e3:.1f} ms (IQR "
          f"{pairs['iqr'] * 1e3:.1f}) cold {pairs['other_median'] * 1e3:.1f}"
          f" ms, resumed {warm['reused_blocks']}/{warm['total_blocks']} "
          f"blocks")
    return dict(cold=cold, warm=warm, walls=walls, flops_ratio=flops_ratio,
                wall_ratio=wall_ratio, pairs=pairs)


def kv_vs_round_robin(model, params, smoke):
    """A 3-cycle template stream on 2 workers: round-robin smears each
    template across the pool, so affinity's saved KV movement (charged at
    10 ms a block, a cross-node hop) shows against it.  The two policies
    run in turns, each run a fresh cluster."""
    from repro_torch.serving.scenarios import build_backend
    n = 15 if smoke else 27

    def run(policy):
        res = build_backend("parity-2d-warm", backend="engine", seed=0,
                            model=model, params=params, n=n,
                            templates=(0, 1, 0), routing_policy=policy,
                            kv_transfer_per_block=0.010).run()
        return dict(mean_ttft=statistics.mean(res.ttfts()),
                    mean_transfer_charge=statistics.mean(
                        r.transfer_charge for r in res.requests),
                    transferred_blocks=sum(res.transferred_blocks),
                    reused_blocks=res.prefill_stats["reused_blocks"])
    runs = in_turns(run, ("kv", "round_robin"), 2 if smoke else 10)
    out = {policy: dict(
        mean_ttft=statistics.mean(r["mean_ttft"] for r in rs),
        run_mean_ttft=[r["mean_ttft"] for r in rs],
        mean_transfer_charge=rs[0]["mean_transfer_charge"],
        transferred_blocks=rs[0]["transferred_blocks"],
        reused_blocks=rs[0]["reused_blocks"]) for policy, rs in runs.items()}
    kv, rr = out["kv"], out["round_robin"]
    out["rr_over_kv_mean_ttft"] = rr["mean_ttft"] / max(kv["mean_ttft"],
                                                       1e-9)
    out["pairs"] = pairs = paired(kv["run_mean_ttft"], rr["run_mean_ttft"])
    print(f"kv vs round-robin ({n} requests, {pairs['pairs']} pairs in "
          f"turns): mean charged TTFT kv {kv['mean_ttft'] * 1e3:.2f} ms "
          f"({kv['transferred_blocks']} blocks moved, transfer charge "
          f"{kv['mean_transfer_charge'] * 1e3:.2f} ms), rr "
          f"{rr['mean_ttft'] * 1e3:.2f} ms ({rr['transferred_blocks']} "
          f"blocks, {rr['mean_transfer_charge'] * 1e3:.2f} ms), rr/kv "
          f"{out['rr_over_kv_mean_ttft']:.3f}x, kv faster in "
          f"{pairs['wins']} of {pairs['pairs']} pairs, median run kv "
          f"{pairs['median'] * 1e3:.2f} ms (IQR {pairs['iqr'] * 1e3:.2f}) "
          f"rr {pairs['other_median'] * 1e3:.2f} ms")
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config instead of full width")
    ap.add_argument("--smoke", action="store_true",
                    help="two scenarios and shorter streams")
    ap.add_argument("--json", type=Path, help="write the results here")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench_torch_backend_parity: needs a CUDA device (or "
              "--device cpu)", file=sys.stderr)
        return 2

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models import Model

    cfg = (get_reduced if args.reduced else get_config)("phi4-mini-3.8b")
    model = Model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0),
                        torch.bfloat16, device)
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    else:
        card = "cpu (no device metric)"
    print(f"card: {card}; model {cfg.name} {cfg.num_layers}L "
          f"d={cfg.d_model}, bf16")
    payload = dict(
        card=card, model=cfg.name, layers=cfg.num_layers,
        agreement=decision_agreement(model, params, args.smoke),
        warm_vs_cold=warm_vs_cold(model, params, device, args.smoke),
        kv_vs_rr=kv_vs_round_robin(model, params, args.smoke))
    ok = (all(v["agreement"] == 1.0 and v["regimes_equal"]
              for v in payload["agreement"].values())
          and payload["warm_vs_cold"]["flops_ratio"] < 1.0
          and payload["warm_vs_cold"]["wall_ratio"] < 1.0
          and payload["kv_vs_rr"]["rr_over_kv_mean_ttft"] > 1.0)
    payload["ok"] = ok
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(payload, indent=1))
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
