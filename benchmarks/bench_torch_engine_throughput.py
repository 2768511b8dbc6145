"""Engine fast-path throughput on the PyTorch port: batched prefill, ragged
decode, paged-KV capacity and batch occupancy, on one GPU.

The port's counterpart of ``benchmarks/bench_engine_throughput.py``, function
for function, at the reference's traffic (``MAX_LEN`` 96, prompts from
``template_tokens``), on full-width Phi-4-mini 3.8B with random bf16 weights
drawn on the card from seed 0 (the reference runs the reduced model on the
CPU):

* **prefill tokens/s**: one bucketed ``prefill_many`` pass over a queue
  against the sequential batch-1 loop; the gated point is depth 16 with
  prompts of 12-16 tokens, and a full run adds ``parity_d8`` (depth 8,
  33-48 tokens), ungated;
* **decode tokens/s** at full occupancy (4 slots) for every impl:
  ``sdpa`` and ``paged_sdpa`` (the plain paths), ``pallas`` (the dense CUDA
  decode kernel) and ``paged`` (the paged CUDA decode kernel);
* **paged-KV capacity** at equal KV bytes: requests a 24-page pool admits
  against the 4 slots of the dense layout, KV bytes committed per active
  request, the pool's utilization at capacity, the decode rate of
  ``paged_sdpa`` against ``sdpa`` at matched width (the gated ratio), the
  same for the kernel pair ``paged`` against ``pallas`` (reported, not
  gated), and the pool-utilization histogram of a length-skewed flood;
* **batch occupancy**: the per-tick active-slot histogram of a 2 x 2-slot
  cluster flood.

Every timed callable ends in ``torch.cuda.synchronize()``, so a batched
pass is timed to its end on the card's queue; walls are host clock, best of
N, as in the reference.  The kernels are built before anything is timed.

Output: CSV rows on stdout and ``reports/benchmarks/BENCH_torch_engine.json``
(with the card's ``nvidia-smi`` name and power limit under ``device``).
``--check BASELINE`` enforces the reference's three gates (batched prefill
>= 2x sequential, paged capacity >= 2x dense, paged rate >= 0.9x dense) and
fails on a drop of more than 2x of a ratio or rate against the baseline;
``benchmarks/BENCH_torch_engine_baseline.json`` holds a card run.

    PYTHONPATH=src python -m benchmarks.bench_torch_engine_throughput \\
        [--smoke] [--check FILE]

Without a CUDA device it raises: nothing falls back to the CPU.  The row
functions take ``(model, params, cfg, device)``, so a caller that holds a
model passes it in (``chip_smoke.py`` phase 15 on the card; the CPU test
with the reduced model on ``device="cpu"``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from benchmarks.common import emit, save_json
from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.radix import BLOCK_SIZE
from repro_torch.models import Model
from repro_torch.serving.disagg import DisaggregatedCluster, ServeRequest
from repro_torch.serving.engine import (DecodeEngine, PrefillEngine,
                                        kv_token_bytes)
from repro_torch.serving.workload import template_tokens

MODEL_NAME = "phi4-mini-3.8b"
MAX_LEN = 96
MIN_PREFILL_SPEEDUP = 2.0      # batched >= 2x sequential at depth >= 4
MIN_PAGED_CAPACITY = 2.0       # >= 2x concurrent slots at equal KV-pool
                               # bytes on short requests
MIN_PAGED_RATE = 0.9           # <= 10% tokens/s cost at matched batch
                               # width


def _build_model(device):
    """Full-width ``MODEL_NAME`` with bf16 weights drawn on ``device`` from
    seed 0."""
    cfg = get_config(MODEL_NAME)
    model = Model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        torch.bfloat16, device=device)
    return cfg, model, params


def _sync(device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _device_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``cpu``."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _queue(cfg, depth: int, lo: int, hi: int):
    """depth distinct prompts with lengths ramping lo..hi inside one
    padded bucket, so the batched pass exercises real ragged padding."""
    out = []
    for i in range(depth):
        n = lo + ((hi - lo) * i) // max(depth - 1, 1)
        toks = [t % cfg.vocab_size for t in template_tokens(i, n)]
        out.append(toks)
    return out


def _best_of(fn, repeats: int) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _decode_windows(dec, steps: int, device) -> float:
    """Best of 3 windows of ``steps`` decode ticks, every slot live in each
    tick (a window that loses a slot raises)."""
    slots = dec.num_slots
    wall = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(steps):
            n = len(dec.step())
            if n != slots:
                raise RuntimeError(f"{dec.decode_impl}: {n} of {slots} "
                                   f"slots live inside a timed window")
        _sync(device)
        wall = min(wall, time.perf_counter() - t0)
    return wall


def _prefill_point(model, params, cfg, device, label: str, depth: int,
                   lo: int, hi: int, repeats: int) -> dict:
    """Batched vs sequential prompt passes over one queue of ``depth``
    requests.  Prefix cache off: every repeat measures cold compute."""
    prompts = _queue(cfg, depth, lo, hi)
    tokens = sum(len(p) for p in prompts)
    eng = PrefillEngine(model, params, max_len=MAX_LEN, cache_entries=0,
                        max_batch=depth, device=device)
    lengths = sorted(set(len(p) for p in prompts))
    eng.warmup(lengths, batch_sizes=[1, depth])

    def batched():
        eng.prefill_many([(p, None, None) for p in prompts])
        _sync(device)

    def sequential():
        for p in prompts:
            eng.prefill(p)
        _sync(device)

    batched()                      # shake out any remaining first-call cost
    sequential()
    wall_b = _best_of(batched, repeats)
    wall_s = _best_of(sequential, repeats)
    out = {
        "depth": depth,
        "prompt_lengths": [lo, hi],
        "prompt_tokens": tokens,
        "batched_tokens_per_s": tokens / wall_b,
        "sequential_tokens_per_s": tokens / wall_s,
        "batched_speedup": wall_s / wall_b,
        "batches": eng.stats.batches,
        "padded_tokens": eng.stats.padded_tokens,
    }
    emit(f"bench_torch_engine_prefill_{label}", wall_b / depth * 1e6,
         f"depth={depth};lens={lo}..{hi};"
         f"tok_per_s_batched={out['batched_tokens_per_s']:,.0f};"
         f"tok_per_s_seq={out['sequential_tokens_per_s']:,.0f};"
         f"speedup={out['batched_speedup']:.2f}x")
    return out


def bench_prefill(model, params, cfg, device, smoke: bool) -> dict:
    """The gated point batches one-block prompts at depth 16; full runs
    add the parity-scenario scale (depth 8, 33-48 tokens), ungated."""
    repeats = 3 if smoke else 5
    out = {"gated": _prefill_point(model, params, cfg, device, "short_d16",
                                   depth=16, lo=12, hi=16,
                                   repeats=repeats)}
    out["batched_speedup"] = out["gated"]["batched_speedup"]
    if not smoke:
        out["parity_scale"] = _prefill_point(model, params, cfg, device,
                                             "parity_d8", depth=8,
                                             lo=33, hi=48, repeats=repeats)
    return out


def bench_decode(model, params, cfg, device, steps: int) -> dict:
    """Decode tokens/s at full occupancy, per attention impl: the plain
    paths ``sdpa`` and ``paged_sdpa`` and the CUDA kernels ``pallas`` (dense)
    and ``paged``.  The paged engines run the default pool (the dense worst
    case), the same KV bytes as the dense layout at this slot count."""
    slots = 4
    prompts = _queue(cfg, slots, 33, 48)
    pre = PrefillEngine(model, params, max_len=MAX_LEN, cache_entries=0,
                        device=device)
    bundles = []
    for p in prompts:
        logits, caches = pre.prefill(p)
        bundles.append((p, int(logits.argmax()), caches))
    out = {}
    for impl in ("sdpa", "pallas", "paged_sdpa", "paged"):
        dec = DecodeEngine(model, params, num_slots=slots, max_len=MAX_LEN,
                           decode_impl=impl, device=device)
        if dec.paged:
            # run every table width growth can widen to once, so the timed
            # window never pays a width's first launch
            dec.warmup(table_widths=dec.width_ladder())
        else:
            dec.warmup()
        for i, (p, first, caches) in enumerate(bundles):
            dec.admit(i, f"d{i}", caches, first, prompt_len=len(p),
                      max_new=MAX_LEN, hashes=())
        dec.step()                 # the first stepped shape
        wall = _decode_windows(dec, steps, device)
        out[impl] = {"tokens_per_s_per_slot": steps / wall,
                     "tokens_per_s": steps * slots / wall}
        emit(f"bench_torch_engine_decode_{impl}", wall / steps / slots * 1e6,
             f"slots={slots};tok_per_s_per_slot="
             f"{out[impl]['tokens_per_s_per_slot']:,.1f}")
    return out


def bench_paged_capacity(model, params, cfg, device, smoke: bool) -> dict:
    """Concurrency at equal KV bytes.  The dense layout commits
    ``num_slots x max_len`` rows up front, so 4 slots cost 24 pages and
    admit exactly 4 requests however short they are.  A pool of those 24
    pages admits short requests (16-token prompt, 4 output tokens: a
    2-page worst case) until the pool gate binds; plus the KV bytes each
    request commits, the matched-width decode rates, and the pool's
    utilization histogram under a length-skewed flood through the
    cluster."""
    dense_slots = 4
    pre = PrefillEngine(model, params, max_len=MAX_LEN, cache_entries=0,
                        device=device)
    short = [t % cfg.vocab_size for t in template_tokens(0, 16)]
    logits, caches = pre.prefill(short)
    first = int(logits.argmax())

    pool_pages = dense_slots * (MAX_LEN // BLOCK_SIZE)
    dec = DecodeEngine(model, params, num_slots=16, max_len=MAX_LEN,
                       decode_impl="paged_sdpa", num_pages=pool_pages,
                       device=device)
    admitted = 0
    while True:
        slot = dec.free_slot()
        if slot is None or not dec.can_admit(len(short), 4):
            break
        dec.admit(slot, f"c{admitted}", caches, first,
                  prompt_len=len(short), max_new=4, hashes=())
        admitted += 1
    capacity_ratio = admitted / dense_slots
    # bytes committed per active request: the paged pool charges mapped
    # pages; the dense layout charges every slot's full max_len rows
    paged_bytes_per_req = dec.kv_bytes_held() / max(admitted, 1)
    dense_bytes_per_req = MAX_LEN * kv_token_bytes(model)

    # rates at matched batch width on short requests whose worst case
    # keeps tables narrow: the paged engine attends over its mapped pages,
    # the dense layout over its committed max_len rows.  The plain pair
    # (same `_sdpa` math on both sides) is the gated ratio; the kernel
    # pair (the paged against the dense CUDA kernel) is reported beside it
    rate_prompts = _queue(cfg, dense_slots, 16, 16)
    rate_bundles = []
    for p in rate_prompts:
        lg, cc = pre.prefill(p)
        rate_bundles.append((p, int(lg.argmax()), cc))
    steps, rates = (8 if smoke else 12), {}
    for impl, pages in (("sdpa", None), ("paged_sdpa", pool_pages),
                        ("pallas", None), ("paged", pool_pages)):
        d = DecodeEngine(model, params, num_slots=dense_slots,
                         max_len=MAX_LEN, decode_impl=impl,
                         num_pages=pages, device=device)
        if d.paged:
            d.warmup(table_widths=d.width_ladder(16 + 40 + 1))
        else:
            d.warmup()
        for i, (p, f, c) in enumerate(rate_bundles):
            d.admit(i, f"r{i}", c, f, prompt_len=len(p), max_new=40,
                    hashes=())
        d.step()
        rates[impl] = steps * dense_slots / _decode_windows(d, steps, device)
    rate_ratio = rates["paged_sdpa"] / rates["sdpa"]
    kernel_rate_ratio = rates["paged"] / rates["pallas"]
    emit("bench_torch_engine_paged_rate_ratio", rate_ratio * 100,
         f"paged_sdpa/sdpa={rate_ratio:.3f} at matched slots="
         f"{dense_slots} (gate ≥ {MIN_PAGED_RATE});"
         f"paged/pallas={kernel_rate_ratio:.3f} (kernels, not gated)")
    out = {
        "pool_pages": pool_pages,
        "dense_slots": dense_slots,
        "paged_admitted": admitted,
        "capacity_ratio": capacity_ratio,
        "rate_ratio": rate_ratio,
        "kernel_rate_ratio": kernel_rate_ratio,
        "decode_tokens_per_s": dict(rates),
        "kv_hbm_bytes_per_active_request": paged_bytes_per_req,
        "dense_kv_hbm_bytes_per_request": dense_bytes_per_req,
        "pool_utilization_at_capacity": dec.pool_utilization(),
    }
    emit("bench_torch_engine_paged_capacity", admitted,
         f"pool_pages={pool_pages};admitted={admitted};"
         f"vs_dense={dense_slots};ratio={capacity_ratio:.1f}x (gate ≥ "
         f"{MIN_PAGED_CAPACITY});"
         f"kv_bytes_per_req={paged_bytes_per_req:,.0f}"
         f"/{dense_bytes_per_req:,.0f}")

    # length-skewed flood (mostly short, some near-max_len prompts)
    # through the cluster: how full the pool runs under the
    # reservation-gated admission path
    n_requests = 6 if smoke else 12
    cluster = DisaggregatedCluster(
        model, params, num_decode=1, slots_per_worker=6, max_len=MAX_LEN,
        adaptive=False, decode_impl="paged_sdpa", num_pages=12,
        device=device)
    for i in range(n_requests):
        n = 48 if i % 4 == 3 else 16            # 3:1 short:long skew
        toks = [t % cfg.vocab_size for t in template_tokens(i % 8, n)]
        cluster.submit(ServeRequest(f"u{i}", toks, max_new_tokens=4))
    cluster.run_until_done()
    hist = {}
    for tick in cluster.pool_utilization:
        for u in tick:
            key = f"{min(int(u * 10), 9) / 10:.1f}"
            hist[key] = hist.get(key, 0) + 1
    utils = [u for tick in cluster.pool_utilization for u in tick]
    out["flood"] = {
        "requests": n_requests,
        "pool_pages": 12,
        "utilization_histogram": dict(sorted(hist.items())),
        "mean_pool_utilization": sum(utils) / max(len(utils), 1),
        "peak_pool_utilization": max(utils, default=0.0),
    }
    emit("bench_torch_engine_pool_utilization",
         out["flood"]["mean_pool_utilization"] * 100,
         f"requests={n_requests};mean="
         f"{out['flood']['mean_pool_utilization']:.2f};"
         f"peak={out['flood']['peak_pool_utilization']:.2f}")
    return out


def bench_occupancy(model, params, cfg, device, n_requests: int) -> dict:
    """Flood a 2-worker x 2-slot cluster and histogram the per-tick total
    active slots: how full continuous batching runs under backpressure."""
    cluster = DisaggregatedCluster(model, params, num_decode=2,
                                   slots_per_worker=2, max_len=MAX_LEN,
                                   adaptive=False, device=device)
    for i in range(n_requests):
        n = 33 + (15 * i) // max(n_requests - 1, 1)
        toks = [t % cfg.vocab_size for t in template_tokens(i % 8, n)]
        cluster.submit(ServeRequest(f"o{i}", toks, max_new_tokens=4))
    t0 = time.perf_counter()
    cluster.run_until_done()
    _sync(device)
    wall = time.perf_counter() - t0
    totals = [sum(occ) for occ in cluster.occupancy]
    hist = {}
    for t in totals:
        hist[str(t)] = hist.get(str(t), 0) + 1
    capacity = 4
    busy = [t for t in totals if t > 0]
    out = {
        "requests": n_requests,
        "wall_s": wall,
        "ticks": len(totals),
        "histogram": dict(sorted(hist.items())),
        "mean_active_slots": sum(totals) / max(len(totals), 1),
        "mean_busy_fill": (sum(busy) / len(busy) / capacity) if busy else 0.0,
        "prefill_batches": cluster.prefill.stats.batches,
        "prefill_batched_requests": cluster.prefill.stats.batched_requests,
    }
    emit("bench_torch_engine_occupancy", wall / max(n_requests, 1) * 1e6,
         f"requests={n_requests};mean_active={out['mean_active_slots']:.2f};"
         f"busy_fill={out['mean_busy_fill']:.2f};"
         f"batched_requests={out['prefill_batched_requests']}")
    return out


def _flatten(payload: dict, prefix: str = "") -> dict:
    flat = {}
    for k, v in payload.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, f"{key}."))
        elif isinstance(v, (int, float)):
            flat[key] = float(v)
    return flat


def check_regression(payload: dict, baseline_path: str,
                     factor: float = 2.0) -> list:
    """Hard gates: batched prefill >= MIN_PREFILL_SPEEDUP, paged capacity
    >= MIN_PAGED_CAPACITY and paged rate >= MIN_PAGED_RATE (same-machine
    ratios).  Baseline gates: ratio and rate metrics may not be
    ``factor``x lower than the committed baseline; occupancy and counters
    are informational."""
    failures = []
    speedup = payload["prefill"]["batched_speedup"]
    if speedup < MIN_PREFILL_SPEEDUP:
        failures.append(f"prefill.batched_speedup: {speedup:.2f} < "
                        f"required {MIN_PREFILL_SPEEDUP}x")
    capacity = payload["paged"]["capacity_ratio"]
    if capacity < MIN_PAGED_CAPACITY:
        failures.append(f"paged.capacity_ratio: {capacity:.2f} < "
                        f"required {MIN_PAGED_CAPACITY}x")
    rate = payload["paged"]["rate_ratio"]
    if rate < MIN_PAGED_RATE:
        failures.append(f"paged.rate_ratio: {rate:.3f} < "
                        f"required {MIN_PAGED_RATE}")
    with open(baseline_path) as f:
        base = _flatten(json.load(f))
    cur = _flatten(payload)
    for key, ref in base.items():
        if key not in cur or ref <= 0:
            continue
        leaf = key.rsplit(".", 1)[-1]
        if leaf.startswith(("batched_speedup", "tokens_per_s",
                            "tokens_per_s_per_slot",
                            "batched_tokens_per_s",
                            "sequential_tokens_per_s", "mean_busy_fill",
                            "capacity_ratio", "rate_ratio")):
            if cur[key] < ref / factor:
                failures.append(f"{key}: {cur[key]:.2f} < baseline "
                                f"{ref:.2f} / {factor}")
    return failures


def rows(model, params, cfg, device, smoke: bool = False) -> dict:
    """Every row of the bench on ``model`` and ``params`` (on ``device``)."""
    return {
        "mode": "smoke" if smoke else "full",
        "model": cfg.name,
        "device": _device_line(device),
        "prefill": bench_prefill(model, params, cfg, device, smoke=smoke),
        # window sizing: 3 windows must finish before the longest prompt
        # (48 tokens) walks into the max_len=96 stop condition
        "decode": bench_decode(model, params, cfg, device,
                               steps=8 if smoke else 14),
        "occupancy": bench_occupancy(model, params, cfg, device,
                                     n_requests=8 if smoke else 16),
        "paged": bench_paged_capacity(model, params, cfg, device,
                                      smoke=smoke),
    }


def run(smoke: bool = False, device=None) -> dict:
    """Build the kernels, then full-width ``MODEL_NAME`` on ``device``
    (``cuda`` when None; raises without a card), run every row and write
    the report."""
    device = resolve_device(device)
    if device.type == "cuda":
        from repro_torch.kernels import build
        build.build_all()
    cfg, model, params = _build_model(device)
    payload = rows(model, params, cfg, device, smoke=smoke)
    save_json("BENCH_torch_engine", payload)
    return payload


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="reduced depths/steps (a quick guard, not a "
                         "measurement)")
    ap.add_argument("--check", default=None, metavar="BASELINE",
                    help="enforce the prefill/paged-capacity/paged-rate "
                         "gates and fail on >2x regression vs this "
                         "baseline JSON")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    payload = run(smoke=args.smoke)
    print(f"# {payload['device']}", file=sys.stderr)
    if args.check:
        failures = check_regression(payload, args.check)
        if failures:
            print("REGRESSION vs baseline:", file=sys.stderr)
            for f in failures:
                print(f"  {f}", file=sys.stderr)
            sys.exit(1)
        print(f"# regression check vs {args.check}: ok", file=sys.stderr)


if __name__ == "__main__":
    main()
