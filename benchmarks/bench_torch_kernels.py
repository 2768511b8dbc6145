"""Kernel micro-benchmarks of the PyTorch port: the flash (K3), decode (K1)
and paged decode (K2) attention kernels against their plain versions, on
one GPU.

The port's counterpart of ``benchmarks/bench_kernels.py``, at its shapes:
fp32, H = 8 query heads over K = 2 KV heads of hd = 64, and

* flash: B 1, S = T = 512, causal;
* decode: B 8, T 2048, every length full;
* paged decode: 8 sequences of 8 pages of 16 from a 128-page pool, the page
  table a permutation of the pool drawn from a numpy seed.

Inputs are drawn on the card from a seeded ``torch.Generator``.  For each
kernel it reports:

* ``ms``: the kernel's time as a CUDA-graph replay (``chip_smoke.time_ms``:
  60 launches rotating over input sets that together pass the 50 MB L2,
  timed with CUDA events: device time, without the host's launch time);
* ``plain_ms``: its plain PyTorch version's, the same way;
* ``library_ms``: ``scaled_dot_product_attention``'s on the same inputs (for
  the paged kernel on the pre-gathered view: the gather is left out);
* the reference's work descriptor (``flops`` or ``kv_bytes``), and
  ``bound_ms``: the larger of the bytes the call must move (each input read
  once, each output written once; the paged kernel's pages below its
  lengths) at 3.35 TB/s and its fp32 operations at 67 TFLOP/s, with
  ``bound_by``;
* ``max_abs_err`` against the plain version on the first set, every element
  held to 2e-5 (atol and rtol, ``chip_smoke.TOL``): ``agrees``.

The reference's ``--compiled`` switch has no counterpart: the kernel always
runs on the card.  Output: CSV rows on stdout and
``reports/benchmarks/bench_torch_kernels.json``.

    PYTHONPATH=src python -m benchmarks.bench_torch_kernels

Needs a CUDA device (without one it raises); exits 1 if a kernel disagrees
with its plain version.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from benchmarks.common import emit, save_json
from repro_torch import resolve_device

ROOT = Path(__file__).resolve().parents[1]
H, KH, HD = 8, 2, 64
DTYPE = torch.float32
FLASH_B, FLASH_S = 1, 512
DECODE_B, DECODE_T = 8, 2048
PAGED_B, BLOCK, POOL_PAGES, PER_SEQ = 8, 16, 128, 8
TABLE_SEED = 7
# input sets of one timing: together past the 50 MB L2, at most one a launch
L2_PASS_BYTES, REPS = 150_000_000, 60


def _sets(make, per_set_bytes: int):
    n = min(REPS, max(4, -(-L2_PASS_BYTES // per_set_bytes)))
    return [make() for _ in range(n)]


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _held(out, want, tol):
    """(max |out - want|, whether every element is within tol + tol|want|)."""
    err = (out.float() - want.float()).abs()
    ok = bool(torch.isfinite(out).all()) and \
        bool((err <= tol + tol * want.float().abs()).all())
    return float(err.max()), ok


def _record(cs, kernel, plain, library, sets, lib_sets, moved, ops):
    """One kernel's record: held on the first set, then timed."""
    peaks = cs.peaks()
    tol = cs.TOL["float32"]
    err, ok = _held(kernel(*sets[0]), plain(*sets[0]), tol)
    bytes_ms = moved / peaks.HBM_BW * 1e3
    ops_ms = ops / peaks.FP32_FLOPS * 1e3
    return dict(
        ms=cs.time_ms(torch, kernel, sets),
        plain_ms=cs.time_ms(torch, plain, sets),
        library_ms=cs.time_ms(torch, library, lib_sets),
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        max_abs_err=err, tol=tol, agrees=ok, dtype="float32")


def bench_flash(cs, gen) -> dict:
    from repro_torch.kernels.flash_attention import ops as fops

    b, s = FLASH_B, FLASH_S

    def make():
        return tuple(torch.randn(shape, generator=gen, device="cuda",
                                 dtype=DTYPE)
                     for shape in ((b, s, H, HD), (b, s, KH, HD),
                                   (b, s, KH, HD)))
    per_set = _nbytes(*make()) + b * s * H * HD * 4     # and the output
    sets = _sets(make, per_set)
    lib_sets = [tuple(x.transpose(1, 2) for x in st) for st in sets]

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    pairs = s * (s + 1) // 2                  # causal (query, key) pairs
    rec = _record(cs, fops.flash_attention, fops.flash_attention_plain, sdpa,
                  sets, lib_sets, per_set, 4 * b * H * HD * pairs)
    rec.update(flops=4 * b * s * s * H * HD / 2,
               shape=f"B={b} S=T={s} H={H} K={KH} hd={HD} causal")
    emit("bench_torch_flash_attention", rec["ms"] * 1e3,
         f"plain_us={rec['plain_ms'] * 1e3:.1f};"
         f"sdpa_us={rec['library_ms'] * 1e3:.1f};causal_gqa_{s}x{s}x{H}h")
    return rec


def bench_decode(cs, gen) -> dict:
    from repro_torch.kernels.decode_attention import ops as dops

    b, t = DECODE_B, DECODE_T
    lengths = torch.full((b,), t, dtype=torch.int32, device="cuda")

    def make():
        q = torch.randn((b, H, HD), generator=gen, device="cuda", dtype=DTYPE)
        k, v = (torch.randn((b, t, KH, HD), generator=gen, device="cuda",
                            dtype=DTYPE) for _ in range(2))
        return q, k, v, lengths
    per_set = _nbytes(*make()) + b * H * HD * 4
    sets = _sets(make, per_set)
    lib_sets = [(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2))
                for q, k, v, _ in sets]

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True)
    rec = _record(cs, dops.decode_attention, dops.decode_attention_plain,
                  sdpa, sets, lib_sets, per_set, 4 * b * H * HD * t)
    rec.update(kv_bytes=2 * b * t * KH * HD * 4,
               shape=f"B={b} T={t} H={H} K={KH} hd={HD} lengths={t}")
    emit("bench_torch_decode_attention", rec["ms"] * 1e3,
         f"plain_us={rec['plain_ms'] * 1e3:.1f};"
         f"sdpa_us={rec['library_ms'] * 1e3:.1f};kv_bytes={rec['kv_bytes']}")
    return rec


def bench_paged(cs, gen) -> dict:
    from repro_torch.kernels.paged_attention import ops as pops

    b, n = PAGED_B, POOL_PAGES
    table = torch.as_tensor(
        np.random.default_rng(TABLE_SEED).permutation(n)[:b * PER_SEQ]
        .reshape(b, PER_SEQ), dtype=torch.int32, device="cuda")
    lengths = torch.full((b,), BLOCK * PER_SEQ, dtype=torch.int32,
                         device="cuda")

    def make():
        q = torch.randn((b, H, HD), generator=gen, device="cuda", dtype=DTYPE)
        kp, vp = (torch.randn((n, BLOCK, KH, HD), generator=gen,
                              device="cuda", dtype=DTYPE) for _ in range(2))
        return q, kp, vp, table, lengths
    sets = _sets(make, _nbytes(*make()))
    lib_sets = [(q[:, :, None], pops.gather_pages(kp, table).transpose(1, 2),
                 pops.gather_pages(vp, table).transpose(1, 2))
                for q, kp, vp, _, _ in sets]

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True)
    kv_bytes = 2 * b * PER_SEQ * BLOCK * KH * HD * 4    # the mapped pages
    moved = kv_bytes + _nbytes(sets[0][0], table, lengths) + b * H * HD * 4
    rec = _record(cs, pops.paged_attention, pops.paged_attention_plain, sdpa,
                  sets, lib_sets, moved, 4 * b * H * HD * PER_SEQ * BLOCK)
    rec.update(kv_bytes=kv_bytes,
               shape=f"{b} seqs x {PER_SEQ} pages of {BLOCK} from {n}, "
                     f"H={H} K={KH} hd={HD}")
    emit("bench_torch_paged_attention", rec["ms"] * 1e3,
         f"plain_us={rec['plain_ms'] * 1e3:.1f};"
         f"sdpa_us={rec['library_ms'] * 1e3:.1f};kv_bytes={kv_bytes}")
    return rec


def run() -> dict:
    """Build the kernels, then hold and time each on the card; writes the
    report and returns ``{kernel: record, "device": ...}``."""
    device = resolve_device(None)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build

    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(0)
    results = {"flash_attention": bench_flash(cs, gen),
               "decode_attention": bench_decode(cs, gen),
               "paged_attention": bench_paged(cs, gen),
               "device": cs.gpu_line()}
    torch.cuda.empty_cache()
    save_json("bench_torch_kernels", results)
    return results


def main() -> int:
    results = run()
    print(f"# {results['device']}")
    bad = [name for name, r in results.items()
           if isinstance(r, dict) and not r["agrees"]]
    for name in bad:
        print(f"{name}: disagrees with its plain version (max err "
              f"{results[name]['max_abs_err']:.3g})", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
