"""The metric readers and the yardstick's arithmetic, on runs and traces
built by hand."""
import pytest

import tiny
from harness import readers, work
from harness.load import Request
from harness.serve import Record, Run
from harness.trace import Trace

PHI = {"num_hidden_layers": 32, "hidden_size": 3072,
       "num_attention_heads": 24, "num_key_value_heads": 8, "head_dim": 128,
       "intermediate_size": 8192, "vocab_size": 200064, "hidden_act": "silu"}
MINITRON = dict(PHI, intermediate_size=9216, vocab_size=256000,
                hidden_act="relu2")
DENSE = tiny.dense()


def _rec(rid, due, first=None, times=()):
    r = Record(Request(rid, 10, 4, lambda: [1] * 10, due=due), [1] * 10, due,
               first=first, times=list(times))
    return r


def _run(records, w0=10.0, w1=20.0):
    run = Run(PHI, {}, "cuda", DENSE)
    run.w0, run.w1 = w0, w1
    run.records = {r.req.rid: r for r in records}
    return run


def test_ttft_counts_every_request_due_in_the_window():
    run = _run([_rec("a", 9.0, 9.5),          # due before: out
                _rec("b", 10.0, 10.2),
                _rec("c", 12.0, 12.4),
                _rec("d", 19.0, None),        # never served: censored, 1.0
                _rec("e", 18.0, 21.0),        # served after the close: 2.0
                _rec("f", 20.0, 20.1)])       # due at the close: out
    got = sorted(readers.ttfts(run))
    assert got == pytest.approx([0.2, 0.4, 1.0, 2.0])
    assert readers.percentile(got, 50) == pytest.approx(0.7)
    assert readers.percentile(got, 90) == pytest.approx(1.7)


def test_metric_files_read_the_window():
    from harness.load import load_module
    from harness.spec import BENCH_DIR
    run = _run([_rec("a", 9.0, 9.5, [9.5, 10.5, 11.0, 11.2]),
                _rec("b", 12.0, 12.2, [12.2, 12.3]),
                _rec("c", 13.0, None)])

    def read(name):
        return load_module(BENCH_DIR / "metrics" / f"{name}.py").read(run)
    assert read("cluster.ttft_p50_ms") == pytest.approx(1e3 * (0.2 + 7.0) / 2)
    assert read("cluster.ttft_p90_ms") == pytest.approx(1e3 * 6.32)
    # gaps ending in the window: 1.0, 0.5, 0.2 (a) and 0.1 (b)
    assert read("cluster.itl_p99_ms") == pytest.approx(1e3 * 0.985)
    assert read("output_tokens_per_s") == pytest.approx(5 / 10.0)


def test_cluster_latencies_stop_where_the_profiler_opened():
    from harness.load import load_module
    from harness.spec import BENCH_DIR
    run = _run([_rec("a", 9.0, 9.5, [9.5, 10.5, 11.0, 11.2]),
                _rec("b", 12.0, 12.2, [12.2, 12.3]),
                _rec("c", 13.0, None)])
    run.traced_from = 12.25

    def read(name):
        return load_module(BENCH_DIR / "metrics" / f"{name}.py").read(run)
    assert read("cluster.ttft_p50_ms") == pytest.approx(200.0)   # b alone
    assert read("cluster.ttft_p90_ms") == pytest.approx(200.0)
    # gaps ending before 12.25: 1.0, 0.5, 0.2 (a); b's ends at 12.3
    assert read("cluster.itl_p99_ms") == pytest.approx(1e3 * (0.5 + 0.98 * 0.5))


def test_sweep_summary_sees_a_growing_backlog():
    import sweep
    run = _run([_rec(f"e{i}", 10.0 + i, 10.1 + i, [10.1 + i, 10.3 + i])
                for i in range(5)]
               + [_rec(f"l{i}", 15.0 + i, None) for i in range(5)])
    got = sweep.summary(run, readers)
    assert got["due"] == 10 and got["waiting_at_close"] == 5
    assert got["ttft_p50_first_half_s"] == pytest.approx(0.1)
    assert got["ttft_p50_second_half_s"] == pytest.approx(3.0)
    assert got["itl_p99_ms"] == pytest.approx(200.0)


@pytest.mark.parametrize("name", ["step.mfu.chat", "step.mfu.batch"])
def test_step_mfu_counts_the_window(name):
    from harness.load import load_module
    from harness.spec import BENCH_DIR
    run = _run([])
    run.device_kind = "NVIDIA H100 80GB HBM3"
    run.passes = [(12.0, 1e12), (5.0, 9e12), (20.5, 9e12)]
    run.decode_steps = [(11.0, 11.05, [1, 10], [0, 9]),
                        (21.0, 21.05, [1, 10], [0, 9])]
    peak = work.peaks(run.device_kind)["bf16_flops_per_s"]
    want = 100.0 * (1e12 + DENSE.decode_flops(PHI, [0, 9])) / (10.0 * peak)
    got = load_module(BENCH_DIR / "metrics" / f"{name}.py").read(run)
    assert got == pytest.approx(want)
    run.device = "cpu"
    assert load_module(BENCH_DIR / "metrics" / f"{name}.py").read(run) is None


def _line(rate, seed, due, waiting, first, second):
    return {"rate_per_s": rate, "seed": seed, "due": due,
            "waiting_at_close": waiting, "ttft_p50_first_half_s": first,
            "ttft_p50_second_half_s": second}


def test_knee_rule():
    import sweep
    lines = [_line(3.0, 1, 150, 0, 0.17, 0.18), _line(3.0, 2, 150, 2, 0.2, 0.25),
             _line(3.5, 1, 170, 1, 0.18, 0.22), _line(3.5, 2, 170, 3, 0.2, 0.2),
             _line(4.0, 1, 200, 17, 0.23, 1.96), _line(4.0, 2, 200, 1, 0.2, 0.2),
             _line(4.5, 1, 220, 0, 0.2, 0.2), _line(4.5, 2, 220, 0, 0.2, 0.2)]
    # 4.0 grows a backlog on seed 1, so 4.5 does not count
    assert sweep.knee(lines) == 3.5
    assert not sweep.sustained(_line(3.0, 1, 150, 9, 0.2, 0.2))
    assert not sweep.sustained(_line(3.0, 1, 150, 0, 0.2, 0.31))
    assert sweep.knee(lines[4:5]) is None


def test_sweep_writes_the_rate(tmp_path, monkeypatch):
    import json
    import sweep
    from harness import spec
    (tmp_path / "traffic").mkdir()
    mix = {"generator": "open_loop", "rate_per_s": 1.0, "user_len": [1, 2]}
    (tmp_path / "traffic" / "m.json").write_text(json.dumps(mix))
    monkeypatch.setattr(spec, "BENCH_DIR", tmp_path)
    monkeypatch.setattr(spec, "load_manifest", lambda: {
        "workloads": [{"name": "c.m", "traffic": "m"}]})
    sweep.write_rate("c.m", 2.8)
    got = json.loads((tmp_path / "traffic" / "m.json").read_text())
    assert got == dict(mix, rate_per_s=2.8)


def test_itl_and_tokens_in_window():
    run = _run([_rec("a", 5.0, 9.0, [9.0, 9.5, 10.5, 11.0]),
                _rec("b", 12.0, 12.0, [12.0, 12.1, 20.5])])
    assert sorted(readers.itls(run)) == pytest.approx([0.1, 0.5, 1.0])
    assert readers.tokens_in_window(run) == 4


def test_hand_counted_flops():
    # one layer's products: q 3072x3072, k and v 3072x1024 each, o
    # 3072x3072, SwiGLU 3 x 3072x8192
    per_layer = 3072 * 3072 * 2 + 2 * 3072 * 1024 + 3 * 3072 * 8192
    assert DENSE.layer_matmul_params(PHI) == per_layer
    assert DENSE.layer_matmul_params(MINITRON) == \
        3072 * 3072 * 2 + 2 * 3072 * 1024 + 2 * 3072 * 9216
    # a query at position p sees p + 1 keys: positions 2, 3, 4 see 3+4+5
    assert DENSE.attention_flops(PHI, 2, 5) == 4 * 24 * 128 * 12 * 32
    assert DENSE.prompt_flops(PHI, 0, 3) == (
        2 * per_layer * 32 * 3 + 2 * 3072 * 200064 + 4 * 24 * 128 * 6 * 32)
    assert DENSE.decode_flops(PHI, [0, 9]) == (
        2 * (2 * per_layer * 32 + 2 * 3072 * 200064)
        + 4 * 24 * 128 * (1 + 10) * 32)


def test_hand_counted_bytes():
    # K and V of 8 heads of 128 in bf16: 4 KiB a key, q and out 24 x 128
    # bf16 each a row, 4 bytes of length a row
    assert work.decode_attention_bytes(DENSE.attention_widths(PHI),
                                      [1, 100]) == \
        101 * 8 * 128 * 2 * 2 + 2 * 2 * 24 * 128 * 2 + 8
    assert work.page_table_bytes([1, 16, 17], 16) == 4 * (1 + 1 + 2)


def test_roofline_reads_its_kernel_only():
    run = _run([])
    run.device_kind = "NVIDIA H100 80GB HBM3"
    run.model = dict(PHI, num_hidden_layers=2)
    run.traced_steps = [([99, 0], [99])]
    run.trace = Trace(1.0, 0.5, {"void dense_split_kernel<bf16>": (2e-6, 2),
                                 "gemm": (1e-3, 10)})
    widths = DENSE.attention_widths(run.model)
    nbytes = 2 * work.decode_attention_bytes(widths, [100, 1])
    got = readers.roofline_pct(
        run, "dense_split_kernel",
        lambda ls: work.decode_attention_bytes(widths, ls))
    assert got == pytest.approx(100 * nbytes / 3.35e12 / 2e-6)
    assert readers.roofline_pct(run, "paged_split_kernel", len) is None
    run.traced_steps = run.traced_steps * 2      # half the launches missing
    assert readers.roofline_pct(run, "dense_split_kernel", len) is None
    run.traced_steps = run.traced_steps * 50     # 2 of 200 kept: a mean
    run.trace.ops["void dense_split_kernel<bf16>"] = (2e-6 * 98, 196)
    got = readers.roofline_pct(
        run, "dense_split_kernel",
        lambda ls: work.decode_attention_bytes(widths, ls))
    assert got == pytest.approx(100 * nbytes / 3.35e12 / 2e-6)


def test_idle_share_and_breakdown():
    run = _run([])
    assert readers.idle_share(run) is None
    run.trace = Trace(2.0, 0.5, {"a": (0.4, 3), "b": (0.1, 1)},
                      {"decode": 1.0, "harness": 0.5})
    assert readers.idle_share(run) == pytest.approx(0.75)
    bd = run.trace.breakdown()
    assert bd["device_ops"][0] == ["a", 0.4]
    assert bd["idle_gaps"][0] == ["decode", 1.0]


def test_peaks_table():
    p = work.peaks("NVIDIA H100 80GB HBM3")
    assert p["bf16_flops_per_s"] == 989e12
    assert p["hbm_bytes_per_s"] == 3.35e12
    with pytest.raises(KeyError):
        work.peaks("cpu")


@pytest.mark.parametrize("kind,impl", [("open", "pallas"),
                                       ("closed", "paged")])
def test_prompt_work_counted_from_host_rows(monkeypatch, kind, impl):
    """The work the harness counts from the rows the prefill engine hands
    its chunks equals a count from the model's own arguments (a cold
    pass's lengths, a resumed pass's distinct rows from ``start``)."""
    import time
    import tiny
    from harness import report
    from repro_torch.models.model import Model
    m = tiny.cell(kind, impl=impl).config["model"]
    seen = []

    def batched(fn):
        def wrapped(self, params, tokens, lengths, *a, **k):
            # a padding row of the batch has length 1; the mixes' prompts
            # are all longer
            seen.append(sum(DENSE.prompt_flops(m, 0, int(n))
                            for n in lengths.tolist() if n > 1))
            return fn(self, params, tokens, lengths, *a, **k)
        return wrapped

    def resume(fn):
        def wrapped(self, params, caches, tokens, start, *a, **k):
            rows = {tuple(r) for r in tokens.tolist()}
            s = int(start)
            seen.append(sum(DENSE.prompt_flops(m, s, s + len(r))
                            for r in rows))
            return fn(self, params, caches, tokens, start, *a, **k)
        return wrapped

    monkeypatch.setattr(Model, "prefill_batched",
                        batched(Model.prefill_batched))
    monkeypatch.setattr(Model, "prefill_resume", resume(Model.prefill_resume))
    res = report.run_cell(tiny.cell(kind, impl=impl), 7, 2.0, False, "cpu",
                          time.perf_counter(), registry=tiny.registry())
    passes = res["_run"].passes
    # the warm-up's passes come first, before the count is installed; the
    # check's reference runs no pass of the program
    assert 0 < len(passes) < len(seen)
    assert [f for _, f in passes] == pytest.approx(seen[-len(passes):],
                                                  rel=1e-12)
