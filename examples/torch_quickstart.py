"""Quickstart on the PyTorch port: serve a small model through the
disaggregated cluster.

Builds a reduced phi4-mini, stands up 1 prefill + 2 decode engines glued by
the paper's Smart Router + adaptive controller, pushes a batch of requests
through, and prints per-request latencies plus the game-theoretic metrics
(game_poa, game_saturation_state, ...).  Then it replays one registered
parity scenario through the port's engine backend and the analytic
simulator and prints whether their routing decisions agree.

    PYTHONPATH=src python examples/torch_quickstart.py        # on cuda
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import torch

from repro_torch.configs import get_reduced
from repro_torch.models import Model
from repro_torch.serving.disagg import DisaggregatedCluster, ServeRequest
from repro_torch.serving.scenarios import build_backend
from repro_torch.serving.workload import template_tokens


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    device = torch.device(ap.parse_args().device)
    cfg = get_reduced("phi4-mini-3.8b")
    model = Model(cfg)
    print(f"model: {cfg.name} ({cfg.num_layers}L d={cfg.d_model}) on "
          f"{device}")
    params = model.init(torch.Generator(device).manual_seed(0),
                        torch.bfloat16, device)

    cluster = DisaggregatedCluster(model, params, num_decode=2,
                                   slots_per_worker=3, max_len=96,
                                   adaptive=True, device=device)
    for i in range(8):
        toks = [t % cfg.vocab_size for t in template_tokens(i % 3, 32)]
        cluster.submit(ServeRequest(request_id=f"req-{i}", tokens=toks,
                                    max_new_tokens=8))
    done = cluster.run_until_done()

    print(f"\ncompleted {len(done)} requests:")
    for r in done:
        print(f"  {r.request_id}: worker={r.worker} "
              f"ttft={r.ttft*1000:7.1f}ms "
              f"kv_moved={r.transfer_blocks}blk tokens={r.output}")

    st = cluster.prefill.stats
    print(f"\nprefix cache: {st.reused_blocks}/{st.total_blocks} blocks "
          f"resumed, {st.computed_tokens}/{st.total_tokens} prompt tokens "
          f"actually computed (cache-warm routing skips real compute)")
    print("\ngame-theoretic metrics (Prometheus exposition):")
    print(cluster.metrics.export_text())

    # the scenario registry: the engine backend runs where the params live
    name = "parity-2d-warm"
    engine = build_backend(name, backend="engine", seed=0, model=model,
                           params=params).run()
    sim = build_backend(name, backend="analytic", seed=0)
    analytic = sorted(sim.run().completed, key=lambda r: r.rid)
    same = [(i, w, round(ov, 12)) for i, w, ov in engine.decisions] == \
        [(r.rid, r.decode_worker, round(r.overlap, 12)) for r in analytic]
    print(f"{name}: {len(engine.decisions)} routing decisions, engine and "
          f"analytic backends agree: {same}")


if __name__ == "__main__":
    main()
