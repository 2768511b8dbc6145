"""``tracer_states.py`` with what a recurrent model adds to the program's
tracing, on the chip.

    python3 perfbench/state_spans.py --workload <name> --seeds <n> \
        --seconds <s> [--states on,traced] [--out <file.jsonl>]

Runs ``tracer_states.py``'s states with three additions: the span
``decode.admit.state`` (the copy of a request's recurrent state into its
decode slot, inside ``decode.admit``) among the program's spans; the
counter ``DecodeEngine.state_bytes_in`` (recurrent-state bytes the
hand-offs moved, summed over the decoders) beside the others, with the
decode graphs' ``graph_replays``, ``graph_captures`` and ``eager_steps``;
and, in a profiled state, the ``record_function`` ranges the model opens
by layer kind in its eager passes while the tracer is on (``layer.mamba``,
``layer.attn``, ``layer.mlp``), as labels of the device's idle gaps and
with their host time summed by kind.  Each JSON line gains
``decode.admit.state_ms``, ``graphs`` and ``state_bytes_in`` (the
window's growth of those counters, where the program keeps them) and
``layer_host_s``.  No served token is judged here."""
from __future__ import annotations

import sys
from collections import defaultdict
from pathlib import Path

HERE = Path(__file__).resolve().parent
LAYER_RANGES = ("layer.mamba", "layer.attn", "layer.mlp")
GRAPHS = ("graph_replays", "graph_captures", "eager_steps")


def main(argv=None) -> int:
    sys.path[:0] = [str(HERE), str(HERE.parent / "src")]
    from torch.autograd import DeviceType

    import tracer_states
    from harness import serve, spans, trace

    spans.PROGRAM_SPANS = spans.PROGRAM_SPANS + ("decode.admit.state",)
    serve.RANGES = serve.RANGES + LAYER_RANGES
    counters = spans.counters

    def with_state(cluster):
        out = counters(cluster)
        for key in GRAPHS + ("state_bytes_in",):
            if all(hasattr(d, key) for d in cluster.decoders):
                out[key] = float(sum(getattr(d, key)
                                     for d in cluster.decoders))
        return out
    spans.counters = with_state

    host = defaultdict(float)
    reduce = trace.reduce

    def keep_layers(prof, ranges, top):
        host.clear()
        for e in prof.profiler.kineto_results.events():
            if e.name() in LAYER_RANGES and e.device_type() == DeviceType.CPU:
                host[e.name()] += e.duration_ns() / 1e9
        return reduce(prof, ranges, top)
    trace.reduce = keep_layers

    program_line = tracer_states.program_line

    def with_layers(run, sp):
        line = program_line(run, sp)
        line["decode.admit.state_ms"] = sp.mean_ms(run, "decode.admit.state")
        line["state_bytes_in"] = sp.delta(run, "state_bytes_in")
        line["graphs"] = {k: sp.delta(run, k) for k in GRAPHS}
        line["layer_host_s"] = dict(host)
        return line
    tracer_states.program_line = with_layers
    return tracer_states.main(argv)


if __name__ == "__main__":
    sys.exit(main())
