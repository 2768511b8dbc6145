"""A closed loop of ``clients`` callers with unshared prompts.

Each client sends a request, waits for its last token, and sends the next
at once.  The clients start one after another, evenly over ``ramp_s``
seconds, so the slots fill a few prompts a tick.  Prompts are log-uniform
over ``prompt_len`` and unique; outputs log-uniform over ``output_len``.
Each round (one request a client, ``requests_per_client`` rounds) takes
the same ``clients`` sizes at fixed quantiles, dealt to the clients in an
order drawn from the seed, which also draws every token: every seed
starts the window with the same work."""
from __future__ import annotations

import numpy as np

from harness import sampling
from harness.load import ClosedLoop, Request


def build(mix: dict, seed: int, seconds: float, vocab: int) -> ClosedLoop:
    c = int(mix["clients"])
    rounds = int(mix["requests_per_client"])
    rng = np.random.default_rng([seed, 0])
    prompts, outs = [], []
    for _ in range(rounds):
        prompts += sampling.shuffled(
            sampling.log_uniform(c, *mix["prompt_len"]), rng)
        outs += sampling.shuffled(
            sampling.log_uniform(c, *mix["output_len"]), rng)

    def make(i, p):
        return lambda: sampling.tokens(np.random.default_rng([seed, 2, i]), p,
                                       vocab)

    queues = [[] for _ in range(c)]
    for i in range(c * rounds):
        queues[i % c].append(Request(f"r{i}", prompts[i], outs[i],
                                     make(i, prompts[i]), client=i % c))
    ramp = float(mix["ramp_s"])
    return ClosedLoop(queues, [ramp * i / c for i in range(c)])
