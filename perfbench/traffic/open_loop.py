"""Open-loop chat sessions that share system prompts.

Requests arrive as a Poisson stream at ``rate_per_s``.  Each is one of
``system_prompts`` system prompts, chosen with Zipf(``zipf_s``) popularity
(rank 0 most popular; lengths uniform over ``system_len``, fixed by rank),
followed by a unique user turn (log-uniform over ``user_len``), and asks
for a log-uniform number of tokens over ``output_len``.  Arrivals cover
``lead_in_s`` seconds before the window and the window itself, each a
segment of its own: ``round(rate * length)`` requests whose sizes, gaps
and prompt choices are fixed quantiles, the gaps scaled to fill the
segment.  So every seed sends the window the same requests at the same
rate; the seed orders them within each segment and draws every token."""
from __future__ import annotations

import numpy as np

from harness import sampling
from harness.load import OpenLoop, Request


def _segment(mix: dict, n: int, length: float, rng) -> list:
    """(offset, group, user length, output length) of ``n`` arrivals over
    ``length`` seconds, the first at 0."""
    k = int(mix["system_prompts"])
    groups = sampling.shuffled(
        [i for i, c in enumerate(sampling.zipf_counts(n, k, mix["zipf_s"]))
         for _ in range(c)], rng)
    users = sampling.shuffled(sampling.log_uniform(n, *mix["user_len"]), rng)
    outs = sampling.shuffled(sampling.log_uniform(n, *mix["output_len"]), rng)
    gaps = np.asarray(sampling.shuffled(
        sampling.exponential_gaps(n, float(mix["rate_per_s"])), rng))
    gaps *= length / gaps.sum()
    starts = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return list(zip(starts.tolist(), groups, users, outs))


def build(mix: dict, seed: int, seconds: float, vocab: int) -> OpenLoop:
    lead = float(mix["lead_in_s"])
    rate = float(mix["rate_per_s"])
    rng = np.random.default_rng([seed, 0])
    arrivals = []
    for t0, length in ((0.0, lead), (lead, seconds)):
        n = int(round(rate * length))
        if n > 0:
            arrivals += [(t0 + t, g, u, o)
                         for t, g, u, o in _segment(mix, n, length, rng)]
    sys_lens = sampling.shuffled(
        sampling.uniform(int(mix["system_prompts"]), *mix["system_len"]),
        np.random.default_rng(0))
    system = {}

    def prompt(i, g, u):
        def make():
            if g not in system:
                system[g] = sampling.tokens(
                    np.random.default_rng([seed, 1, g]), sys_lens[g], vocab)
            return system[g] + sampling.tokens(
                np.random.default_rng([seed, 2, i]), u, vocab)
        return make

    reqs = [Request(f"r{i}", sys_lens[g] + u, o, prompt(i, g, u), due=t,
                    group=g)
            for i, (t, g, u, o) in enumerate(arrivals)]
    return OpenLoop(reqs, lead)
