"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample of
the requests the window finished, drawn from the seed, goes through the
reference: each prompt followed by the tokens the program served, in one
teacher-forced pass.  At every served token the gap by which its reference
logit lies below the reference's best is read; the number compared is the
widest gap over the sample.  The sample holds the request with the most
tokens, and, where the window had them, a request whose prompt pass ran
cold and one resumed from the prefix cache.

The control (``control=True``) reads, at the same positions, the gap of
the token the fp8 reference puts first."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


def sample(records, n: int, seed: int) -> list:
    """Up to ``n`` finished records: the longest, one cold and one resumed
    where known, the rest drawn from the seed."""
    done = sorted((r for r in records if r.finished is not None),
                  key=lambda r: r.req.rid)
    if not done:
        return []
    rng = np.random.default_rng([seed, 3])
    pick = [max(done, key=lambda r: (len(r.tokens) + len(r.output), r.req.rid))]
    for kind in ("cold", "resumed"):
        have = [r for r in done if r.prefill == kind and r not in pick]
        if have and not any(r.prefill == kind for r in pick):
            pick.append(have[int(rng.integers(len(have)))])
    rest = [r for r in done if r not in pick]
    for i in rng.permutation(len(rest))[: max(0, n - len(pick))]:
        pick.append(rest[int(i)])
    return pick


def logit_gaps(reference, weights, model: dict, chosen,
               control: bool = False) -> Dict[str, Optional[float]]:
    """The widest gap of the served tokens (``gap``) over ``chosen`` and,
    with ``control``, of the fp8 reference's first choices
    (``control_gap``); ``tokens`` compared.  ``reference`` is the cell's
    architecture's reference module."""
    seqs, wanted, served = [], [], []
    for r in chosen:
        p = len(r.tokens)
        out = list(r.output)
        seqs.append(list(r.tokens) + out[:-1])
        wanted.append(range(p - 1, p - 1 + len(out)))
        served.append(torch.as_tensor(out, dtype=torch.long))
    picks: List[Optional[torch.Tensor]] = [None] * len(seqs)
    if control:
        firsts: List[List[torch.Tensor]] = [[] for _ in seqs]

        def take(i, lo, logits):
            firsts[i].append(logits.argmax(-1).cpu())
        reference.logits_at(weights, model, seqs, wanted, take,
                            precision="fp8")
        picks = [torch.cat(f) for f in firsts]
    worst = {"gap": 0.0, "control_gap": 0.0 if control else None}

    def judge(i, lo, logits):
        at = lo - wanted[i].start
        rows = torch.arange(logits.shape[0], device=logits.device)
        best = logits.max(-1).values
        tok = served[i][at:at + logits.shape[0]].to(logits.device)
        worst["gap"] = max(worst["gap"],
                           float((best - logits[rows, tok]).max()))
        if picks[i] is not None:
            c = picks[i][at:at + logits.shape[0]].to(logits.device)
            worst["control_gap"] = max(worst["control_gap"],
                                       float((best - logits[rows, c]).max()))
    reference.logits_at(weights, model, seqs, wanted, judge)
    worst["tokens"] = sum(len(w) for w in wanted)
    return worst
