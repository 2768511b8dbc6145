"""Fixed sets of sizes, reordered by the seed.

Every seed gets the same multiset of lengths, gaps and choices, drawn at
evenly spaced quantiles of the mix's distribution; the seed only orders
them and fills the tokens.  So two seeds do the same work in another
order, and a run's spread is the system's, not the draw's."""
from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np


def quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def log_uniform(n: int, lo: int, hi: int) -> List[int]:
    """``n`` integer lengths at the quantiles of log-uniform [lo, hi]."""
    q = quantiles(n)
    return [int(round(lo * (hi / lo) ** x)) for x in q]


def uniform(n: int, lo: int, hi: int) -> List[int]:
    return [int(round(lo + (hi - lo) * x)) for x in quantiles(n)]


def exponential_gaps(n: int, rate: float) -> List[float]:
    """``n`` gaps at the quantiles of Exp(rate): a Poisson stream's."""
    return [-math.log1p(-x) / rate for x in quantiles(n)]


def zipf_counts(n: int, k: int, s: float) -> List[int]:
    """How many of ``n`` draws go to each of ``k`` items under Zipf(s)
    popularity (rank 0 most popular), by largest remainder."""
    w = np.array([1.0 / (i + 1) ** s for i in range(k)])
    exact = n * w / w.sum()
    counts = np.floor(exact).astype(int)
    for i in np.argsort(-(exact - counts))[: n - counts.sum()]:
        counts[i] += 1
    return counts.tolist()


def shuffled(values: Sequence, rng: np.random.Generator) -> list:
    return [values[i] for i in rng.permutation(len(values))]


def tokens(rng: np.random.Generator, n: int, vocab: int) -> List[int]:
    """``n`` token ids, uniform over the vocabulary but id 0."""
    return rng.integers(1, vocab, size=n).tolist()
