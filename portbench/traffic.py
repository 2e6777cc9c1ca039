"""The general generator: inputs of every kind of traffic from ``--seed``.

A traffic mix is a data file (``traffic/<name>.json``); this module turns
its parameters and a seed into the rows a training driver feeds and the
request schedule a serving driver offers.  Sizes and gaps are drawn at a
fixed grid of quantiles of their distribution, so every seed gets the same
multiset of prompt lengths, output lengths and inter-arrival gaps, in an
order of its own: the work is the same for every seed, and the seed
changes only its order and the token ids.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream ``stream`` of ``seed``."""
    return np.random.default_rng([int(seed), int(stream)])


def zipf_ids(gen: np.random.Generator, vocab: int, size, s: float) -> np.ndarray:
    """Token ids with Zipf-distributed frequencies: id ``k`` with
    probability proportional to ``(k + 1) ** -s``."""
    p = (np.arange(1, vocab + 1, dtype=np.float64)) ** -float(s)
    return gen.choice(vocab, size=size, p=p / p.sum()).astype(np.int32)


def train_rows(seed: int, traffic: dict, vocab: int, rows: int):
    """``rows`` training rows: ``(features [rows, seq_len] int32, labels)``.
    A language model's labels are the next tokens of a Zipf stream
    (``[rows, seq_len]``)."""
    data, seq = traffic["data"], int(traffic["seq_len"])
    gen = rng(seed, 1)
    if data["kind"] == "lm":
        stream = zipf_ids(gen, vocab, (rows, seq + 1), data["zipf_s"])
        return stream[:, :-1].copy(), stream[:, 1:].copy()
    raise KeyError(f"no training data of kind {data['kind']!r}")


def _grid(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def lognormal_grid(n: int, median: float, sigma: float, lo: int, hi: int) -> np.ndarray:
    """``n`` whole sizes at the grid quantiles of a log-normal with this
    median and sigma, clipped to ``[lo, hi]``."""
    z = np.array([NormalDist().inv_cdf(q) for q in _grid(n)])
    return np.clip(np.rint(median * np.exp(sigma * z)), lo, hi).astype(np.int64)


@dataclasses.dataclass
class Request:
    """One request of a schedule: due ``due_s`` after the window opens."""

    due_s: float
    prompt: np.ndarray
    max_new: int


def schedule(seed: int, traffic: dict, vocab: int, seconds: float,
             rate: float = None) -> List[Request]:
    """The open-loop schedule of a serving window of ``seconds`` at
    ``rate`` requests a second (default: the mix's): ``round(rate x
    seconds)`` requests with Poisson arrivals (exponential gaps at the grid
    quantiles, so the last is due before the window closes), log-normal
    prompt and output lengths, and Zipf prompt tokens."""
    rate = float(traffic["arrivals"]["rate"] if rate is None else rate)
    n = max(1, int(round(rate * seconds)))
    gen = rng(seed, 2)
    gaps = -np.log1p(-_grid(n)) / rate
    gaps = gaps * (seconds / gaps.sum())
    gaps = gen.permutation(gaps)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    pr, out = traffic["prompt"], traffic["output"]
    plens = gen.permutation(lognormal_grid(n, pr["median"], pr["sigma"], pr["min"], pr["max"]))
    outs = gen.permutation(lognormal_grid(n, out["median"], out["sigma"], out["min"], out["max"]))
    limit = int(traffic["max_total"])
    outs = np.minimum(outs, limit - plens)
    s = traffic["prompt"]["zipf_s"]
    return [Request(float(due[i]), zipf_ids(gen, vocab, int(plens[i]), s).astype(np.int64),
                    int(outs[i])) for i in range(n)]


def sample_indices(seed: int, lengths: List[int], k: int) -> List[int]:
    """``k`` indices into ``lengths`` drawn from ``seed``, the longest
    always among them."""
    if not lengths:
        return []
    longest = int(np.argmax(lengths))
    rest = [i for i in range(len(lengths)) if i != longest]
    picked = rng(seed, 3).permutation(rest)[:max(0, k - 1)]
    return [longest] + sorted(int(i) for i in picked)


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (``q`` in (0, 100])."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]

