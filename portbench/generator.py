"""The one traffic generator: it reads a mix's parameters (a data file under
``traffic/``) and makes the cell's inputs from the run's seed.

Serving mixes (``"kind": "serving"``) give a stream of requests. Sizes come
from a fixed grid of quantiles of the mix's distributions, dealt out in
blocks: every block of ``block`` consecutive requests holds the same
multiset of prompt and output lengths, and the seed only shuffles each
block and draws the token ids. So any two seeds ask for the same work in
another order, and the work of a window differs between seeds by less
than one block's worth.

The loop is closed: ``callers`` callers, each sending its next request
when its reply arrives, so it has no schedule.
"""
from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

def _grid(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths at the quantiles (i + 0.5) / n of the distribution
    ``spec`` describes, clipped to [min, max], as ints."""
    q = (np.arange(n) + 0.5) / n
    lo, hi = int(spec["min"]), int(spec["max"])
    dist = spec["dist"]
    if dist == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(p)) for p in q])
        vals = spec["median"] * np.exp(spec["sigma"] * z)
    elif dist == "uniform":            # whole numbers lo..hi, equally often
        vals = lo + np.floor(q * (hi - lo + 1))
    elif dist == "fixed":
        vals = np.full(n, float(spec["value"]))
    else:
        raise ValueError(f"length distribution {dist!r}")
    return np.clip(np.rint(vals), lo, hi).astype(np.int64)


@dataclass(frozen=True)
class Request:
    rid: int
    prompt: np.ndarray        # int32 token ids
    n_out: int                # tokens to serve (greedy, run to length)


class Requests:
    """Request ``i`` of a serving mix under one seed, made on demand."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.seed, self.vocab = mix, int(seed), int(vocab)
        self.block = int(mix["block"])
        self.prompt_grid = _grid(mix["prompt"], self.block)
        self.out_grid = _grid(mix["output"], self.block)
        self._blocks: dict = {}

    def _order(self, b: int) -> tuple:
        if b not in self._blocks:
            rng = np.random.default_rng([self.seed, 1, b])
            self._blocks[b] = (rng.permutation(self.block),
                               rng.permutation(self.block))
        return self._blocks[b]

    def get(self, i: int) -> Request:
        b, j = divmod(i, self.block)
        po, oo = self._order(b)
        n = int(self.prompt_grid[po[j]])
        rng = np.random.default_rng([self.seed, 2, i])
        ids = rng.integers(0, self.vocab, n, dtype=np.int64).astype(np.int32)
        return Request(i, ids, int(self.out_grid[oo[j]]))

    def lengths(self) -> list:
        """The distinct prompt lengths of the grid, shortest first."""
        return sorted(set(int(x) for x in self.prompt_grid))
