"""The generator: the same seed gives the same inputs, and every seed asks
for the same work in another order."""
from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from portbench import generator

DOCS = json.loads((Path(__file__).parent / "traffic/docs.json").read_text())
BIG = 2**31 + 12345


@pytest.mark.parametrize("seed", [1, BIG, 2**62 + 3])
def test_requests_repeat_for_a_seed(seed):
    a, b = (generator.Requests(DOCS, seed, 32000) for _ in range(2))
    for i in (0, 1, 64, 65, 200):
        ra, rb = a.get(i), b.get(i)
        assert np.array_equal(ra.prompt, rb.prompt) and ra.n_out == rb.n_out
    other = generator.Requests(DOCS, seed + 1, 32000).get(0)
    assert not np.array_equal(a.get(0).prompt[:16], other.prompt[:16])


def test_every_block_holds_the_same_work():
    n = DOCS["block"]
    for b in range(3):
        sizes = [Counter(len(generator.Requests(DOCS, s, 32000)
                             .get(b * n + j).prompt) for j in range(n))
                 for s in (1, BIG)]
        outs = [Counter(generator.Requests(DOCS, s, 32000).get(b * n + j)
                        .n_out for j in range(n)) for s in (1, BIG)]
        assert sizes[0] == sizes[1] and outs[0] == outs[1]
    r = generator.Requests(DOCS, 1, 32000)
    lens = r.prompt_grid
    assert lens.min() >= 1024 and lens.max() <= 4000
    assert abs(np.median(lens) - 2500) <= 40
    assert sorted(set(r.out_grid)) == list(range(4, 17))
    assert max(r.get(i).prompt.max() for i in range(20)) < 32000
