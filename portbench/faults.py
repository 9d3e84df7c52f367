"""Faults planted in the program for the check's own tests: while inside,
the timed path is broken underneath the harness, and a run's ``correct``
has to come out false.

  altered_token   the served token of row 0 changed where it is produced
                  (the runtime's greedy pick), to the id half a vocabulary
                  away, in every prefill and decode step
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def altered_token(vocab: int):
    from repro_torch.core import runtime
    greedy = runtime._greedy

    def bad(logits):
        tok = greedy(logits)
        tok[0] = (tok[0] + vocab // 2) % vocab
        return tok
    runtime._greedy = bad
    try:
        yield
    finally:
        runtime._greedy = greedy
