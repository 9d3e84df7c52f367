"""Work of one forward SSD scan call (``ssd_scan``) that returns its final
state: x, dt, A, B and C read once, y and the float32 state written once;
the chunked products with C B^T counted once a chunk and B/C group (they
do not depend on the head), on the rows the sequence really has."""
from __future__ import annotations


def cost(B: int, S: int, H: int, P: int, N: int, chunk: int,
         elem_bytes: int = 2, groups: int = 1) -> tuple:
    """(bytes, flops); ``groups`` B/C groups, each shared by H / groups
    heads."""
    nbytes = (2 * B * S * H * P * elem_bytes + B * S * H * 4 + H * 4
              + 2 * B * S * groups * N * elem_bytes + B * H * P * N * 4)
    rows = [min(chunk, S - c0) for c0 in range(0, S, chunk)]
    pairs = sum(r * (r + 1) // 2 for r in rows)
    flops = (2.0 * B * groups * pairs * N + 2.0 * B * H * pairs * P
             + 4.0 * B * H * S * N * P)
    return nbytes, flops
