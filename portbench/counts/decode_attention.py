"""Work of one decode-attention call over a batch of slots: each slot's
visible K and V rows read once (``lengths``: the keys each slot's token
sees), the query read and the output written, in bf16; the products, 4
hd flops a query head for each key. The same shapes count alike whichever
kernel runs them."""
from __future__ import annotations


def cost(lengths, hq: int, hkv: int, hd: int, elem_bytes: int = 2) -> tuple:
    """(bytes, flops) of one decode step's attention over ``lengths``."""
    keys = sum(lengths)
    nbytes = (2 * keys * hkv * hd + 2 * len(lengths) * hq * hd) * elem_bytes
    flops = 4.0 * hq * hd * keys
    return nbytes, flops
