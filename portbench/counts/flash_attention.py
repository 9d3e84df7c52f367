"""Work of one forward flash-attention call of a prefill (one prompt, B =
1): q, k and v read once and the output written once, in bf16; the
products q k^T and p v on the (query, key) pairs a causal mask keeps, 4
hd flops a query head each. The same shapes count alike whichever kernel
runs them."""
from __future__ import annotations


def cost(S: int, hq: int, hkv: int, hd: int, elem_bytes: int = 2) -> tuple:
    """(bytes, flops) of causal attention over S positions."""
    nbytes = S * hd * (2 * hq + 2 * hkv) * elem_bytes
    flops = 4.0 * hq * hd * (S * (S + 1) // 2)
    return nbytes, flops
