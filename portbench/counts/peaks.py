"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, at the card's full 700 W): the roofline's two ceilings."""
from __future__ import annotations

FLOPS = {"bfloat16": 989e12, "fp8": 1979e12, "tf32": 495e12,
         "float32": 67e12}
BYTES_S = 3.35e12


def bound_s(nbytes: float, flops: float, dtype: str = "bfloat16") -> float:
    """Least seconds for work that moves ``nbytes`` and computes ``flops``:
    the larger of the two ceilings' times."""
    return max(nbytes / BYTES_S, flops / FLOPS[dtype])
