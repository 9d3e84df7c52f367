"""The reference's property tests (``tests/test_properties.py``) against
the port, through ``port_tests``: the budget, the simulator, the
streaming trace loader and the data pipeline. Line 18 imports the
reference's HLO parsers, which have no port analogue (the port's
``launch/roofline.wire_bytes`` is held to ``collective_bytes`` in
``tests/test_torch_sharding.py``), so it is dropped with the two tests
that use it; the online-softmax test imports nothing of the reference's
package. The arena and quantization tests feed ``jnp`` arrays, so they
have torch twins here.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from port_tests import bind, port_tests  # noqa: E402
from repro_torch.core.arena import ArenaPool  # noqa: E402
from repro_torch.ft.compression import dequantize, quantize  # noqa: E402

SETTINGS = settings(max_examples=25, deadline=None)

bind(globals(), port_tests("test_properties", include=(
    "test_budget_conservation",
    "test_tracesim_invariants",
    "test_hydra_dominates_on_sparse_multi_tenant_trace",
    "test_stream_chunk_invariance_and_roundtrip",
    "test_stream_malformed_count_cells_raise",
    "test_packing_label_shift_invariant"),
    drop_lines=("from repro.launch.roofline import _shape_bytes, "
                "collective_bytes",)))


@SETTINGS
@given(st.lists(st.sampled_from(["acq_a", "acq_b", "rel"]),
                min_size=1, max_size=60))
def test_arena_pool_conservation_torch(ops):
    """live arenas == acquired - evicted; idle never exceeds releases."""
    pool = ArenaPool(ttl_s=1e9)
    factory = lambda: {"x": torch.zeros((16,), dtype=torch.float32)}
    held = []
    for op in ops:
        if op == "rel" and held:
            pool.release(held.pop())
        elif op.startswith("acq"):
            held.append(pool.acquire((op[-1],), factory))
    c = pool.metrics.counters
    assert pool.live == c["arena.cold"]
    assert pool.idle_count == pool.live - len(held)
    assert c["arena.warm"] + c["arena.cold"] == len(
        [o for o in ops if o.startswith("acq")])


@SETTINGS
@given(st.lists(st.floats(-1e3, 1e3, allow_nan=False), min_size=1,
                max_size=200))
def test_quantization_error_bound_torch(xs):
    x = torch.tensor(xs, dtype=torch.float32)
    q, s = quantize(x)
    err = float(torch.max(torch.abs(dequantize(q, s) - x)))
    assert err <= float(s) * 0.5 + 1e-5      # round-to-nearest bound
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.clip(np.round(
        x.numpy() / s.numpy()), -127, 127))
