"""The check's control and fault at a size a test run holds (the reduced
cell of ``conftest``, on the CPU; the cells' own readings are taken on
the card by ``readings.py``): sound runs come out correct, and the
reference computed with fp8 products in the program's place, and a served
token altered where it is produced, come out not correct."""
from __future__ import annotations

import pytest

from portbench import faults, generator, run, weights
from portbench.drivers.serving import Loop, token_gaps
from portbench.program import arch_config
from portbench.readings import serve_control

SEEDS = (11, 2**31 + 5, 77)


def served(registry, cell, seed, n, device):
    """The first ``n`` requests of the cell's mix served to their end
    through the timed path's own loop, whatever the host's speed."""
    import torch
    from repro_torch.core.registry import LMSpec
    from repro_torch.core.runtime import HydraRuntime
    from repro_torch.core.scheduler import ContinuousBatcher
    w = registry.workload(cell)
    cfg, mix = registry.config(w["config"]), registry.mix(w["traffic"])
    params = weights.make(registry, cfg, seed, torch.bfloat16, device)
    rt = HydraRuntime(device=device, n_workers=0, janitor=False)
    rt.register_function("fn", LMSpec(cfg=arch_config(cfg), params=params,
                                      max_seq=mix["max_seq"],
                                      slots=mix["slots"]))
    loop = Loop(ContinuousBatcher(rt, "fn"),
                generator.Requests(mix, seed, cfg["vocab_size"]), lambda: 0.0)
    for _ in range(n):
        loop.send(0.0)
    while loop.inflight:
        loop.step()
    rt.shutdown()
    return cfg, params, loop.records


CELL = "tiny-ssm-docs"


@pytest.mark.parametrize("seed", SEEDS)
def test_serving_control(tiny, cpu, seed):
    limit = tiny.limits(CELL)["numbers"]["token_gap"]["limit"]
    cfg, params, sample = served(tiny, CELL, seed, 8, cpu)
    assert token_gaps(tiny, cfg, params, sample, cpu) <= limit
    assert serve_control(tiny, cfg, seed, sample, cpu) > limit


def test_altered_token_fault(tiny, cpu, step_clock):
    limit = tiny.limits(CELL)["numbers"]["token_gap"]["limit"]
    res, rec = run.run_cell(tiny, CELL, SEEDS[0], 1.0, False, cpu, 0.0)
    assert res["correct"], rec.checks
    with faults.altered_token(rec.cfg["vocab_size"]):
        res, rec = run.run_cell(tiny, CELL, SEEDS[0], 1.0, False, cpu, 0.0)
    assert not res["correct"]
    assert rec.checks["token_gap"]["value"] > 10 * limit
