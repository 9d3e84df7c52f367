"""repro_torch's simulator copies (``core/{sim,traces,streaming,tracesim,
calibrate}``) against the reference.

1. The reference's own simulator tests run against the port's copies
   (``port_tests``): tests/test_sim.py (the golden parity with
   tests/data/golden_sim.json, the model registry, edge cases, streamed
   and eager sims), tests/test_traces.py (the synthetic and Azure
   loaders, stream/eager byte parity), tests/test_calibrate.py, and the
   tracesim tests of tests/test_platform.py and tests/test_cluster.py.
2. The copies give exactly the reference's outputs on the same seeds:
   traces, every model's summary and latencies, and the density values
   recorded in BENCH_trace.json.
The copies are numpy only, so none of this involves torch."""
import dataclasses
import json
import os

import pytest

import repro.core.calibrate as jcal
import repro.core.tracesim as jsim
import repro_torch.core.calibrate as tcal
import repro_torch.core.tracesim as tsim
from port_tests import bind, port_tests

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "benchmarks", "data")
MB = 1 << 20
GB = 1 << 30

bind(globals(), port_tests("test_sim", fixtures=("golden_trace",)))
bind(globals(), port_tests("test_traces"))
bind(globals(), port_tests("test_calibrate"))
bind(globals(), port_tests("test_platform", include=(
    "test_tracesim_pool_beats_hydra_on_default_trace",
    "test_tracesim_pool_summary_fields")))
bind(globals(), port_tests("test_cluster", include=(
    "test_tracesim_cluster_beats_static_partition",
    "test_tracesim_adaptive_pool_peak_within_fixed_baseline",
    "test_tracesim_cluster_conservation_and_summary",
    "test_tracesim_node_cap_defaults_to_even_split")))


# ---------------------------------------------------------------------------
def rows(trace) -> list:
    """The invocations as tuples (the two packages' Invocation classes
    differ, their fields must not)."""
    return [dataclasses.astuple(inv) for inv in trace]


def azure_traces(pkg, stream: bool):
    kw = dict(durations_csv=os.path.join(DATA, "azure_sample_durations.csv"),
              memory_csv=os.path.join(DATA, "azure_sample_memory.csv"),
              seed=0)
    sample = os.path.join(DATA, "azure_sample.csv")
    return (pkg.Trace.stream_azure(sample, **kw) if stream
            else pkg.Trace.from_azure(sample, **kw))


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_traces_equal_reference(seed):
    kw = dict(n_functions=30, n_tenants=8, duration_s=120.0, mean_rps=3.0,
              seed=seed)
    assert rows(tsim.gen_trace(**kw)) == rows(jsim.gen_trace(**kw))
    assert rows(tsim.Trace.synthetic(**kw)) == rows(jsim.Trace.synthetic(**kw))


@pytest.mark.parametrize("stream", [False, True])
def test_azure_traces_equal_reference(stream):
    mine, ref = azure_traces(tsim, stream), azure_traces(jsim, stream)
    assert rows(mine) == rows(ref)
    assert mine.describe() == ref.describe()


@pytest.mark.parametrize("model", list(jsim.MODELS))
def test_every_model_equals_reference_on_same_seed(model):
    trace_kw = dict(n_functions=40, n_tenants=12, duration_s=300.0,
                    mean_rps=3.0, seed=3)
    p_kw = dict(n_nodes=2, runtime_cap=192 * MB, machine_cap=3 * GB)
    mine = tsim.simulate(tsim.gen_trace(**trace_kw), model,
                         tsim.SimParams(**p_kw))
    ref = jsim.simulate(jsim.gen_trace(**trace_kw), model,
                        jsim.SimParams(**p_kw))
    assert mine.latencies == ref.latencies
    assert mine.summary() == ref.summary()


def test_bench_trace_density_values_come_out_unchanged():
    """BENCH_trace.json's azure section (the streamed bundled sample at
    bench_trace's fleet-pressure parameters) through the port's copies:
    every recorded model value, the density ordering included, equal."""
    with open(os.path.join(ROOT, "BENCH_trace.json")) as f:
        bench = json.load(f)
    p = tsim.SimParams(**bench["params"])
    res = tsim.compare(azure_traces(tsim, stream=True), p)
    for model, want in bench["models"].items():
        got = res[model]
        assert {k: got[k] for k in want} == want, model
    values = bench["density_ordering"]["values"]
    assert {m: res[m]["ops_per_gb_s"] for m in values} == values


def test_calibration_applies_like_reference(tmp_path):
    doc = {"hydra_runtime_cold_s": 0.021, "fn_register_s": 0.004,
           "snapshot_restore_s": 0.3}
    path = tmp_path / "cal.json"
    tcal.write_calibration(str(path), doc, meta={"source": "test"})
    mine = tcal.apply_calibration(tsim.SimParams(), str(path))
    ref = jcal.apply_calibration(jsim.SimParams(), str(path))
    assert vars(mine) == vars(ref)
    trace = jsim.gen_trace(n_functions=20, n_tenants=4, duration_s=60.0)
    assert (tsim.simulate(trace, "hydra-pool", mine).summary()
            == jsim.simulate(trace, "hydra-pool", ref).summary())
