"""Fixtures of the benchmark's CPU tests: a registry whose cell runs a
reduced configuration of the port on the CPU, from parts written under a
temporary directory, beside the package's own parts."""
from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SSM = dict(name="tiny-ssm", family="ssm", n_layers=4, d_model=64,
           n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=256, ssm_state=16, ssm_head_dim=16, ssm_expand=2,
           ssm_conv=4, ssm_chunk=8, norm_eps=1e-5, tie_embeddings=True,
           dtype="bfloat16")
DOCS = dict(kind="serving", callers=4, slots=4, max_seq=64,
            prompt=dict(dist="lognormal", median=24, sigma=0.4, min=8,
                        max=40),
            output=dict(dist="uniform", min=3, max=6), block=13,
            check=dict(tokens=16))
# the reduced cell's limit, from CPU readings of the tests' seeds: sound
# runs read a token gap of 0 to 0.018 and the fp8 control 0.16 to 0.56
# (1 s windows, 40 sampled tokens)
CELLS = {"tiny-ssm-docs": ("tiny-ssm", "tiny-docs",
                           {"token_gap": {"limit": 0.1}})}


def write_parts(d: Path) -> dict:
    """Write the reduced cell's parts under ``d``; returns a benchmark
    spec whose cell is it, with the package's metrics."""
    from portbench.registry import ROOT as REPO
    for sub in ("configs", "traffic", "limits"):
        (d / sub).mkdir(parents=True, exist_ok=True)
    (d / "configs" / f"{SSM['name']}.json").write_text(json.dumps(SSM))
    (d / "traffic/tiny-docs.json").write_text(json.dumps(DOCS))
    for w, (_, _, lim) in CELLS.items():
        (d / "limits" / f"{w}.json").write_text(json.dumps({"numbers": lim}))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["workloads"] = [dict(name=w, config=c, traffic=t, chips=1)
                         for w, (c, t, _) in CELLS.items()]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = list(CELLS)
    return spec


@contextlib.contextmanager
def one_thread():
    """One CPU thread while inside, as the harness runs, so a worker
    shared with other tests is not swamped."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The reduced cells' registry; one CPU thread while it lives."""
    from portbench.registry import Registry
    d = tmp_path_factory.mktemp("portbench_parts")
    with one_thread():
        yield Registry([d], write_parts(d))


class StepClock:
    """A clock that moves ``tick`` seconds at every reading. With it a
    run's window holds the same steps, and the same requests finish in
    it, however fast or loaded the host is."""

    def __init__(self, tick: float = 0.01):
        self.t, self.tick = 0.0, tick

    def perf_counter(self) -> float:
        self.t += self.tick
        return self.t


@pytest.fixture
def step_clock(monkeypatch):
    """The serving driver on a ``StepClock``, on one CPU thread: a window
    of ``s`` seconds is about ``s / 0.03`` steps (three readings a step).
    Give ``run_cell`` ``t_start=0.0``, the clock's own zero."""
    from portbench.drivers import serving
    clock = StepClock()
    monkeypatch.setattr(serving, "time", clock)
    with one_thread():
        yield clock


@pytest.fixture
def cpu():
    import torch
    return torch.device("cpu")
