"""Pluggable discrete-event simulator for the Azure-trace reproduction
(paper §4.4, Figures 9/10).

A copy of ``repro.core.sim`` with its imports rewritten: numpy only and
framework-free, so it gives the reference's outputs exactly
(``tests/test_torch_sim.py``). The package holds:

  * :mod:`repro_torch.core.sim.engine` — the model-agnostic event loop
    (heap, memory accounting, sampling, queue/retry/give-up) plus
    ``SimParams`` / ``SimResult``.
  * :mod:`repro_torch.core.sim.models` — the :class:`PlatformModel` policy
    interface, one subclass per runtime model, and the ``MODELS``
    registry.
  * :mod:`repro_torch.core.traces` — the ``Trace`` sources (synthetic
    generator + Azure Functions 2019 dataset loader).
  * :mod:`repro_torch.core.calibrate` — measured-cost overrides for
    ``SimParams`` (bench_startup ``--emit-calibration``).

``repro_torch.core.tracesim`` re-exports this package's API.
"""
from __future__ import annotations

from dataclasses import replace

from repro_torch.core.sim.engine import (GB, MB, Engine, Node, RuntimeInst,
                                         SimParams, SimResult)
from repro_torch.core.sim.models import (MODELS, HydraClusterModel, HydraModel,
                                         HydraPoolModel, OpenWhiskModel,
                                         PhotonsModel, PlatformModel,
                                         register_model)
from repro_torch.core.traces import (Invocation, Trace, discover_azure_tables,
                                     gen_trace, load_azure_trace)

__all__ = [
    "MB", "GB", "SimParams", "SimResult", "Invocation", "Engine", "Node",
    "RuntimeInst", "PlatformModel", "OpenWhiskModel", "PhotonsModel",
    "HydraModel", "HydraPoolModel", "HydraClusterModel", "MODELS",
    "register_model", "Trace", "gen_trace", "load_azure_trace",
    "discover_azure_tables", "simulate", "simulate_partitioned", "compare",
]


def simulate(trace, model: str, params: SimParams = SimParams(),
             sample_dt: float = 1.0) -> SimResult:
    """Replay ``trace`` under ``model`` in MODELS."""
    assert model in MODELS, model
    policy = MODELS[model](params)
    return Engine(policy, params, sample_dt=sample_dt).run(trace)


def simulate_partitioned(trace, n_nodes: int,
                         params: SimParams = SimParams(),
                         model: str = "hydra-pool") -> SimResult:
    """Baseline fleet WITHOUT a cluster layer: ``n_nodes`` independent
    single-node deployments with statically partitioned traffic (functions
    hashed across nodes) and a 1/n share of the fleet memory each. The
    merged result is directly comparable to a ``hydra-cluster`` run at the
    same node count — the delta is what cross-machine placement, spill,
    and snapshot transfer buy."""
    node_cap = params.node_cap or params.machine_cap // n_nodes
    single = replace(params, machine_cap=node_cap, n_nodes=1)
    merged = SimResult(model=f"{model}-static", n_nodes=n_nodes)
    mem: dict = {}
    pmem: dict = {}
    cnt: dict = {}
    common_end = float("inf")     # nodes' sample grids end at different
    for i in range(n_nodes):      # times; sums past the shortest would
        sub = [inv for inv in trace  # cover only a subset of the fleet
               if inv.fid % n_nodes == i]
        r = simulate(sub, model, single)
        if r.mem_samples:
            common_end = min(common_end, r.mem_samples[-1][0])
        merged.latencies += r.latencies
        merged.overheads += r.overheads
        merged.cold_runtime_starts += r.cold_runtime_starts
        merged.cold_isolate_starts += r.cold_isolate_starts
        merged.warm_isolate_starts += r.warm_isolate_starts
        merged.evicted_runtimes += r.evicted_runtimes
        merged.dropped += r.dropped
        merged.pool_claims += r.pool_claims
        merged.transfers += r.transfers
        merged.peak_pool_mem += r.peak_pool_mem   # sum of per-node peaks
        for ts, m in r.mem_samples:
            mem[ts] = mem.get(ts, 0) + m
        for ts, m in r.pool_mem_samples:
            pmem[ts] = pmem.get(ts, 0) + m
        for ts, n in r.runtime_count_samples:
            cnt[ts] = cnt.get(ts, 0) + n
    merged.mem_samples = sorted((ts, m) for ts, m in mem.items()
                                if ts <= common_end)
    merged.pool_mem_samples = sorted((ts, m) for ts, m in pmem.items()
                                     if ts <= common_end)
    merged.runtime_count_samples = sorted((ts, n) for ts, n in cnt.items()
                                          if ts <= common_end)
    return merged


def compare(trace, params: SimParams = SimParams(),
            models=None) -> dict:
    """Summaries for ``models`` (default: every registered model) on one
    trace."""
    if models is None:
        models = list(MODELS)
    unknown = [m for m in models if m not in MODELS]
    if unknown:
        raise ValueError(f"unknown model(s) {unknown}; "
                         f"registered: {list(MODELS)}")
    return {m: simulate(trace, m, params).summary() for m in models}
