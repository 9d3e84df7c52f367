"""Facade for the discrete-event simulator: a copy of ``repro.core.tracesim``.

The simulator lives in the ``repro_torch.core.sim`` package (``engine.py``
— model-agnostic event loop; ``models.py`` — the ``PlatformModel`` policy
interface + ``MODELS`` registry) with its trace sources in
``repro_torch.core.traces`` (synthetic generator + Azure Functions 2019
loader) and measured-cost calibration in ``repro_torch.core.calibrate``.
All of it is numpy only and framework-free, so it must give the
reference's outputs exactly. Every public name imports from here:

    from repro_torch.core.tracesim import SimParams, gen_trace, simulate

and ``python -m repro_torch.core.tracesim`` prints the five-model
comparison on the default synthetic trace.

The module is a package (``core/tracesim/__init__.py``) rather than
``core/tracesim.py`` so that the documentation's bare references keep
resolving to one file (hydralint HL006).
"""
from __future__ import annotations

from repro_torch.core import sim as _sim
from repro_torch.core.sim import (GB, MB, MODELS, Engine, HydraClusterModel,
                                  HydraModel, HydraPoolModel, Invocation, Node,
                                  OpenWhiskModel, PhotonsModel, PlatformModel,
                                  RuntimeInst, SimParams, SimResult, Trace,
                                  compare, discover_azure_tables, gen_trace,
                                  load_azure_trace, register_model, simulate,
                                  simulate_partitioned)

__all__ = [
    "MB", "GB", "SimParams", "SimResult", "Invocation", "Engine", "Node",
    "RuntimeInst", "PlatformModel", "OpenWhiskModel", "PhotonsModel",
    "HydraModel", "HydraPoolModel", "HydraClusterModel", "MODELS",
    "register_model", "Trace", "gen_trace", "load_azure_trace",
    "discover_azure_tables", "simulate", "simulate_partitioned", "compare",
]
# the sim package stays the single source of truth for the public surface
assert set(__all__) == set(_sim.__all__), "tracesim facade drifted"

# old private names, kept for anything that poked at the internals
_RuntimeInst = RuntimeInst
_Node = Node


def main() -> None:
    import json
    summaries = compare(gen_trace())
    print(json.dumps(summaries, indent=2))
