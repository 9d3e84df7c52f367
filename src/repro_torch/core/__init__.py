"""Hydra virtualized runtime in PyTorch — the ported part of ``repro.core``.

One runtime process per device hosts many registered functions (models)
with shared programs, pooled memory arenas (isolates), and byte-accurate
budgets. Only the names ported so far are exported; the platform, cluster
and simulator layers come in later slices.
"""
from repro_torch.core.arena import Arena, ArenaPool, tree_bytes
from repro_torch.core.budget import MemoryBudget
from repro_torch.core.errors import (AdmissionError, FunctionNotRegisteredError,
                                     HydraError, HydraOOMError)
from repro_torch.core.executable_cache import ExecutableCache
from repro_torch.core.registry import (CallableSpec, Function, FunctionRegistry,
                                       LMSpec)
from repro_torch.core.runtime import HydraRuntime
from repro_torch.core.scheduler import ContinuousBatcher, TokenBucket

__all__ = [
    "Arena", "ArenaPool", "tree_bytes", "MemoryBudget", "ExecutableCache",
    "CallableSpec", "Function", "FunctionRegistry", "LMSpec", "HydraRuntime",
    "ContinuousBatcher", "TokenBucket", "HydraError", "HydraOOMError",
    "FunctionNotRegisteredError", "AdmissionError",
]
