"""Hydra virtualized runtime in PyTorch — the ported part of ``repro.core``.

One runtime process per device hosts many registered functions (models)
with shared programs, pooled memory arenas (isolates), and byte-accurate
budgets. The platform layer (pre-warmed pool, colocation placement,
sandbox snapshot/restore) and the cluster over N logical nodes sit above
it, and ``sim``/``tracesim`` hold the framework-free simulator. The
gateway comes in a later slice.
"""
from repro_torch.core.arena import Arena, ArenaPool, tree_bytes
from repro_torch.core.budget import MemoryBudget
from repro_torch.core.cluster import (AdaptivePoolPolicy, ArrivalRateEstimator,
                                      ClusterParams, HydraCluster)
from repro_torch.core.errors import (AdmissionError, FunctionNotRegisteredError,
                                     HydraError, HydraOOMError)
from repro_torch.core.executable_cache import ExecutableCache
from repro_torch.core.platform import (HydraPlatform, PlatformParams,
                                       estimate_bytes)
from repro_torch.core.registry import (CallableSpec, Function, FunctionRegistry,
                                       LMSpec)
from repro_torch.core.runtime import HydraRuntime
from repro_torch.core.scheduler import ContinuousBatcher, TokenBucket

__all__ = [
    "Arena", "ArenaPool", "tree_bytes", "MemoryBudget", "ExecutableCache",
    "CallableSpec", "Function", "FunctionRegistry", "LMSpec", "HydraRuntime",
    "HydraPlatform", "PlatformParams", "estimate_bytes", "HydraCluster",
    "ClusterParams", "AdaptivePoolPolicy", "ArrivalRateEstimator",
    "ContinuousBatcher", "TokenBucket", "HydraError", "HydraOOMError",
    "FunctionNotRegisteredError", "AdmissionError",
]
