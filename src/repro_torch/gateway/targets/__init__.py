"""Target adapters: one duck-typed surface over the three live serving
stacks the gateway can replay against.

The gateway needs four things from whatever it fronts — invoke a
function, sample fleet memory/runtime counts, read platform counters,
and shut down. A raw ``HydraRuntime``, a single-node ``HydraPlatform``,
and a multi-node ``HydraCluster`` expose those through different
objects; the adapters normalize them so ``Gateway``/``Recorder`` never
branch on the stack kind (mirroring how the sim engine never branches
on a model name). Arrival-rate estimation needs no hook here: a
cluster feeds its per-node estimators inside ``HydraCluster.invoke``,
and a bare platform's pool is driven by the gateway's ``Autoscaler``.

Memory accounting mirrors the simulator's: live bytes are the stack's
own byte-accurate budget accounting, plus ``runtime_base_bytes`` of RSS
per live runtime (the sim's ``hydra_runtime_base``), plus the same base
for every pre-warmed pool slot — so a live replay and a sim replay of
the same trace report comparable ``mean_mem``/``ops_per_gb_s``.

The workload's weights and the executable warm-up must use the device
the adapted stack runs on (a runtime's, a platform's, or the one device
a cluster's nodes share). Every stack carries it as ``device``, so
gateway code reads ``adapter.target.device``: the adapter surface the
gateway touches stays the reference's ``TargetAdapter`` (hydralint
HL005 holds the gateway's adapter use to that one base). The port has no
counterpart to jax's persistent compilation cache, so
``exe_stats()["xla_cache_enabled"]`` stays False.

This module is a package (``targets/__init__.py``) rather than
``targets.py`` so that the documentation's ``gateway/targets.py``
references keep resolving to one file (hydralint HL006).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.cluster import HydraCluster
from repro_torch.core.platform import HydraPlatform
from repro_torch.core.runtime import HydraRuntime

MB = 1 << 20
# per-runtime RSS estimate used for live memory accounting; matches the
# sim's SimParams.hydra_runtime_base (paper Fig 5)
DEFAULT_RUNTIME_BASE = 46 * MB


class TargetAdapter:
    """Common surface; see module docstring. ``kind`` names the stack."""

    kind = ""

    def __init__(self, target, runtime_base_bytes: int = DEFAULT_RUNTIME_BASE):
        self.target = target
        self.runtime_base = runtime_base_bytes

    # -- request path ------------------------------------------------------
    def invoke(self, fid: str, args, ctx=None):
        # ctx: the request's RequestTrace (or None/NULL_TRACE); every
        # stack's invoke threads it down to the arena claim
        return self.target.invoke(fid, args, ctx=ctx)

    def register(self, fid: str, spec, *, tenant: str,
                 mem_budget: Optional[int] = None) -> bool:
        return self.target.register_function(fid, spec, tenant=tenant,
                                             mem_budget=mem_budget)

    # -- accounting --------------------------------------------------------
    def _runtimes(self) -> list:
        return []

    @property
    def n_nodes(self) -> int:
        """Real machine count of the adapted stack. ``Recorder.finish``
        stamps this on the live ``SimResult`` so fleet-wide metrics are
        never read as single-node by accident (a cluster replay reported
        as one node would look N-fold denser than the sim's fleet-wide
        accounting)."""
        return 1

    def node_mem(self) -> list:
        """Per-node committed bytes: the ``node_mem_bytes`` series of
        one fresh ``sample()`` (callers already holding a sample should
        read the key directly, as the CalibrationProbe does)."""
        return self.sample()["node_mem_bytes"]

    def platform_metrics(self) -> list:
        """Platform-level ``Metrics`` objects (boot/claim/restore
        timings live here), one per node; empty for a raw runtime."""
        return []

    def exe_caches(self) -> list:
        """Every distinct ``ExecutableCache`` the stack compiles into
        (one fleet-shared cache normally; per-node caches when a
        cluster opted out of sharing). The replay warms the workload's
        shared executable through these before the clock starts: the
        paper's platform AOT-compiles at deploy time, so a first-request
        program build would be measurement noise, not a modeled cost."""
        return [self.target.exe_cache]

    def runtime_metrics(self) -> list:
        """Per-runtime ``Metrics`` objects (code-install timings)."""
        return [rt.metrics for rt in self._runtimes()]

    def exe_stats(self) -> dict:
        """Fleet compile counters summed over ``exe_caches()``:
        ``compiles`` (real program builds), ``disk_hits`` (serialized
        executables loaded), ``cache_hits`` (in-process entry reuse),
        ``entries``, and ``xla_cache_enabled``, kept for the reference's
        schema and always False here (the port has no persistent
        compilation cache). A warm fleet should show compiles == 0 after
        boot."""
        out = {"compiles": 0, "disk_hits": 0, "cache_hits": 0,
               "entries": 0, "total_compile_s": 0.0,
               "xla_cache_enabled": False}
        for cache in self.exe_caches():
            if cache is None:
                continue
            s = cache.stats()
            out["compiles"] += s["compiles"]
            out["disk_hits"] += s["disk_hits"]
            out["cache_hits"] += s["hits"]
            out["entries"] += s["entries"]
            out["total_compile_s"] += s["total_compile_s"]
        return out

    def sample(self) -> dict:
        """Point-in-time fleet sample: mem/pool bytes + runtime count,
        plus the per-node ``node_mem_bytes`` series (one stats pass
        covers both — the recorder grid and the CalibrationProbe share
        a single sample per tick)."""
        raise NotImplementedError

    def counters(self) -> dict:
        """Platform-level counters mapped onto the SimResult vocabulary:
        ``cold_runtime`` (request-path boots), ``pool_claims``,
        ``evicted_runtimes``, ``transfers``, plus summed per-runtime
        isolate counters ``cold_isolate``/``warm_isolate``."""
        raise NotImplementedError

    def _isolate_counts(self) -> tuple:
        cold = warm = 0
        for rt in self._runtimes():
            c = rt.metrics.counters
            cold += c.get("arena.cold", 0)
            warm += c.get("arena.warm", 0)
        return cold, warm

    def slab_counts(self) -> dict:
        """Warm-claim breakdown summed fleet-wide: ``arena.reuse``
        (donated slab handed back to its owner untouched) vs
        ``arena.zeroed`` (cross-owner handover scrubbed on-device by the
        in-place zero_()). Their sum tracks ``warm_isolate``; the ratio says
        how often colocation actually pays."""
        reuse = zeroed = 0
        for rt in self._runtimes():
            c = rt.metrics.counters
            reuse += c.get("arena.reuse", 0)
            zeroed += c.get("arena.zeroed", 0)
        return {"reuse": reuse, "zeroed": zeroed}

    def shutdown(self) -> None:
        self.target.shutdown()


class RuntimeTarget(TargetAdapter):
    """One raw ``HydraRuntime``: no pool, no platform cold starts — the
    single-process baseline."""

    kind = "runtime"

    def _runtimes(self) -> list:
        return [self.target]

    def sample(self) -> dict:
        rt: HydraRuntime = self.target
        mem = rt.budget.used + self.runtime_base
        return {"mem_bytes": mem, "pool_bytes": 0, "runtimes": 1,
                "node_mem_bytes": [mem]}

    def counters(self) -> dict:
        cold_iso, warm_iso = self._isolate_counts()
        return {"cold_runtime": 0, "pool_claims": 0,
                "evicted_runtimes": 0, "transfers": 0,
                "cold_isolate": cold_iso, "warm_isolate": warm_iso}


class PlatformTarget(TargetAdapter):
    """A single-node ``HydraPlatform``: ``pool.miss`` is the live analog
    of the sim's request-path runtime cold start (the pool was dry and a
    runtime booted inline); ``pool.claim`` is a warm pool handover."""

    kind = "platform"

    def _runtimes(self) -> list:
        return self.target.runtimes()

    def platform_metrics(self) -> list:
        return [self.target.metrics]

    def sample(self) -> dict:
        plat: HydraPlatform = self.target
        s = plat.stats()
        total = s["runtimes_active"] + s["runtimes_pooled"]
        mem = s["budget_used"] + total * self.runtime_base
        return {"mem_bytes": mem,
                "pool_bytes": s["runtimes_pooled"] * self.runtime_base,
                "runtimes": total, "node_mem_bytes": [mem]}

    def counters(self) -> dict:
        c = self.target.metrics.counters
        cold_iso, warm_iso = self._isolate_counts()
        return {"cold_runtime": c.get("pool.miss", 0),
                "pool_claims": c.get("pool.claim", 0),
                "evicted_runtimes": c.get("runtime.shutdowns", 0),
                "transfers": 0,
                "cold_isolate": cold_iso, "warm_isolate": warm_iso}


class ClusterTarget(TargetAdapter):
    """A multi-node ``HydraCluster``: per-node platform counters are
    summed fleet-wide; arrivals feed the cluster's own per-node adaptive
    pool sizing (so no gateway Autoscaler is attached)."""

    kind = "cluster"

    def _platforms(self) -> list:
        return [node.platform for node in self.target.nodes]

    def _runtimes(self) -> list:
        return [rt for p in self._platforms() for rt in p.runtimes()]

    @property
    def n_nodes(self) -> int:
        return len(self.target.nodes)

    def platform_metrics(self) -> list:
        return [p.metrics for p in self._platforms()]

    def exe_caches(self) -> list:
        if self.target.exe_cache is not None:     # fleet-shared cache
            return [self.target.exe_cache]
        return [p.exe_cache for p in self._platforms()]

    def sample(self) -> dict:
        per_node = []
        pool = runtimes = 0
        for p in self._platforms():
            s = p.stats()
            total = s["runtimes_active"] + s["runtimes_pooled"]
            per_node.append(s["budget_used"] + total * self.runtime_base)
            pool += s["runtimes_pooled"] * self.runtime_base
            runtimes += total
        return {"mem_bytes": sum(per_node), "pool_bytes": pool,
                "runtimes": runtimes, "node_mem_bytes": per_node}

    def counters(self) -> dict:
        cold = claims = evicted = 0
        for p in self._platforms():
            c = p.metrics.counters
            cold += c.get("pool.miss", 0)
            claims += c.get("pool.claim", 0)
            evicted += c.get("runtime.shutdowns", 0)
        cold_iso, warm_iso = self._isolate_counts()
        cluster: HydraCluster = self.target
        return {"cold_runtime": cold, "pool_claims": claims,
                "evicted_runtimes": evicted,
                "transfers": cluster.metrics.counters.get("migrations", 0),
                "cold_isolate": cold_iso, "warm_isolate": warm_iso}


def wrap_target(target, runtime_base_bytes: int = DEFAULT_RUNTIME_BASE
                ) -> TargetAdapter:
    """Adapter for a runtime/platform/cluster instance."""
    if isinstance(target, HydraCluster):
        return ClusterTarget(target, runtime_base_bytes)
    if isinstance(target, HydraPlatform):
        return PlatformTarget(target, runtime_base_bytes)
    if isinstance(target, HydraRuntime):
        return RuntimeTarget(target, runtime_base_bytes)
    raise TypeError(f"gateway cannot front {type(target).__name__}; "
                    "expected HydraRuntime, HydraPlatform, or HydraCluster")
