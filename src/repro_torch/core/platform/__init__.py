"""HydraPlatform: the paper's platform layer over many HydraRuntimes
(the port of ``repro.core.platform``).

The single-node ``HydraRuntime`` converts *compilation* cold starts into
arena cold starts; this layer removes the remaining *runtime* cold start
and drives density (paper §4: 2.41x density, 21-44% memory reduction):

  * **Pre-warmed instance pool** — generic, function-agnostic runtimes are
    booted ahead of demand (the paper's "caching layer of pre-allocated
    Hydra instances") and claimed by ANY tenant/function on its first
    invocation, so no request ever waits on a runtime boot.
  * **Colocation-aware placement** — invocations are packed across owners
    and functions into already-running runtimes (tightest-fit first) until
    the per-runtime memory budget saturates, then spill to a pool instance,
    and only cold-boot when the pool is drained.
  * **Sandbox snapshot/restore** — a function's weights + registry state
    checkpoint to disk (``repro_torch.ft.checkpoint``); an evicted function is
    restored into a pooled runtime WITHOUT recompiling because every
    runtime shares one ``ExecutableCache`` (and optionally its persistent
    on-disk executables), so restore re-registration is a pure cache hit.

All runtimes share one ExecutableCache: code-cache sharing spans the fleet,
not just tenants within a runtime. A ``HydraCluster``
(``repro_torch.core.cluster``) composes N of these platforms — one per machine —
and adds cross-node placement, snapshot migration, and adaptive pool
sizing; the hooks it uses live here: an injectable ``exe_cache`` (so the
whole fleet, not just one node, shares compiled executables),
``resize_pool`` (the adaptive policy retargets the warm pool), and
``export_function``/``import_function`` (detach a function's portable
record on one node and adopt it on another).

``PlatformParams`` fields:

  * ``pool_size`` — target number of pre-warmed generic runtimes kept
    ready; ``resize_pool`` retargets it at runtime (adaptive sizing).
  * ``runtime_budget_bytes`` — per-runtime memory budget (paper: 2 GB);
    placement packs functions into a runtime until this saturates.
  * ``max_runtimes`` — node-level cap on simultaneous runtimes (pooled +
    active); beyond it placement fails (a cluster spills to another node).
  * ``arena_ttl_s`` / ``n_workers`` / ``janitor`` — passed through to each
    ``HydraRuntime`` (isolate pool TTL, worker threads, TTL evictor).
  * ``refill`` — re-warm the pool on a background thread after a claim.
  * ``snapshot_dir`` — enables sandbox snapshot/evict/restore under this
    directory; required for eviction-with-snapshot and migration.
  * ``persist_executables`` — also persist program records under
    ``snapshot_dir`` so a re-booted platform restores with zero compiles
    (in the port a record stands for the nvcc-built kernel libraries;
    see ``core/executable_cache.py``). Defaults to ON whenever
    ``snapshot_dir`` is set (pass False to opt out).
  * ``device`` — the one device every runtime of this platform runs on
    and every restored weight lands on: CUDA unless the caller asks for
    the CPU (``resolve_device``). A platform's runtimes never mix devices.

In the port a function's weight template is a dict of meta tensors (the
reference keeps a ``jax.ShapeDtypeStruct`` tree), and eviction frees the
device memory of the weights only when nothing else holds them: the
runtime's ``Function`` is dropped on deregistration, the emptied
runtime's idle arenas are drained, and the caller must not keep its own
reference to the ``params`` dict it registered.

The module is a package (``core/platform/__init__.py``) rather than
``core/platform.py`` so that the documentation's bare references keep
resolving to one file (hydralint HL006).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from repro_torch.core.errors import (FunctionNotRegisteredError, HydraError,
                                     HydraOOMError)
from repro_torch.core.executable_cache import ExecutableCache
from repro_torch.core.metrics import Metrics
from repro_torch.core.runtime import GB, HydraRuntime, registration_budget
from repro_torch.core.tracing import NULL_TRACE
from repro_torch.device import resolve_device
from repro_torch.ft import checkpoint as ckpt


def estimate_bytes(spec) -> int:
    """Placement-time estimate of a function's runtime footprint: the
    reservation HydraRuntime.register_function makes PLUS one live arena
    (the arena pool reserves budget again at first acquisition), so a
    placement that fits the estimate can also serve without OOM."""
    reserve, arena = registration_budget(spec)
    return reserve + arena


def meta_tree(tree):
    """The tree's structure with every tensor leaf replaced by a meta
    tensor of its shape and dtype (the reference's ShapeDtypeStruct)."""
    if isinstance(tree, dict):
        return {k: meta_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(meta_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    return tree


@dataclass
class _FunctionRecord:
    """Platform-side registry state for one function (survives eviction)."""
    fid: str
    spec: Any
    tenant: str
    mem_budget: Optional[int]
    need_bytes: int
    runtime: Optional[HydraRuntime] = None
    snapshot_path: Optional[str] = None
    params_spec: Any = None          # meta-tensor tree of the weights
    invocations: int = 0
    evicted: bool = False            # weights dropped; restore() required
    # serializes placement of THIS function so racing first invocations
    # cannot register it into two runtimes
    place_lock: threading.Lock = field(default_factory=threading.Lock)


@dataclass
class PlatformParams:
    pool_size: int = 2                        # pre-warmed generic runtimes
    runtime_budget_bytes: int = 2 * GB        # paper: 2 GB per runtime
    max_runtimes: int = 64                    # node-level instance cap
    arena_ttl_s: float = 10.0
    n_workers: int = 2
    janitor: bool = True                      # per-runtime arena TTL evictor
    refill: bool = True                       # top pool back up after claim
    snapshot_dir: Optional[str] = None        # enables snapshot/restore
    # share the exe cache across platform boots; None = auto (ON whenever
    # snapshot_dir is set, so snapshot restore is zero-recompile across
    # boots by default). Pass False to opt out explicitly.
    persist_executables: Optional[bool] = None
    # bound per-histogram sample storage (reservoir above the bound;
    # count/sum stay exact) for this platform's metrics and every runtime
    # it boots — the gateway path sets metrics.DEFAULT_RESERVOIR so a
    # full-day replay's histograms stay O(bound). None = unbounded exact.
    hist_max_samples: Optional[int] = None
    device: Any = None                        # None = CUDA (resolve_device)

    def persist_executables_on(self) -> bool:
        if self.persist_executables is None:
            return bool(self.snapshot_dir)
        return self.persist_executables


class HydraPlatform:
    """Fleet manager: pool + placement + snapshot, one shared code cache."""

    def __init__(self, params: Optional[PlatformParams] = None, *,
                 exe_cache: Optional[ExecutableCache] = None, **kw):
        self.params = params or PlatformParams(**kw)
        p = self.params
        self.device = resolve_device(p.device)
        if exe_cache is None:
            persist = None
            if p.snapshot_dir and p.persist_executables_on():
                persist = os.path.join(p.snapshot_dir, "executables")
            exe_cache = ExecutableCache(persist_dir=persist)
        self.exe_cache = exe_cache
        self.metrics = Metrics(hist_max_samples=p.hist_max_samples)
        self._lock = threading.RLock()
        self._pool: list[HydraRuntime] = []
        self._active: list[HydraRuntime] = []
        self._records: dict[str, _FunctionRecord] = {}
        self._refills: list[threading.Thread] = []
        self._booting = 0            # boot slots reserved but not finished
        self._stopping = False
        self.prewarm(p.pool_size)

    # ------------------------------------------------------------------
    # Pool
    # ------------------------------------------------------------------
    def _boot_runtime(self) -> HydraRuntime:
        p = self.params
        with self.metrics.timeit("runtime_boot_s"):
            rt = HydraRuntime(device=self.device,
                              memory_budget_bytes=p.runtime_budget_bytes,
                              arena_ttl_s=p.arena_ttl_s,
                              n_workers=p.n_workers,
                              executable_cache=self.exe_cache,
                              janitor=p.janitor,
                              hist_max_samples=p.hist_max_samples)
        self.metrics.inc("runtime.boots")
        return rt

    def prewarm(self, n: Optional[int] = None) -> None:
        """Top the pool up to ``n`` (default: configured pool size)."""
        n = self.params.pool_size if n is None else n
        while True:
            with self._lock:
                # reserve a boot slot under the lock so concurrent refill
                # threads cannot overshoot the pool or the node cap
                if (self._stopping
                        or len(self._pool) + self._booting >= n
                        or (self.n_runtimes + self._booting
                            >= self.params.max_runtimes)):
                    return
                self._booting += 1
            rt = None
            try:
                rt = self._boot_runtime()
            finally:
                # release the slot and hand over the runtime atomically,
                # so another thread cannot reserve + append in between
                with self._lock:
                    self._booting -= 1
                    if rt is not None and not self._stopping:
                        self._pool.append(rt)
                        rt = None
            if rt is not None:       # booted into a closing platform
                rt.shutdown()
                return

    def _prune_refills(self) -> None:
        """Drop finished refill/resize threads from the bookkeeping list.
        Runs on EVERY claim (not only when a new refill spawns), so a long
        replay with ``refill=False`` phases cannot accumulate dead thread
        objects without bound."""
        with self._lock:
            self._refills = [x for x in self._refills if x.is_alive()]

    def _claim_runtime(self, ctx=None) -> HydraRuntime:
        """Pop a pre-warmed runtime; cold-boot only when the pool is dry.
        The replacement boot happens on a background thread — the claiming
        request never waits on it."""
        ctx = ctx or NULL_TRACE
        with ctx.span("pool_claim") as sp:
            self._prune_refills()
            t0 = time.perf_counter()
            with self._lock:
                rt = self._pool.pop() if self._pool else None
                if rt is None:
                    # reserve the boot slot atomically with the cap check
                    if (self.n_runtimes + self._booting
                            >= self.params.max_runtimes):
                        raise HydraError(
                            f"node runtime cap ({self.params.max_runtimes}) "
                            "reached; a multi-node platform would spill to "
                            "another host")
                    self._booting += 1
            if rt is not None:
                sp.set(source="pool")
                self.metrics.inc("pool.claim")
                with self._lock:
                    self._active.append(rt)
                # the whole warm handover — lock wait, pop, activation — so a
                # live replay can calibrate the simulator's pool_claim_s from
                # measured claims (core/calibrate)
                self.metrics.observe("pool_claim_s",
                                     time.perf_counter() - t0)
            else:
                sp.set(source="boot")
                self.metrics.inc("pool.miss")
                booted = None
                try:
                    booted = self._boot_runtime()
                finally:
                    with self._lock:
                        self._booting -= 1
                        if booted is not None:
                            self._active.append(booted)
                rt = booted
            if self.params.refill:
                t = threading.Thread(target=self.prewarm, daemon=True,
                                     name="hydra-pool-refill")
                t.start()
                with self._lock:
                    self._refills.append(t)
            return rt

    def _return_runtime(self, rt: HydraRuntime) -> None:
        """An emptied runtime goes back to the pool (or shuts down if the
        pool is already full)."""
        # release idle-arena budget immediately: a pooled instance must be
        # generic again, not carry reservations from its previous tenant
        rt.arena_pool.drain()
        with self._lock:
            if len(rt.registry) > 0 or rt not in self._active:
                return               # raced a placement (or already gone)
            self._active.remove(rt)
            if len(self._pool) < self.params.pool_size:
                self._pool.append(rt)
                returned = True
            else:
                returned = False
        if returned:
            self.metrics.inc("pool.return")
        else:
            rt.shutdown()
            self.metrics.inc("runtime.shutdowns")

    def resize_pool(self, n: int, *, background: bool = True) -> None:
        """Retarget the pre-warmed pool to ``n`` instances. Shrinking shuts
        surplus pooled runtimes down immediately (releasing their memory);
        growing tops the pool back up through ``prewarm`` — on a background
        thread by default, so the request that triggered an adaptive grow
        never waits on runtime boots. This is the knob the cluster's
        adaptive sizing policy turns."""
        n = max(0, int(n))
        extra = []
        with self._lock:
            self.params.pool_size = n
            while len(self._pool) > n:
                extra.append(self._pool.pop())
        for rt in extra:
            rt.shutdown()
            self.metrics.inc("runtime.shutdowns")
        if extra:
            self.metrics.inc("pool.shrink", len(extra))
        if background:
            t = threading.Thread(target=self.prewarm, daemon=True,
                                 name="hydra-pool-resize")
            t.start()
            with self._lock:
                self._refills = [x for x in self._refills
                                 if x.is_alive()] + [t]
        else:
            self.prewarm()

    @property
    def refill_backlog(self) -> int:
        """Refill/resize thread objects still tracked (for tests/stats)."""
        with self._lock:
            return len(self._refills)

    @property
    def pool_available(self) -> int:
        with self._lock:
            return len(self._pool)

    @property
    def n_runtimes(self) -> int:
        with self._lock:
            return len(self._pool) + len(self._active)

    # ------------------------------------------------------------------
    # Registration + placement
    # ------------------------------------------------------------------
    def register_function(self, fid: str, spec, *, tenant: str = "default",
                          mem_budget: Optional[int] = None,
                          eager: bool = False) -> bool:
        """Admit a function to the platform. Placement is lazy by default:
        the first invocation claims/packs a runtime (paper: pool instances
        are claimed on first invocation). ``eager=True`` places now, keeping
        even the arena cold start off the request path."""
        need = mem_budget or estimate_bytes(spec)
        if need > self.params.runtime_budget_bytes:
            # reject at admission (paper §3.1) instead of OOMing on the
            # first request: no runtime can ever host this function
            raise HydraOOMError(
                f"{fid}: needs {need} bytes, above the per-runtime budget "
                f"of {self.params.runtime_budget_bytes}")
        with self._lock:
            if fid in self._records:
                return False
            rec = _FunctionRecord(
                fid=fid, spec=spec, tenant=tenant, mem_budget=mem_budget,
                need_bytes=need,
                params_spec=meta_tree(spec.params))
            self._records[fid] = rec
        if eager:
            self._ensure_placed(rec)
        return True

    def _admitted_map(self) -> dict:
        """id(runtime) -> sum of placement estimates admitted onto it.
        Placement must check estimates against the runtime budget, not
        ``budget.free``: an estimate covers one live arena beyond the
        registration reservation, and that headroom is not reserved
        until the arena pool allocates it — packing by ``free`` would
        let later registrations eat earlier functions' arena headroom
        and OOM their first invocation. Caller holds ``self._lock``."""
        admitted: dict = {}
        for r in self._records.values():
            if r.runtime is not None:
                key = id(r.runtime)
                admitted[key] = admitted.get(key, 0) + r.need_bytes
        return admitted

    def _try_admit(self, rec: _FunctionRecord, rt: HydraRuntime) -> bool:
        """Atomically re-check budget/estimate headroom for ``rt`` and
        optimistically assign ``rec.runtime`` so RACING placements of
        other fids (serialized only by their own place_lock) see this
        admission in the estimate sum and cannot co-admit past the
        runtime budget. Caller must clear ``rec.runtime`` on failure."""
        with self._lock:
            if rt not in self._active:
                return False
            admitted = sum(r.need_bytes for r in self._records.values()
                           if r.runtime is rt)
            if (rt.budget.free < rec.need_bytes
                    or admitted + rec.need_bytes
                    > self.params.runtime_budget_bytes):
                return False
            rec.runtime = rt
            return True

    def _ensure_placed(self, rec: _FunctionRecord,
                       ctx=None) -> HydraRuntime:
        # per-record lock: racing first invocations of one fid must not
        # both run placement (the loser would register a zombie copy into
        # a second runtime)
        ctx = ctx or NULL_TRACE
        with rec.place_lock:
            if rec.runtime is not None:
                return rec.runtime
            if rec.evicted:
                raise FunctionNotRegisteredError(
                    f"{rec.fid} (evicted; call restore() first)")
            with self._lock:
                # colocation: pack into the fullest runtime that still
                # fits — first-fit-decreasing keeps spare runtimes empty
                # so they can drain back to the pool
                candidates = sorted(self._active,
                                    key=lambda r: r.budget.used,
                                    reverse=True)
                admitted = self._admitted_map()
            for rt in candidates:
                # lock-free pre-filter on the snapshot; _try_admit
                # re-checks the chosen runtime atomically
                if (rt.budget.free < rec.need_bytes
                        or (admitted.get(id(rt), 0) + rec.need_bytes
                            > self.params.runtime_budget_bytes)):
                    continue
                if not self._try_admit(rec, rt):
                    continue
                try:
                    with ctx.span("register"):
                        ok = rt.register_function(rec.fid, rec.spec,
                                                  tenant=rec.tenant,
                                                  mem_budget=rec.mem_budget)
                except HydraOOMError:
                    rec.runtime = None
                    continue        # raced/underestimated: try the next
                except BaseException:
                    # the optimistic admission must NEVER outlive a
                    # failed registration — a dangling rec.runtime would
                    # brick every future invocation of this fid
                    rec.runtime = None
                    raise
                if not ok:
                    rec.runtime = None
                    continue
                with self._lock:
                    still_active = rt in self._active
                if not still_active:
                    # raced an eviction that returned/shut down this
                    # runtime during registration
                    rt.deregister_function(rec.fid)
                    rec.runtime = None
                    continue
                self.metrics.inc("place.colocated")
                return rt
            # saturated everywhere: spill to a pool instance
            rt = self._claim_runtime(ctx)
            with self._lock:
                rec.runtime = rt     # visible to racing admission checks
            try:
                with ctx.span("register"):
                    ok = rt.register_function(rec.fid, rec.spec,
                                              tenant=rec.tenant,
                                              mem_budget=rec.mem_budget)
            except BaseException:
                rec.runtime = None
                self._return_runtime(rt)
                raise
            if not ok:
                rec.runtime = None
                self._return_runtime(rt)
                raise HydraError(f"placement of {rec.fid} rejected")
            self.metrics.inc("place.spill")
            return rt

    def _record(self, fid: str) -> _FunctionRecord:
        with self._lock:
            rec = self._records.get(fid)
        if rec is None:
            raise FunctionNotRegisteredError(fid)
        return rec

    def runtime_for(self, fid: str) -> HydraRuntime:
        """The runtime hosting ``fid`` (placing it first if needed)."""
        return self._ensure_placed(self._record(fid))

    def runtimes(self) -> list:
        """Point-in-time snapshot of every live runtime (pooled + active),
        safe to iterate while placement proceeds; the gateway recorder
        aggregates per-runtime arena/invocation counters through this."""
        with self._lock:
            return list(self._pool) + list(self._active)

    def function_records(self) -> list:
        """Point-in-time snapshot of this node's function records, safe
        to iterate while registrations proceed (cluster placement and
        rebalancing read these)."""
        with self._lock:
            return list(self._records.values())

    def placement(self) -> dict:
        """fid -> runtime index (active runtimes only), for introspection."""
        with self._lock:
            idx = {id(rt): i for i, rt in enumerate(self._active)}
            return {fid: idx[id(rec.runtime)]
                    for fid, rec in self._records.items()
                    if rec.runtime is not None}

    # ------------------------------------------------------------------
    # Request path
    # ------------------------------------------------------------------
    def invoke(self, fid: str, args: Any, ctx=None) -> Any:
        rec = self._record(fid)
        rt = self._ensure_placed(rec, ctx)
        rec.invocations += 1
        return rt.invoke(fid, args, ctx)

    def generate(self, fid: str, prompt_tokens, max_new_tokens: int = 16):
        rec = self._record(fid)
        rt = self._ensure_placed(rec)
        rec.invocations += 1
        return rt.generate(fid, prompt_tokens, max_new_tokens)

    # ------------------------------------------------------------------
    # Snapshot / evict / restore (paper: sandbox checkpointing)
    # ------------------------------------------------------------------
    def _snapshot_root(self, fid: str) -> str:
        if not self.params.snapshot_dir:
            raise HydraError("snapshot_dir not configured")
        safe = fid.replace("/", "__")
        return os.path.join(self.params.snapshot_dir, "functions", safe)

    def snapshot(self, fid: str) -> str:
        """Checkpoint weights + registry state for one function."""
        rec = self._record(fid)
        with rec.place_lock:     # atomic vs evict() nulling the weights
            return self._snapshot_locked(rec)

    def _snapshot_locked(self, rec: _FunctionRecord) -> str:
        if rec.evicted:
            # weights are gone from memory; the existing checkpoint is the
            # only copy — never overwrite it with an empty tree
            if rec.snapshot_path:
                return rec.snapshot_path
            raise HydraError(f"{rec.fid}: evicted without a snapshot")
        root = self._snapshot_root(rec.fid)
        with self.metrics.timeit("snapshot_s"):
            path = ckpt.save(root, 0, {"params": rec.spec.params})
            state = {"fid": rec.fid, "tenant": rec.tenant,
                     "mem_budget": rec.mem_budget,
                     "invocations": rec.invocations,
                     "kind": type(rec.spec).__name__}
            with open(os.path.join(root, "registry.json"), "w") as f:
                json.dump(state, f)
        rec.snapshot_path = root
        self.metrics.inc("snapshots")
        return path

    def evict(self, fid: str, *, snapshot: bool = True) -> None:
        """Deregister ``fid`` from its runtime (if placed), freeing budget;
        weights are snapshotted first so the function can be restored
        later, then dropped from host memory either way. A runtime left
        empty drains back to the pre-warmed pool."""
        rec = self._record(fid)
        with rec.place_lock:
            if rec.evicted:
                return
            if snapshot and rec.snapshot_path is None:
                self._snapshot_locked(rec)
            rt, rec.runtime = rec.runtime, None
            if rt is not None:
                rt.deregister_function(fid)
            # drop the weights so eviction actually releases memory; the
            # snapshot (or the caller's restore) is now the only copy
            rec.spec = dataclasses.replace(rec.spec, params=None)
            rec.evicted = True
            self.metrics.inc("evictions")
            if rt is not None and len(rt.registry) == 0:
                self._return_runtime(rt)

    def restore(self, fid: str, *, eager: bool = True, ctx=None) -> None:
        """Reload an evicted function from its snapshot into the fleet.
        Re-registration hits the shared ExecutableCache, so no request-path
        (or restore-path) compilation happens."""
        ctx = ctx or NULL_TRACE
        rec = self._record(fid)
        with rec.place_lock:
            if rec.runtime is not None:
                return
            if rec.evicted:
                if rec.snapshot_path is None:
                    raise HydraError(f"{fid}: no snapshot to restore from")
                with ctx.span("restore"):
                    with self.metrics.timeit("restore_s"):
                        tree = ckpt.restore(rec.snapshot_path, 0,
                                            {"params": rec.params_spec},
                                            device=self.device)
                rec.spec = dataclasses.replace(rec.spec,
                                               params=tree["params"])
                rec.evicted = False
                self.metrics.inc("restores")
        if eager:
            self._ensure_placed(rec, ctx)

    # ------------------------------------------------------------------
    # Migration hooks (used by HydraCluster to move a sandbox off-node)
    # ------------------------------------------------------------------
    def export_function(self, fid: str) -> dict:
        """Evict ``fid`` (snapshotting it first) and detach its portable
        record from this platform. The returned dict plus the on-disk
        snapshot are everything another node needs to ``import_function``
        and restore it — the cluster's cross-machine migration path."""
        rec = self._record(fid)
        self.evict(fid, snapshot=True)
        if rec.snapshot_path is None:
            # previously evicted without a snapshot: nothing to carry over
            # — refuse BEFORE detaching so the record is not orphaned
            raise HydraError(f"{fid}: cannot export without a snapshot")
        with self._lock:
            del self._records[fid]
        self.metrics.inc("exports")
        return {"fid": rec.fid, "spec": rec.spec, "tenant": rec.tenant,
                "mem_budget": rec.mem_budget, "need_bytes": rec.need_bytes,
                "params_spec": rec.params_spec,
                "invocations": rec.invocations,
                "snapshot_path": rec.snapshot_path}

    def import_function(self, exported: dict,
                        snapshot_path: Optional[str] = None) -> None:
        """Adopt a record produced by another platform's
        ``export_function``. The function arrives evicted; ``restore``
        (or the next cluster-level restore) brings it live from the
        snapshot — which must already sit under THIS node's reachable
        path (``snapshot_path`` overrides the exported one after a copy)."""
        path = snapshot_path or exported["snapshot_path"]
        if path is None:
            raise HydraError(f"{exported['fid']}: cannot import without a "
                             "snapshot")
        rec = _FunctionRecord(
            fid=exported["fid"], spec=exported["spec"],
            tenant=exported["tenant"], mem_budget=exported["mem_budget"],
            need_bytes=exported["need_bytes"],
            params_spec=exported["params_spec"],
            invocations=exported["invocations"],
            snapshot_path=path, evicted=True)
        with self._lock:
            if rec.fid in self._records:
                raise HydraError(f"{rec.fid}: already known to this node")
            self._records[rec.fid] = rec
        self.metrics.inc("imports")

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            active = list(self._active)
            n_pool = len(self._pool)
            n_funcs = sum(r.runtime is not None for r in
                          self._records.values())
            n_known = len(self._records)   # HL001: _records mutates under lock
        return {
            "runtimes_active": len(active),
            "runtimes_pooled": n_pool,
            "functions_placed": n_funcs,
            "functions_known": n_known,
            "budget_used": sum(rt.budget.used for rt in active),
            "exe_cache": self.exe_cache.stats(),
            "metrics": self.metrics.snapshot(),
        }

    def shutdown(self) -> None:
        with self._lock:
            self._stopping = True
            refills = list(self._refills)
        for t in refills:
            t.join(timeout=5.0)
        with self._lock:
            rts = self._pool + self._active
            self._pool, self._active = [], []
        for rt in rts:
            rt.shutdown()
