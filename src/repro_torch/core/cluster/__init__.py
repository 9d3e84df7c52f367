"""HydraCluster: cross-machine placement, spill, migration, and adaptive
pool sizing over N per-node ``HydraPlatform``s (the port of
``repro.core.cluster``).

The paper's headline density wins (2.41x ops/GB-sec vs OpenWhisk, 21-44%
lower footprint on the Azure trace) come from colocation-aware placement
across a *fleet* of machines; ``HydraPlatform`` manages one host. This
layer adds what the fleet needs:

  * **Cross-node placement** — a new function packs onto the node already
    hosting its tenant (colocation keeps code/arena sharing local) while
    that node's memory budget holds, and spills to the least-committed
    node when it saturates. Admission fails only when no node can fit it.
  * **Snapshot migration** — ``migrate`` moves a live function between
    nodes through the ``ft/checkpoint`` sandbox snapshot: evict+export on
    the source, copy the snapshot across (charged an explicit transfer
    cost at ``transfer_gbps``), import+restore on the destination. The
    fleet shares one ``ExecutableCache``, so the restored function serves
    with zero recompilation. ``rebalance`` uses this to drain overloaded
    nodes into underloaded ones.
  * **Adaptive pool sizing** — instead of a fixed per-node ``pool_size``,
    an EWMA arrival-rate estimator per node drives the pre-warmed pool:
    bursts grow it toward ``pool_max`` (so claims, not cold boots, absorb
    the burst), idle periods shrink it to ``pool_min`` (releasing memory),
    and the target never commits more memory than the node budget allows.

The tracesim twin of this layer is the ``"hydra-cluster"`` model in
``repro_torch.core.tracesim``.

In the port the N nodes are logical: every node's platform takes the
device of ``ClusterParams.platform`` (CUDA unless the caller asks for the
CPU), so on one card they share its memory, and ``node_memory_bytes``
is the placement budget that separates them. A migration moves the
function's snapshot between the nodes' snapshot directories; its modeled
cross-node cost is charged at ``transfer_gbps``.

The module is a package (``core/cluster/__init__.py``) rather than
``core/cluster.py``, as the port's other core modules are.
"""
from __future__ import annotations

import math
import os
import shutil
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.errors import (FunctionNotRegisteredError, HydraError,
                                     HydraOOMError)
from repro_torch.core.executable_cache import ExecutableCache
from repro_torch.core.metrics import Metrics
from repro_torch.core.platform import (GB, HydraPlatform, PlatformParams,
                                       estimate_bytes)


class ArrivalRateEstimator:
    """EWMA arrival-rate estimator over inter-arrival gaps.

    ``observe(t)`` folds the instantaneous rate ``1/gap`` into an EWMA;
    ``rate(now)`` caps the estimate by the most recent inter-arrival gap
    (and by ``1/(now - last)`` when queried later), so a stream that goes
    quiet collapses toward zero instead of holding its burst-time
    estimate forever, while in-burst arrivals keep the smoothed estimate.
    """

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self._rate = 0.0
        self._gap: Optional[float] = None
        self._last: Optional[float] = None

    def observe(self, t: float) -> None:
        if self._last is not None:
            gap = max(t - self._last, 1e-9)
            self._gap = gap
            self._rate = (1.0 - self.alpha) * self._rate + self.alpha / gap
        self._last = max(t, self._last or t)

    def rate(self, now: Optional[float] = None) -> float:
        if self._last is None:
            return 0.0
        r = self._rate
        if self._gap is not None:
            r = min(r, 1.0 / self._gap)
        if now is not None and now > self._last:
            r = min(r, 1.0 / (now - self._last))
        return r


@dataclass
class AdaptivePoolPolicy:
    """Map an arrival-rate estimate to a pre-warmed pool target.

    The pool should hold enough warm runtimes to absorb the arrivals that
    land during one cold boot window (``cover_s``), clamped to
    ``[pool_min, pool_max]`` and to what the node's memory budget can
    still commit (``runtime_bytes`` per pooled instance).
    """
    pool_min: int = 1
    pool_max: int = 8
    cover_s: float = 1.0
    runtime_bytes: int = 2 * GB

    def target(self, rate: float, free_bytes: Optional[int] = None) -> int:
        want = math.ceil(rate * self.cover_s)
        want = max(self.pool_min, min(self.pool_max, want))
        if free_bytes is not None:
            want = min(want, max(0, int(free_bytes // self.runtime_bytes)))
        return want


@dataclass
class ClusterParams:
    n_nodes: int = 2
    node_memory_bytes: int = 16 * GB     # per-node placement budget
    transfer_gbps: float = 10.0          # cross-node snapshot bandwidth
    share_exe_cache: bool = True         # one fleet-wide executable cache
    snapshot_dir: Optional[str] = None   # root; nodes use <dir>/nodeN/
    # adaptive pool sizing
    adaptive_pool: bool = True
    pool_min: int = 2
    pool_max: int = 4
    pool_cover_s: float = 2.0            # arrivals one boot window absorbs
    ewma_alpha: float = 0.5
    resize_every: int = 8                # invocations between pool resizes
    # template for each node's platform (snapshot_dir is set per node)
    platform: PlatformParams = field(default_factory=PlatformParams)


@dataclass
class _NodeState:
    idx: int
    platform: HydraPlatform
    committed: int = 0                   # placement-estimate bytes placed
    estimator: ArrivalRateEstimator = field(
        default_factory=ArrivalRateEstimator)
    since_resize: int = 0


class HydraCluster:
    """N machines, one serverless fleet: placement, spill, migration,
    adaptive pools — over per-node ``HydraPlatform``s."""

    def __init__(self, params: Optional[ClusterParams] = None, **kw):
        self.params = params or ClusterParams(**kw)
        p = self.params
        if p.n_nodes < 1:
            raise HydraError("cluster needs at least one node")
        self.metrics = Metrics()
        self._lock = threading.RLock()
        self.exe_cache = None
        if p.share_exe_cache:
            # the fleet-wide cache persists to disk whenever the cluster
            # has a snapshot root, unless the platform template explicitly
            # opted out (persist_executables=False) — matching the
            # platform-level default of zero-recompile restores across
            # boots
            persist = None
            if p.snapshot_dir and p.platform.persist_executables is not False:
                persist = os.path.join(p.snapshot_dir, "executables")
            self.exe_cache = ExecutableCache(persist_dir=persist)
        self.nodes: list[_NodeState] = []
        for i in range(p.n_nodes):
            plat_params = PlatformParams(**vars(p.platform))
            if p.snapshot_dir:
                plat_params.snapshot_dir = os.path.join(p.snapshot_dir,
                                                        f"node{i}")
            plat = HydraPlatform(plat_params, exe_cache=self.exe_cache)
            self.nodes.append(_NodeState(idx=i, platform=plat))
        # the one device every node's platform runs on (one template)
        self.device = self.nodes[0].platform.device
        self._node_of: dict[str, int] = {}
        # fids with a migration in flight; request routing waits on the
        # condition so no invocation lands in the export->import window
        self._migrating: set = set()
        self._migrate_cv = threading.Condition(self._lock)
        self._policy = AdaptivePoolPolicy(
            pool_min=p.pool_min, pool_max=p.pool_max, cover_s=p.pool_cover_s,
            runtime_bytes=p.platform.runtime_budget_bytes)

    # ------------------------------------------------------------------
    # Placement
    # ------------------------------------------------------------------
    def _pick_node(self, tenant: str, need: int) -> _NodeState:
        """Pack-first: the tenant's most-committed node that still fits;
        else spill to the least-committed node with room."""
        with self._lock:
            cap = self.params.node_memory_bytes
            # nodes already hosting this tenant, most-committed first
            hosting = []
            for node in self.nodes:
                if any(r.tenant == tenant
                       for r in node.platform.function_records()):
                    hosting.append(node)
            hosting.sort(key=lambda n: n.committed, reverse=True)
            for node in hosting:
                if node.committed + need <= cap:
                    self.metrics.inc("place.colocated")
                    return node
            spill = sorted(self.nodes, key=lambda n: n.committed)
            for node in spill:
                if node.committed + need <= cap:
                    if hosting:
                        self.metrics.inc("place.spill")
                    return node
        raise HydraOOMError(
            f"no node can fit {need} bytes (per-node budget "
            f"{self.params.node_memory_bytes}, "
            f"{self.params.n_nodes} nodes)")

    def register_function(self, fid: str, spec, *, tenant: str = "default",
                          mem_budget: Optional[int] = None,
                          eager: bool = False) -> bool:
        """Admit ``fid`` to the fleet: colocation-aware node choice, then
        delegate to that node's platform (which does runtime-level
        packing). Returns False if the fid is already known."""
        need = mem_budget or estimate_bytes(spec)
        # reserve the fid + its budget atomically so racing registrations
        # of one fid cannot both pick a node (the loser would strand a
        # zombie copy and inflate that node's committed bytes)
        with self._lock:
            if fid in self._node_of:
                return False
            node = self._pick_node(tenant, need)
            self._node_of[fid] = node.idx
            node.committed += need
        try:
            ok = node.platform.register_function(fid, spec, tenant=tenant,
                                                 mem_budget=mem_budget,
                                                 eager=eager)
        except BaseException:
            ok = False
            raise
        finally:
            if not ok:
                with self._lock:
                    self._node_of.pop(fid, None)
                    node.committed -= need
        return ok

    def _settled_node_idx(self, fid: str):
        """fid's node index, waiting out any in-flight migration first."""
        with self._migrate_cv:
            while fid in self._migrating:
                self._migrate_cv.wait(timeout=30.0)
            return self._node_of.get(fid)

    def node_for(self, fid: str) -> HydraPlatform:
        """The per-node platform hosting ``fid``."""
        idx = self._settled_node_idx(fid)
        if idx is None:
            raise FunctionNotRegisteredError(fid)
        return self.nodes[idx].platform

    def runtime_for(self, fid: str):
        """The runtime hosting ``fid`` (placing it on its node if needed)."""
        return self.node_for(fid).runtime_for(fid)

    def placement(self) -> dict:
        """fid -> node index, for introspection."""
        with self._lock:
            return dict(self._node_of)

    # ------------------------------------------------------------------
    # Request path
    # ------------------------------------------------------------------
    def observe_arrival(self, fid: str,
                        now: Optional[float] = None) -> None:
        """Feed one arrival for ``fid`` into its node's rate estimator
        (and retarget that node's pool when due). ``invoke``/``generate``
        do this automatically; drivers that route requests to runtimes
        directly (e.g. a batcher holding ``runtime_for(fid)``) call this
        per request so adaptive pool sizing still sees the load."""
        self._on_arrival(fid, now)

    def _on_arrival(self, fid: str, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        idx = self._settled_node_idx(fid)
        with self._lock:
            if idx is None:
                raise FunctionNotRegisteredError(fid)
            node = self.nodes[idx]
            node.estimator.observe(now)
            node.since_resize += 1
            resize = (self.params.adaptive_pool
                      and node.since_resize >= self.params.resize_every)
            if resize:
                node.since_resize = 0
        if resize:
            self._resize_node_pool(node, now)
        return node

    def _resize_node_pool(self, node: _NodeState, now: float) -> None:
        free = self.params.node_memory_bytes - node.committed
        target = self._policy.target(node.estimator.rate(now),
                                     free_bytes=free)
        if target != node.platform.params.pool_size:
            self.metrics.inc("pool.resize")
            node.platform.resize_pool(target)

    def _maybe_restore(self, node: _NodeState, fid: str, ctx=None) -> None:
        # a migrated/rebalanced function arrives on its new node evicted;
        # the next invocation restores it lazily from the local snapshot
        rec = node.platform._records.get(fid)
        if rec is not None and rec.evicted:
            node.platform.restore(fid, eager=False, ctx=ctx)

    def invoke(self, fid: str, args, *, now: Optional[float] = None,
               ctx=None):
        node = self._on_arrival(fid, now)
        self._maybe_restore(node, fid, ctx)
        return node.platform.invoke(fid, args, ctx)

    def generate(self, fid: str, prompt_tokens, max_new_tokens: int = 16, *,
                 now: Optional[float] = None):
        node = self._on_arrival(fid, now)
        self._maybe_restore(node, fid)
        return node.platform.generate(fid, prompt_tokens, max_new_tokens)

    # ------------------------------------------------------------------
    # Migration + rebalancing
    # ------------------------------------------------------------------
    def _transfer(self, src_root: str, dst_root: str) -> int:
        """Copy a function's snapshot tree to the destination node's
        snapshot area; returns bytes moved and charges the explicit
        cross-node transfer cost (bytes / transfer_gbps) to metrics."""
        nbytes = 0
        for root, _, files in os.walk(src_root):
            for f in files:
                nbytes += os.path.getsize(os.path.join(root, f))
        if os.path.abspath(src_root) != os.path.abspath(dst_root):
            if os.path.exists(dst_root):
                shutil.rmtree(dst_root)
            shutil.copytree(src_root, dst_root)
        cost_s = nbytes / (self.params.transfer_gbps * 1e9 / 8)
        self.metrics.observe("transfer_s", cost_s)
        self.metrics.inc("transfer_bytes", nbytes)
        return nbytes

    def migrate(self, fid: str, dst_idx: int, *, eager: bool = True) -> int:
        """Move ``fid`` to node ``dst_idx`` through its sandbox snapshot:
        evict+export on the source, transfer the snapshot (explicit cost),
        import+restore on the destination. Returns bytes transferred."""
        with self._migrate_cv:
            while fid in self._migrating:
                self._migrate_cv.wait(timeout=30.0)
            src_idx = self._node_of.get(fid)
            if src_idx is None:
                raise FunctionNotRegisteredError(fid)
            if not (0 <= dst_idx < len(self.nodes)):
                raise HydraError(f"no such node: {dst_idx}")
            src, dst = self.nodes[src_idx], self.nodes[dst_idx]
            if src_idx == dst_idx:
                return 0
            # mark in flight: request routing blocks in _settled_node_idx
            # until the record is importable on the destination
            self._migrating.add(fid)
        try:
            exported = src.platform.export_function(fid)
            try:
                dst_path = dst.platform._snapshot_root(fid)
                nbytes = self._transfer(exported["snapshot_path"],
                                        dst_path)
                dst.platform.import_function(exported,
                                             snapshot_path=dst_path)
            except Exception:
                # roll back: re-adopt the exported record on the source
                # node so a failed transfer/import never orphans the fid
                src.platform.import_function(exported)
                raise
            with self._lock:
                self._node_of[fid] = dst_idx
                src.committed -= exported["need_bytes"]
                dst.committed += exported["need_bytes"]
        finally:
            with self._migrate_cv:
                self._migrating.discard(fid)
                self._migrate_cv.notify_all()
        if eager:
            dst.platform.restore(fid)
        self.metrics.inc("migrations")
        return nbytes

    def rebalance(self, *, max_moves: int = 8) -> list:
        """Drain the most-committed node into the least-committed one by
        migrating its smallest functions until the spread drops below one
        function's footprint. Returns [(fid, src, dst), ...].

        Runs mid-burst under the gateway's ``ClusterBalancer``, so the
        call and its moves are counted in cluster metrics
        (``rebalance.calls``/``rebalance.moves``) for the live-vs-sim
        migration accounting."""
        self.metrics.inc("rebalance.calls")
        moves = []
        for _ in range(max_moves):
            with self._lock:
                order = sorted(self.nodes, key=lambda n: n.committed)
                lo, hi = order[0], order[-1]
                cands = sorted(hi.platform.function_records(),
                               key=lambda r: r.need_bytes)
            if not cands:
                break
            rec = cands[0]
            # moving it must strictly shrink the spread, or we are done
            if hi.committed - lo.committed <= rec.need_bytes:
                break
            self.migrate(rec.fid, lo.idx, eager=False)
            moves.append((rec.fid, hi.idx, lo.idx))
        if moves:
            self.metrics.inc("rebalance.moves", len(moves))
        return moves

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            per_node = []
            for node in self.nodes:
                s = node.platform.stats()
                s["committed_bytes"] = node.committed
                s["pool_target"] = node.platform.params.pool_size
                per_node.append(s)
            return {
                "n_nodes": len(self.nodes),
                "functions_known": len(self._node_of),
                "nodes": per_node,
                "metrics": self.metrics.snapshot(),
                "exe_cache": (self.exe_cache.stats()
                              if self.exe_cache else None),
            }

    def shutdown(self) -> None:
        for node in self.nodes:
            node.platform.shutdown()
