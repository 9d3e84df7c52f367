"""Platform models: the policy layer of the simulator.

Each runtime model from the paper (plus this repo's platform/cluster
layers) is a :class:`PlatformModel` subclass that answers the engine's
policy questions:

  * ``group_key``       — how invocations group into runtime instances
  * ``on_arrival``      — which existing instance (if any) serves an
                          arrival, and on which node
  * ``pick_node``       — where a NEW instance boots, and whether it is
                          claimed from the pre-warmed pool
  * ``startup_cost``    — per-arrival install cost: first code install vs
                          snapshot restore vs cross-node snapshot transfer
  * ``acquire_isolate`` — isolate/worker acquisition cost + accounting
  * ``on_idle``         — what happens when an invocation completes
                          (release isolates, schedule drain-to-pool)
  * ``adapt_pool``      — warm-pool retargeting on each observed arrival

plus the structural constants (``base_mem``, ``runtime_cold_s``,
``n_nodes``, ``node_cap``, per-instance ``runtime_cap``). The engine
(:mod:`repro_torch.core.sim.engine`) never branches on a model name; adding a
sixth model (e.g. a FaaSnap-style snapshot-restore baseline or a
TrEnv-X shared-environment variant) is one new subclass plus a
``MODELS`` registration.

A copy of ``repro.core.sim.models`` with its imports rewritten.
"""
from __future__ import annotations

import math

from repro_torch.core.sim.engine import Engine, Node, RuntimeInst, SimParams
from repro_torch.core.traces import Invocation


class PlatformModel:
    """Base policy: one node, first-fit packing into the group's
    instances, per-function code install on first load, pooled isolates
    with TTL eviction (the ``photons`` semantics — subclasses override
    the decisions that differ)."""

    name: str = ""
    hydra_like: bool = False     # polyglot runtime constants (cold/base)
    pooled: bool = False         # pre-warmed platform pool + snapshots

    def __init__(self, params: SimParams):
        self.p = params

    # -- structure ---------------------------------------------------------
    @property
    def base_mem(self) -> int:
        return self.p.hydra_runtime_base if self.hydra_like \
            else self.p.runtime_base

    @property
    def runtime_cold_s(self) -> float:
        return self.p.hydra_runtime_cold_s if self.hydra_like \
            else self.p.runtime_cold_s

    @property
    def n_nodes(self) -> int:
        return 1

    @property
    def node_cap(self) -> int:
        return self.p.machine_cap

    def init_node(self, nd: Node) -> None:
        pass

    def runtime_cap(self, need: int) -> int:
        return self.p.runtime_cap

    # -- policy ------------------------------------------------------------
    def group_key(self, inv: Invocation) -> tuple:
        raise NotImplementedError

    def on_arrival(self, eng: Engine, inv: Invocation, need: int,
                   key: tuple):
        """Pick an existing instance for the arrival: first instance in
        the group with budget headroom. Returns (node, inst|None,
        warm_worker)."""
        nd = eng.nodes[0]
        for r in nd.insts.setdefault(key, []):
            if r.mem() + need <= r.cap:
                return nd, r, False
        return nd, None, False

    def pick_node(self, eng: Engine, inv: Invocation, need: int):
        """Place a new instance: (node, claim_from_pool)."""
        return eng.nodes[0], False

    def on_boot(self, inst: RuntimeInst, inv: Invocation) -> None:
        pass

    def startup_cost(self, eng: Engine, nd: Node, inst: RuntimeInst,
                     inv: Invocation) -> float:
        """First time this fid loads into this runtime: full code
        install; shared code caches amortize subsequent loads. The
        snapshot-store bookkeeping feeds the pooled models' restore
        path."""
        if inv.fid in inst.functions_loaded:
            return 0.0
        inst.functions_loaded.add(inv.fid)
        cost = self.install_cost(eng, nd, inv)
        nd.snapshots.add(inv.fid)
        return cost

    def install_cost(self, eng: Engine, nd: Node, inv: Invocation) -> float:
        return self.p.fn_register_s

    def acquire_isolate(self, eng: Engine, inst: RuntimeInst,
                        inv: Invocation, warm_worker: bool,
                        t: float) -> float:
        p = self.p
        cnt, _ = inst.warm_isolates.get(inv.mem_bytes, (0, 0.0))
        if cnt > 0:
            inst.warm_isolates[inv.mem_bytes] = (cnt - 1, t)
            cost = p.isolate_warm_s
            eng.res.warm_isolate_starts += 1
        else:
            cost = p.isolate_cold_s
            eng.res.cold_isolate_starts += 1
        inst.live_mem += inv.mem_bytes + p.isolate_base
        return cost

    def on_idle(self, eng: Engine, nd: Node, inst: RuntimeInst,
                inv: Invocation, t: float) -> None:
        """Invocation completed: free its working memory, return the
        isolate to the warm pool (evicted after TTL)."""
        p = self.p
        inst.live_mem -= inv.mem_bytes + p.isolate_base
        cnt, _ = inst.warm_isolates.get(inv.mem_bytes, (0, t))
        inst.warm_isolates[inv.mem_bytes] = (cnt + 1, t)
        eng.push(t + p.isolate_ttl_s, "evict", (inst, inv.mem_bytes))
        if (self.pooled and p.pool_drain_ttl_s > 0
                and inst.live_invocations == 0):
            eng.push(t + p.pool_drain_ttl_s, "drain", (nd, inst))

    def adapt_pool(self, eng: Engine, nd: Node, t: float) -> None:
        pass


# ---------------------------------------------------------------------------
class OpenWhiskModel(PlatformModel):
    """One runtime per function instance, ONE invocation at a time
    (classic FaaS worker); the worker stays resident — runtime plus
    function memory — until keep-alive expiry."""

    name = "openwhisk"

    def group_key(self, inv: Invocation) -> tuple:
        return (inv.fid,)

    def on_arrival(self, eng: Engine, inv: Invocation, need: int,
                   key: tuple):
        nd = eng.nodes[0]
        for r in nd.insts.setdefault(key, []):
            if r.live_invocations == 0:
                return nd, r, True
        return nd, None, False

    def runtime_cap(self, need: int) -> int:
        return self.base_mem + need

    def on_boot(self, inst: RuntimeInst, inv: Invocation) -> None:
        inst.live_mem = inv.mem_bytes    # worker-resident fn memory

    def startup_cost(self, eng: Engine, nd: Node, inst: RuntimeInst,
                     inv: Invocation) -> float:
        return 0.0                       # no per-invocation code install

    def acquire_isolate(self, eng: Engine, inst: RuntimeInst,
                        inv: Invocation, warm_worker: bool,
                        t: float) -> float:
        if warm_worker:
            eng.res.warm_isolate_starts += 1
        else:
            eng.res.cold_isolate_starts += 1
        return 0.0

    def on_idle(self, eng: Engine, nd: Node, inst: RuntimeInst,
                inv: Invocation, t: float) -> None:
        pass                             # worker memory stays resident


class PhotonsModel(PlatformModel):
    """One runtime per function, MANY concurrent invocations
    (virtualized single-function runtime)."""

    name = "photons"

    def group_key(self, inv: Invocation) -> tuple:
        return (inv.fid,)


class HydraModel(PlatformModel):
    """One runtime per TENANT hosting any of the tenant's functions,
    many concurrent invocations, shared code caches; a new instance when
    the per-runtime budget saturates (paper setup)."""

    name = "hydra"
    hydra_like = True

    def group_key(self, inv: Invocation) -> tuple:
        return (inv.tenant,)


class HydraPoolModel(HydraModel):
    """The HydraPlatform layer: colocation ACROSS tenants (any runtime
    hosts any owner's functions, packed until the budget saturates), a
    pre-warmed pool of generic instances claimed instead of cold-booting,
    and snapshot-based function install."""

    name = "hydra-pool"
    pooled = True

    def group_key(self, inv: Invocation) -> tuple:
        return ()                        # colocate across owners AND fns

    def init_node(self, nd: Node) -> None:
        nd.pool_avail = nd.pool_target = self.p.pool_size

    def pick_node(self, eng: Engine, inv: Invocation, need: int):
        nd = eng.nodes[0]
        return nd, nd.pool_avail > 0

    def install_cost(self, eng: Engine, nd: Node, inv: Invocation) -> float:
        if inv.fid in nd.snapshots:      # restore from local snapshot
            return self.p.snapshot_restore_s
        return self.p.fn_register_s


class HydraClusterModel(HydraPoolModel):
    """The HydraCluster layer: ``n_nodes`` machines, each a hydra-pool
    node. Placement packs into already-running instances fleet-wide and
    spills new instances to the least-loaded node; a function whose
    snapshot lives only on another node pays an explicit cross-node
    transfer cost; each node's pool is sized by an EWMA arrival-rate
    estimator."""

    name = "hydra-cluster"

    def __init__(self, params: SimParams):
        super().__init__(params)
        self.pool_max = params.pool_max if params.pool_max is not None \
            else params.pool_size
        self.transfer_s = params.snapshot_bytes \
            / (params.transfer_gbps * 1e9 / 8)

    @property
    def n_nodes(self) -> int:
        return max(1, self.p.n_nodes)

    @property
    def node_cap(self) -> int:
        return self.p.node_cap or self.p.machine_cap // self.n_nodes

    def init_node(self, nd: Node) -> None:
        nd.pool_avail = nd.pool_target = (
            self.p.pool_min if self.p.adaptive_pool else self.p.pool_size)

    def on_arrival(self, eng: Engine, inv: Invocation, need: int,
                   key: tuple):
        # fleet-wide packing: prefer the instance that already loaded
        # this fid (zero install), then a node holding its snapshot (no
        # transfer), then the fullest instance (pack-first keeps spare
        # capacity drainable)
        best = None
        for cand_nd in eng.nodes:
            for r in cand_nd.insts.get(key, []):
                if r.mem() + need > r.cap:
                    continue
                score = (inv.fid in r.functions_loaded,
                         inv.fid in cand_nd.snapshots, r.mem())
                if best is None or score > best[0]:
                    best = (score, cand_nd, r)
        if best is not None:
            return best[1], best[2], False
        return eng.nodes[0], None, False

    def pick_node(self, eng: Engine, inv: Invocation, need: int):
        # the cluster picks the node: a warm pool slot on the
        # least-loaded pooled node, else a cold boot on the least-loaded
        # node (this is the cross-machine spill). A node "fits" if
        # reclaiming its idle runtimes would make room — the engine's
        # eviction loop does the reclaiming.
        def reclaimable(x: Node) -> int:
            return sum(r.mem() for g in x.insts.values()
                       for r in g if r.live_invocations == 0)

        pool_fit = [x for x in eng.nodes if x.pool_avail > 0
                    and eng.node_mem(x) - reclaimable(x) + need <= x.cap]
        if pool_fit:
            return min(pool_fit, key=eng.node_mem), True
        cold_fit = [x for x in eng.nodes
                    if eng.node_mem(x) - reclaimable(x)
                    + self.base_mem + need <= x.cap]
        return min(cold_fit or eng.nodes, key=eng.node_mem), False

    def install_cost(self, eng: Engine, nd: Node, inv: Invocation) -> float:
        p = self.p
        if inv.fid in nd.snapshots:
            return p.snapshot_restore_s
        if any(inv.fid in x.snapshots for x in eng.nodes):
            # snapshot held only by ANOTHER node: fetch it first — the
            # explicit cross-machine transfer cost
            eng.res.transfers += 1
            return p.snapshot_restore_s + self.transfer_s
        return p.fn_register_s

    def adapt_pool(self, eng: Engine, nd: Node, t: float) -> None:
        """EWMA arrival-rate update + pool retarget: grow toward
        pool_max under bursts, shrink to pool_min when idle, and never
        let pooled slots outgrow the node's free memory."""
        p = self.p
        if not p.adaptive_pool:
            return
        eff = nd.rate
        if nd.last_arrival > float("-inf"):
            gap = max(t - nd.last_arrival, 1e-9)
            nd.rate = (1.0 - p.ewma_alpha) * nd.rate + p.ewma_alpha / gap
            # cap by the latest gap: a long-idle node collapses to the
            # floor immediately instead of riding its stale burst estimate
            eff = min(nd.rate, 1.0 / gap)
        nd.last_arrival = t
        want = min(self.pool_max,
                   max(p.pool_min, math.ceil(eff * p.pool_cover_s)))
        busy = eng.node_mem(nd) - nd.pool_avail * self.base_mem
        want = min(want, max(0, (nd.cap - busy) // self.base_mem))
        nd.pool_target = want
        if nd.pool_avail > want:         # shrink releases memory now
            nd.pool_avail = want
        # growth is urgent (the estimator says a burst is on): back-boot
        # a generic runtime rather than waiting a full re-warm period
        grow_s = p.vm_boot_s + self.runtime_cold_s
        while nd.pool_avail + nd.pool_pending < want:
            nd.pool_pending += 1
            eng.push(t + grow_s, "refill", nd)


# ---------------------------------------------------------------------------
# Registry: name -> model class. Iteration/membership keep the old
# tuple semantics (``for m in MODELS`` / ``model in MODELS``).
MODELS: dict = {
    cls.name: cls
    for cls in (OpenWhiskModel, PhotonsModel, HydraModel, HydraPoolModel,
                HydraClusterModel)
}


def register_model(cls) -> type:
    """Register a PlatformModel subclass (usable as a decorator) so
    ``simulate(trace, cls.name)`` resolves it."""
    if not cls.name:
        raise ValueError("PlatformModel subclass needs a non-empty .name")
    MODELS[cls.name] = cls
    return cls
