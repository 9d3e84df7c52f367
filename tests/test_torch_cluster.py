"""repro_torch HydraCluster: the port's counterparts of tests/test_cluster.py
(cross-node colocation and spill, snapshot migration with its modeled
transfer cost and no new compile, rebalancing, EWMA-adaptive pool
sizing), every one under the lock-order sanitizer (locksan) and the
resource-leak sanitizer (leaksan) over the port's classes. The nodes are
logical, all on the CPU (``device="cpu"``)."""
import contextlib
import sys

import pytest
import torch

import repro_torch.core.arena
import repro_torch.core.platform
import repro_torch.core.runtime
import repro_torch.core.tracing
from repro_torch.core import (AdaptivePoolPolicy, ArrivalRateEstimator,
                              CallableSpec, ClusterParams, HydraCluster,
                              HydraOOMError, PlatformParams, estimate_bytes)
from repro_torch.launch import serve
from tools.hydralint import leaksan, locksan

MB = 1 << 20
GB = 1 << 30


@contextlib.contextmanager
def port_leaksan():
    """leaksan over the port: the sanitizer imports the classes it wraps
    by the reference's module names when it starts, so those names
    resolve to the port's modules while it does."""
    names = {"repro.core.arena": repro_torch.core.arena,
             "repro.core.platform": repro_torch.core.platform,
             "repro.core.runtime": repro_torch.core.runtime,
             "repro.core.tracing": repro_torch.core.tracing}
    san = leaksan.LeakSanitizer()
    saved = {n: sys.modules.get(n) for n in names}
    sys.modules.update(names)
    try:
        patch = san.patched()
        patch.__enter__()
    finally:
        for n, mod in saved.items():
            if mod is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = mod
    try:
        yield san
    finally:
        patch.__exit__(None, None, None)
    san.assert_clean()


@pytest.fixture(autouse=True)
def sanitizers():
    # lock-order inversions and unreturned arena/runtime/trace claims
    # fail the test; each test shuts its cluster down inside
    with locksan.sanitized(), port_leaksan() as san:
        yield san


def spec(name="affine", arena_bytes=1 * MB):
    def fn(params, args):
        return {"y": args["x"] * params["w"] + 1.0}
    return CallableSpec(name=name, fn=fn,
                        example_args={"x": torch.ones(64)},
                        params={"w": torch.full((64,), 2.0)},
                        arena_bytes=arena_bytes)


ARGS = {"x": torch.full((64,), 3.0)}


def make_cluster(tmp_path=None, **kw):
    defaults = dict(
        n_nodes=2,
        node_memory_bytes=64 * MB,
        snapshot_dir=str(tmp_path) if tmp_path is not None else None,
        platform=PlatformParams(pool_size=1, runtime_budget_bytes=32 * MB,
                                device="cpu"))
    defaults.update(kw)
    return HydraCluster(ClusterParams(**defaults))


# ---------------------------------------------------------------------------
def test_sanitizer_wraps_the_port_classes(sanitizers):
    cl = make_cluster()
    try:
        cl.register_function("t0/f", spec(), tenant="t0")
        cl.invoke("t0/f", ARGS)
        kinds = {kind for kind, *_ in sanitizers.outstanding()}
        assert "runtime" in kinds             # the claimed, active runtime
    finally:
        cl.shutdown()


def test_colocation_then_spill_across_nodes():
    need = estimate_bytes(spec())
    cl = make_cluster(node_memory_bytes=2 * need + need // 2)
    try:
        cl.register_function("t0/a", spec("a"), tenant="t0")
        cl.register_function("t0/b", spec("b"), tenant="t0")
        place = cl.placement()
        assert place["t0/a"] == place["t0/b"]
        cl.register_function("t0/c", spec("c"), tenant="t0")
        assert cl.placement()["t0/c"] != place["t0/a"]
        assert cl.metrics.counters["place.colocated"] == 1
        assert cl.metrics.counters["place.spill"] == 1
        cl.register_function("t1/a", spec("a"), tenant="t1")
        assert cl.placement()["t1/a"] == cl.placement()["t0/c"]
        with pytest.raises(HydraOOMError):
            cl.register_function("t2/a", spec("a"), tenant="t2")
    finally:
        cl.shutdown()


def test_invoke_routes_to_owning_node():
    cl = make_cluster()
    try:
        cl.register_function("t0/f", spec(), tenant="t0")
        cl.register_function("t1/f", spec(), tenant="t1")
        out0 = cl.invoke("t0/f", ARGS)
        out1 = cl.invoke("t1/f", ARGS)
        assert float(out0["y"][0]) == float(out1["y"][0]) == 7.0
        assert cl.placement()["t0/f"] != cl.placement()["t1/f"]
        assert all(n.platform.device.type == "cpu" for n in cl.nodes)
    finally:
        cl.shutdown()


def test_migrate_roundtrip_zero_recompile(tmp_path):
    cl = make_cluster(tmp_path)
    try:
        cl.register_function("t0/f", spec(), tenant="t0")
        before = cl.invoke("t0/f", ARGS)
        src = cl.placement()["t0/f"]
        dst = 1 - src
        compiles = cl.exe_cache.stats()["compiles"]
        nbytes = cl.migrate("t0/f", dst)
        assert nbytes > 0
        assert cl.placement()["t0/f"] == dst
        assert (tmp_path / f"node{dst}" / "functions" / "t0__f" /
                "registry.json").exists()
        after = cl.invoke("t0/f", ARGS)
        assert float(after["y"][0]) == float(before["y"][0])
        assert cl.exe_cache.stats()["compiles"] == compiles
        c = cl.metrics.counters
        assert c["migrations"] == 1
        assert c["transfer_bytes"] == nbytes
        assert cl.metrics.hists["transfer_s"].count == 1
        assert cl.metrics.hists["transfer_s"].mean == pytest.approx(
            nbytes / (cl.params.transfer_gbps * 1e9 / 8))
    finally:
        cl.shutdown()


def test_failed_migrate_does_not_orphan_function():
    cl = make_cluster()                   # no snapshot_dir: migration fails
    try:
        cl.register_function("t0/f", spec(), tenant="t0")
        cl.invoke("t0/f", ARGS)
        src = cl.placement()["t0/f"]
        with pytest.raises(Exception):
            cl.migrate("t0/f", 1 - src)
        assert cl.placement()["t0/f"] == src
        out = cl.invoke("t0/f", ARGS)
        assert float(out["y"][0]) == 7.0
    finally:
        cl.shutdown()


def test_rebalance_drains_overloaded_node(tmp_path):
    need = estimate_bytes(spec())
    cl = make_cluster(tmp_path, node_memory_bytes=8 * need)
    try:
        for i in range(4):
            cl.register_function(f"t0/f{i}", spec(f"f{i}"), tenant="t0")
        assert len(set(cl.placement().values())) == 1
        moves = cl.rebalance()
        assert len(moves) == 2            # 4|0 -> 2|2
        committed = [n.committed for n in cl.nodes]
        assert max(committed) - min(committed) <= need
        out = cl.invoke(moves[0][0], ARGS)     # restores lazily
        assert float(out["y"][0]) == 7.0
        assert cl.metrics.counters["rebalance.moves"] == 2
    finally:
        cl.shutdown()


# ---------------------------------------------------------------------------
def test_arrival_rate_estimator_tracks_burst_and_idle():
    est = ArrivalRateEstimator(alpha=0.5)
    assert est.rate() == 0.0
    for i in range(20):                    # 100 arrivals/s burst
        est.observe(i * 0.01)
    assert est.rate() > 50
    assert est.rate(now=0.2 + 10.0) < 1.0


def test_adaptive_policy_grows_shrinks_and_respects_memory():
    pol = AdaptivePoolPolicy(pool_min=1, pool_max=8, cover_s=1.0,
                             runtime_bytes=2 * GB)
    assert pol.target(0.0) == 1
    assert pol.target(3.5) == 4
    assert pol.target(100.0) == 8
    assert pol.target(100.0, free_bytes=5 * GB) == 2
    assert pol.target(100.0, free_bytes=0) == 0


def test_cluster_adaptive_pool_grows_on_burst_shrinks_idle():
    cl = make_cluster(
        n_nodes=1, node_memory_bytes=256 * MB,
        pool_min=1, pool_max=3, resize_every=1, ewma_alpha=0.5,
        pool_cover_s=1.0,
        platform=PlatformParams(pool_size=1, runtime_budget_bytes=8 * MB,
                                refill=False, device="cpu"))
    try:
        cl.register_function("t0/f", spec(), tenant="t0")
        t = 0.0
        for _ in range(8):
            cl.invoke("t0/f", ARGS, now=t)
            t += 0.01
        node = cl.nodes[0]
        assert node.platform.params.pool_size == 3
        free = cl.params.node_memory_bytes - node.committed
        assert (node.platform.params.pool_size
                * cl.params.platform.runtime_budget_bytes) <= free
        cl.invoke("t0/f", ARGS, now=t + 100.0)
        assert node.platform.params.pool_size == cl.params.pool_min
    finally:
        cl.shutdown()


def test_cluster_adaptive_pool_capped_by_node_memory():
    need = estimate_bytes(spec())
    cl = make_cluster(
        n_nodes=1, node_memory_bytes=need + 12 * MB,
        pool_min=1, pool_max=8, resize_every=1, ewma_alpha=0.5,
        pool_cover_s=10.0,
        platform=PlatformParams(pool_size=1, runtime_budget_bytes=8 * MB,
                                refill=False, device="cpu"))
    try:
        cl.register_function("t0/f", spec(), tenant="t0")
        t = 0.0
        for _ in range(8):
            cl.invoke("t0/f", ARGS, now=t)
            t += 0.001
        assert cl.nodes[0].platform.params.pool_size == 1
    finally:
        cl.shutdown()


def test_observe_arrival_feeds_adaptive_sizing_for_direct_routing():
    """serve's batchers talk to runtimes directly and report each arrival
    through observe_arrival, which drives the same pool resizing."""
    cl = make_cluster(
        n_nodes=1, node_memory_bytes=256 * MB, pool_min=1, pool_max=3,
        resize_every=1, pool_cover_s=1.0,
        platform=PlatformParams(pool_size=1, runtime_budget_bytes=8 * MB,
                                refill=False, device="cpu"))
    try:
        cl.register_function("t0/f", spec(), tenant="t0", eager=True)
        rt = cl.runtime_for("t0/f")
        for i in range(8):
            cl.observe_arrival("t0/f", now=i * 0.01)
            rt.invoke("t0/f", ARGS)
        assert cl.nodes[0].platform.params.pool_size == 3
        assert cl.metrics.counters["pool.resize"] >= 1
    finally:
        cl.shutdown()


def test_serve_through_cluster_of_two_nodes(tmp_path):
    stats = serve.main(["--device", "cpu", "--nodes", "2", "--pool", "1",
                        "--node-memory-gb", "0.001", "--snapshot-dir",
                        str(tmp_path), "--archs", "qwen2.5-3b,mamba2-780m",
                        "--tenants", "2", "--requests", "4", "--max-new", "3",
                        "--prompt-len", "5"])
    assert stats["tokens"] == 4 * 3
    assert stats["n_nodes"] == 2 and stats["functions_known"] == 2
    # a 1 MB node holds one reduced function: the second spills to node 1
    assert [n["functions_placed"] for n in stats["nodes"]] == [1, 1]
    assert stats["exe_cache"]["compiles"] == 4


def test_migrate_over_commits_destination_as_reference_does(tmp_path):
    """``migrate`` does not re-check the destination's placement budget,
    in the reference as in the port: moving a function into a node that
    is already near its budget leaves that node over-committed. Pinned in
    both packages, so that changing it is a visible decision."""
    import jax.numpy as jnp

    from repro.core import CallableSpec as JCallableSpec
    from repro.core import ClusterParams as JClusterParams
    from repro.core import HydraCluster as JHydraCluster
    from repro.core import PlatformParams as JPlatformParams
    from repro.core.platform import estimate_bytes as jestimate_bytes

    def jspec(name):
        return JCallableSpec(
            name=name, fn=lambda p, a: {"y": a["x"] * p["w"] + 1.0},
            example_args={"x": jnp.ones(64)},
            params={"w": jnp.full((64,), 2.0)}, arena_bytes=1 * MB)

    def over_commit(cluster_cls, params_cls, plat_cls, make_spec, need,
                    root):
        cap = 2 * need + need // 2
        cl = cluster_cls(params_cls(
            n_nodes=2, node_memory_bytes=cap, snapshot_dir=str(root),
            platform=plat_cls(pool_size=1, runtime_budget_bytes=32 * MB,
                              **({"device": "cpu"}
                                 if plat_cls is PlatformParams else {}))))
        try:
            for fid in ("t0/a", "t0/b", "t1/c"):
                cl.register_function(fid, make_spec(fid[-1]),
                                     tenant=fid[:2])
            full = cl.placement()["t0/a"]
            assert cl.placement()["t0/b"] == full
            assert cl.placement()["t1/c"] != full
            cl.migrate("t1/c", full)
            assert cl.placement()["t1/c"] == full
            committed = cl.nodes[full].committed
            assert committed == 3 * need > cap
            return committed / need
        finally:
            cl.shutdown()

    got = over_commit(HydraCluster, ClusterParams, PlatformParams, spec,
                      estimate_bytes(spec()), tmp_path / "port")
    want = over_commit(JHydraCluster, JClusterParams, JPlatformParams, jspec,
                       jestimate_bytes(jspec("a")), tmp_path / "ref")
    assert got == want == 3
