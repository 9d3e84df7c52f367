"""repro_torch HydraPlatform: the port's counterparts of
tests/test_platform.py (pre-warmed pool claim/refill/return, colocation
until the budget saturates, snapshot -> evict -> restore with no new
compile, persisted program records across platform boots), placement
estimates equal to the reference's, LM evict/restore with identical
greedy tokens for the three served families, and the platform's spans
and bounded histograms. All on the CPU (``device="cpu"``)."""
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import CallableSpec as JCallableSpec
from repro.core import LMSpec as JLMSpec
from repro.core.platform import estimate_bytes as jestimate_bytes
from repro.models.programs import ModelProgram as JProgram
from repro_torch.configs import get_config
from repro_torch.core import (CallableSpec, FunctionNotRegisteredError,
                              HydraError, HydraOOMError, HydraPlatform, LMSpec,
                              PlatformParams, estimate_bytes)
from repro_torch.core.tracing import Tracer
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.programs import ModelProgram

MB = 1 << 20


def spec(name="affine", arena_bytes=1 * MB):
    def fn(params, args):
        return {"y": args["x"] * params["w"] + 1.0}
    return CallableSpec(name=name, fn=fn,
                        example_args={"x": torch.ones(64)},
                        params={"w": torch.full((64,), 2.0)},
                        arena_bytes=arena_bytes)


ARGS = {"x": torch.full((64,), 3.0)}


def platform(**kw):
    kw.setdefault("device", "cpu")
    return HydraPlatform(**kw)


def wait_for(pred, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


# ---------------------------------------------------------------------------
def test_platform_without_gpu_or_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        HydraPlatform(pool_size=0)


def test_pool_claim_refill_and_return(tmp_path):
    plat = platform(pool_size=2, runtime_budget_bytes=64 * MB,
                    snapshot_dir=str(tmp_path))
    try:
        assert plat.pool_available == 2
        assert all(rt.device.type == "cpu" for rt in plat.runtimes())
        plat.register_function("t0/f", spec(), tenant="t0")
        assert plat.stats()["functions_placed"] == 0      # lazy placement
        out = plat.invoke("t0/f", ARGS)      # first invocation claims a
        assert float(out["y"][0]) == 7.0     # pre-warmed instance
        c = plat.metrics.counters
        assert c["pool.claim"] == 1 and c.get("pool.miss", 0) == 0
        assert wait_for(lambda: plat.pool_available == 2)   # background
        plat.evict("t0/f")
        assert plat.stats()["runtimes_active"] == 0
        assert plat.pool_available == 2
    finally:
        plat.shutdown()


def test_pool_return_without_refill(tmp_path):
    plat = platform(pool_size=1, runtime_budget_bytes=64 * MB,
                    snapshot_dir=str(tmp_path), refill=False)
    try:
        plat.register_function("t0/f", spec(), tenant="t0")
        plat.invoke("t0/f", ARGS)
        assert plat.pool_available == 0      # claimed, no refill
        plat.evict("t0/f")
        assert plat.pool_available == 1      # emptied runtime returned
        assert plat.metrics.counters["pool.return"] == 1
    finally:
        plat.shutdown()


def test_refill_thread_bookkeeping_pruned_on_claim():
    # a 4 MB runtime holds ONE ~3 MB function: every placement spills
    plat = platform(pool_size=1, runtime_budget_bytes=4 * MB)
    try:
        for i in range(4):
            plat.register_function(f"t{i}/f",
                                   spec(arena_bytes=int(1.5 * MB)),
                                   tenant=f"t{i}")
            plat.invoke(f"t{i}/f", ARGS)
            assert wait_for(lambda: plat.pool_available == 1)
        assert plat.refill_backlog <= 2
    finally:
        plat.shutdown()


def test_colocation_packs_until_budget_saturates():
    # the same arithmetic as the reference's test: ~3 MB estimate per
    # function, 1.5 MB actual growth per colocated one, a 7 MB runtime
    # admits two and the third spills
    plat = platform(pool_size=1, runtime_budget_bytes=7 * MB)
    try:
        for i in range(3):
            plat.register_function(f"t{i}/f", spec(arena_bytes=int(1.5 * MB)),
                                   tenant=f"t{i}")
            plat.invoke(f"t{i}/f", ARGS)
        c = plat.metrics.counters
        assert c["place.spill"] == 2         # first claim + saturation spill
        assert c["place.colocated"] == 1     # second fn packed with first
        assert plat.stats()["runtimes_active"] == 2
        place = plat.placement()
        assert place["t0/f"] == place["t1/f"] != place["t2/f"]
    finally:
        plat.shutdown()


def test_register_rejects_function_above_runtime_budget():
    plat = platform(pool_size=0, runtime_budget_bytes=2 * MB)
    try:
        with pytest.raises(HydraOOMError):
            plat.register_function("t0/f", spec(arena_bytes=4 * MB))
        assert plat.stats()["functions_known"] == 0
    finally:
        plat.shutdown()


def test_snapshot_evict_restore_roundtrip_no_recompile(tmp_path):
    plat = platform(pool_size=1, runtime_budget_bytes=64 * MB,
                    snapshot_dir=str(tmp_path))
    try:
        plat.register_function("t0/f", spec(), tenant="t0")
        before = plat.invoke("t0/f", ARGS)
        plat.snapshot("t0/f")
        plat.evict("t0/f")
        with pytest.raises(FunctionNotRegisteredError):
            plat.runtime_for("t0/f").invoke("t0/f", ARGS)
        compiles = plat.exe_cache.stats()["compiles"]
        plat.restore("t0/f")
        after = plat.invoke("t0/f", ARGS)
        assert float(after["y"][0]) == float(before["y"][0])
        assert plat.exe_cache.stats()["compiles"] == compiles
        assert plat.metrics.counters["restores"] == 1
    finally:
        plat.shutdown()


def test_evict_requires_snapshot_dir():
    plat = platform(pool_size=1, runtime_budget_bytes=64 * MB)
    try:
        plat.register_function("t0/f", spec(), tenant="t0")
        plat.invoke("t0/f", ARGS)
        with pytest.raises(HydraError):
            plat.snapshot("t0/f")
        plat.evict("t0/f", snapshot=False)
        assert plat.stats()["functions_placed"] == 0
        with pytest.raises(HydraError):
            plat.restore("t0/f")             # nothing to restore from
    finally:
        plat.shutdown()


def test_persist_executables_defaults_on_with_snapshot_dir(tmp_path):
    plat = platform(pool_size=1, runtime_budget_bytes=64 * MB,
                    snapshot_dir=str(tmp_path))
    assert plat.exe_cache.persist_dir is not None
    plat.shutdown()
    plat = platform(pool_size=1, runtime_budget_bytes=64 * MB)
    assert plat.exe_cache.persist_dir is None
    plat.shutdown()
    plat = platform(pool_size=1, runtime_budget_bytes=64 * MB,
                    snapshot_dir=str(tmp_path), persist_executables=False)
    assert plat.exe_cache.persist_dir is None
    plat.shutdown()


def test_snapshot_restore_zero_recompile_across_platform_boots(tmp_path):
    plat = platform(pool_size=1, runtime_budget_bytes=64 * MB,
                    snapshot_dir=str(tmp_path))
    try:
        plat.register_function("t0/f", spec(), tenant="t0")
        before = plat.invoke("t0/f", ARGS)
        exported = plat.export_function("t0/f")
    finally:
        plat.shutdown()
    # one program: the reference's 2 include its compiled arena zeroer;
    # the port scrubs slabs with an in-place zero_(), which needs none
    assert plat.exe_cache.stats()["compiles"] == 1
    records = list((tmp_path / "executables").glob("exe_*.json"))
    assert len(records) == 1

    fresh = platform(pool_size=1, runtime_budget_bytes=64 * MB,
                     snapshot_dir=str(tmp_path))
    try:
        fresh.import_function(exported)
        fresh.restore("t0/f")
        after = fresh.invoke("t0/f", ARGS)
        assert float(after["y"][0]) == float(before["y"][0])
        stats = fresh.exe_cache.stats()
        assert stats["compiles"] == 0          # zero-recompile restore
        assert stats["disk_hits"] >= 1         # the persisted record held
        assert stats["xla_cache_enabled"] is False
    finally:
        fresh.shutdown()


@pytest.mark.parametrize("damage", ["missing", "stale", "unreadable"])
def test_bad_program_record_counts_a_compile_and_is_rewritten(tmp_path,
                                                              damage):
    plat = platform(pool_size=1, runtime_budget_bytes=64 * MB,
                    snapshot_dir=str(tmp_path))
    try:
        plat.register_function("t0/f", spec(), tenant="t0")
        plat.invoke("t0/f", ARGS)
        exported = plat.export_function("t0/f")
    finally:
        plat.shutdown()
    (record,) = (tmp_path / "executables").glob("exe_*.json")
    good = record.read_text()
    if damage == "missing":
        record.unlink()
    elif damage == "stale":
        record.write_text(good.replace("affine", "another"))
    else:
        record.write_text(good[:7])
    fresh = platform(pool_size=1, runtime_budget_bytes=64 * MB,
                     snapshot_dir=str(tmp_path))
    try:
        fresh.import_function(exported)
        fresh.restore("t0/f")
        assert float(fresh.invoke("t0/f", ARGS)["y"][0]) == 7.0
        stats = fresh.exe_cache.stats()
        assert (stats["compiles"], stats["disk_hits"]) == (1, 0)
    finally:
        fresh.shutdown()
    assert record.read_text() == good


# ---------------------------------------------------------------------------
def ref_and_port_lm_specs(arch="qwen2.5-3b"):
    jcfg = jget_config(arch).reduced()
    jparams = jax.tree.map(lambda x: x.astype("bfloat16"),
                           JProgram(jcfg).init(jax.random.PRNGKey(0)))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return (JLMSpec(cfg=jcfg, params=jparams, max_seq=64, slots=2),
            LMSpec(cfg=get_config(arch).reduced(), params=tparams,
                   max_seq=64, slots=2))


@pytest.mark.parametrize("kind", ["callable", "lm"])
def test_estimate_bytes_matches_reference(kind):
    if kind == "lm":
        jspec, tspec = ref_and_port_lm_specs()
    else:
        jspec = JCallableSpec(
            name="affine", fn=None,
            example_args={"x": np.ones((64,), np.float32)},
            params={"w": np.full((64,), 2.0, np.float32)},
            arena_bytes=3 * MB)
        tspec = spec(arena_bytes=3 * MB)
    assert estimate_bytes(tspec) == jestimate_bytes(jspec) > 0


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-780m", "zamba2-2.7b"])
def test_lm_snapshot_restore_serves_without_recompiling(tmp_path, arch):
    """bf16 weights checkpoint through ft/checkpoint; the restored function
    generates identical greedy tokens with no new program built (decode
    and the lazily built prefill both hit the shared cache), and every
    restored leaf is bit-equal to the registered one."""
    cfg = get_config(arch).reduced()
    params = ModelProgram(cfg).init(0, device="cpu", dtype=torch.bfloat16)
    kept = {k: v.clone() for k, v in params.items()
            if isinstance(v, torch.Tensor)}
    plat = platform(pool_size=1, runtime_budget_bytes=2 << 30,
                    snapshot_dir=str(tmp_path))
    try:
        plat.register_function("t0/lm", LMSpec(cfg=cfg, params=params,
                                               max_seq=64, slots=1),
                               tenant="t0")
        before = plat.generate("t0/lm", list(range(8)), max_new_tokens=5)
        plat.evict("t0/lm")                   # snapshots, then deregisters
        assert plat._record("t0/lm").spec.params is None
        compiles = plat.exe_cache.stats()["compiles"]
        plat.restore("t0/lm")
        after = plat.generate("t0/lm", list(range(8)), max_new_tokens=5)
        assert after == before
        assert plat.exe_cache.stats()["compiles"] == compiles
        restored = plat._record("t0/lm").spec.params
        for k, v in kept.items():
            assert torch.equal(restored[k].view(torch.int16),
                               v.view(torch.int16))
        assert plat.metrics.hists["restore_s"].count == 1
    finally:
        plat.shutdown()


def test_platform_spans_and_bounded_histograms(tmp_path):
    """A traced first invocation records the pool claim and the code
    install; a traced restore records its snapshot read. The histogram
    bound reaches the platform's metrics and every runtime it boots."""
    tracer = Tracer(1.0, seed=0)
    plat = platform(pool_size=1, runtime_budget_bytes=64 * MB,
                    snapshot_dir=str(tmp_path), hist_max_samples=4)
    try:
        plat.register_function("t0/f", spec(), tenant="t0")
        ctx = tracer.start_request("t0/f", tenant="t0")
        try:
            plat.invoke("t0/f", ARGS, ctx)
        finally:
            ctx.finish("ok")
        plat.evict("t0/f")
        ctx = tracer.start_request("t0/f", tenant="t0")
        try:
            plat.restore("t0/f", ctx=ctx)
            plat.invoke("t0/f", ARGS, ctx)
        finally:
            ctx.finish("ok")
        first, second = tracer.traces()
        names = [sp["name"] for sp in first["spans"]]
        for name in ("pool_claim", "register", "arena_acquire", "compute"):
            assert name in names
        claim = next(sp for sp in first["spans"] if sp["name"] == "pool_claim")
        assert claim["attrs"]["source"] == "pool"
        assert "restore" in [sp["name"] for sp in second["spans"]]
        for _ in range(10):
            plat.invoke("t0/f", ARGS)
        # the restored function may land on a fresh pooled runtime
        lat = plat.runtime_for("t0/f").metrics.hists["invoke_latency_s"]
        assert lat.count >= 11 and len(lat._copy()) == 4
        assert plat.metrics.hists["pool_claim_s"].count == 2
        assert plat.metrics._hist_max == 4
    finally:
        plat.shutdown()


def test_serve_through_platform_pool_with_snapshots(tmp_path):
    stats = serve.main(["--device", "cpu", "--pool", "2", "--snapshot-dir",
                        str(tmp_path), "--archs", "qwen2.5-3b,mamba2-780m",
                        "--tenants", "3", "--requests", "6", "--max-new", "3",
                        "--prompt-len", "5"])
    assert stats["tokens"] == 6 * 3
    assert stats["functions_placed"] == stats["functions_known"] == 3
    counters = stats["metrics"]["counters"]
    assert counters["pool.claim"] >= 1
    assert counters["place.colocated"] >= 1      # tenants packed together
    # decode per family + one prefill length per family
    assert stats["exe_cache"]["compiles"] == 4
    assert len(list((tmp_path / "executables").glob("exe_*.json"))) == 4
