"""The port's live serving gateway (``repro_torch.gateway``) on the CPU.

* The reference's own tests/test_gateway.py, all of it, executed against
  the port (``port_tests``). The port runs on CUDA unless a device is
  given, so those tests' platforms and ``run_validation`` calls are
  pinned to the CPU by a source substitution; nothing else changes.
* Deterministic parity with ``repro.gateway`` on one trace: the
  registered names, tenants and arena sizes, ``sim_params_for_live``,
  the ``y`` of every invocation (bit-equal in fp32), and the executable
  warm-up reaching every cache of a CPU platform and a CPU cluster.
* ``repro_torch.launch.serve`` in gateway mode, ``--round-trip`` and
  ``--calibration``, and ``python -m repro_torch.gateway.validate``.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from port_tests import bind, port_tests
from repro.core.platform import HydraPlatform as JPlatform
from repro.core.platform import PlatformParams as JPlatformParams
from repro.core.traces import Invocation as JInvocation
from repro.core.traces import Trace as JTrace
from repro.gateway import ReplayConfig as JReplayConfig
from repro.gateway import TraceWorkload as JTraceWorkload
from repro.gateway import sim_params_for_live as jsim_params_for_live
from repro.gateway import wrap_target as jwrap_target
from repro.gateway.replay import build_workload as jbuild_workload
from repro.launch import serve as jserve
from repro_torch.core.calibrate import apply_calibration, load_calibration
from repro_torch.core.cluster import ClusterParams, HydraCluster
from repro_torch.core.platform import HydraPlatform, PlatformParams
from repro_torch.core.sim import SimParams
from repro_torch.core.traces import Invocation, Trace
from repro_torch.gateway import (ReplayConfig, TraceWorkload,
                                 sim_params_for_live, wrap_target)
from repro_torch.gateway.replay import build_workload, warm_executables
from repro_torch.launch import serve

ROOT = Path(__file__).resolve().parents[1]
MB = 1 << 20

bind(globals(), port_tests(
    "test_gateway",
    replace=(("PlatformParams(", 'PlatformParams(device="cpu", '),
             ("run_validation(trace, ", 'run_validation(trace, device="cpu", '))))


def trace_pair(n=24, n_fns=6, n_tenants=3):
    """The same synthetic trace in both packages: varied functions,
    tenants and memory sizes, so weights, payloads and arenas differ."""
    rows = [dict(t=i * 0.5, fid=(7 * i) % n_fns, tenant=((7 * i) % n_fns)
                 % n_tenants, duration_s=0.2,
                 mem_bytes=(60 + 40 * ((7 * i) % n_fns)) * MB)
            for i in range(n)]
    return (Trace(invocations=tuple(Invocation(**r) for r in rows),
                  source="synthetic"),
            JTrace(invocations=tuple(JInvocation(**r) for r in rows),
                   source="synthetic"))


def platform_params(cls, **kw):
    kw.setdefault("pool_size", 1)
    kw.setdefault("runtime_budget_bytes", 64 * MB)
    kw.setdefault("n_workers", 2)
    kw.setdefault("janitor", False)
    return cls(**kw)


# ---------------------------------------------------------------------------
def test_reference_gateway_tests_are_bound_to_the_port():
    src = (ROOT / "tests" / "test_gateway.py").read_text()
    ref = re.findall(r"^def (test_\w+)", src, flags=re.M)
    assert len(ref) == 21 and set(ref) <= set(globals())
    assert test_round_trip_reproduces_live_cold_starts.__globals__[  # noqa: F821
        "run_validation"].__module__ == "repro_torch.gateway.validate"


@pytest.mark.parametrize("budget", [None, 64 * MB])
def test_workload_registration_matches_reference(budget):
    """Names, tenants and arena bytes of every fid, with no arena cap
    (a workload with no budget) and with ``build_workload``'s cap on a
    budgeted platform."""
    trace, jtrace = trace_pair()
    plat = HydraPlatform(platform_params(PlatformParams, device="cpu"))
    jplat = JPlatform(platform_params(JPlatformParams))
    try:
        cfg, jcfg = ReplayConfig(), JReplayConfig()
        if budget is None:
            wl, jwl = TraceWorkload(), JTraceWorkload()
        else:
            wl = build_workload(wrap_target(plat), cfg)
            jwl = jbuild_workload(jwrap_target(jplat), jcfg)
            assert wl.max_arena_bytes == jwl.max_arena_bytes is not None
        assert wl.min_arena_bytes == jwl.min_arena_bytes
        assert wl.register_all(trace, wrap_target(plat)) == \
            jwl.register_all(jtrace, jwrap_target(jplat))
        assert wl.registered == jwl.registered
        for inv in trace:
            got = wl.spec_for(inv.fid, inv.mem_bytes)
            want = jwl.spec_for(inv.fid, inv.mem_bytes)
            assert got.arena_bytes == want.arena_bytes
            assert got.name == want.name
        assert sorted(plat.placement()) == sorted(jplat.placement())
    finally:
        plat.shutdown()
        jplat.shutdown()


def test_sim_params_for_live_matches_reference():
    trace, jtrace = trace_pair()
    got = sim_params_for_live(trace, pool_size=3,
                              live_runtime_budget=32 * MB,
                              mem_scale=1 / 64, base=SimParams())
    want = jsim_params_for_live(jtrace, pool_size=3,
                                live_runtime_budget=32 * MB,
                                mem_scale=1 / 64)
    got, want = dataclasses.asdict(got), dataclasses.asdict(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k


def test_invocation_outputs_equal_reference_exactly():
    """Every invocation of a 24-invocation trace, with ``args_for``'s host
    numpy payload, through the port's platform on the CPU and through the
    reference's platform: the same fp32 ``y``, bit for bit."""
    trace, jtrace = trace_pair()
    plat = HydraPlatform(platform_params(PlatformParams, device="cpu"))
    jplat = JPlatform(platform_params(JPlatformParams))
    try:
        wl = build_workload(wrap_target(plat), ReplayConfig())
        jwl = jbuild_workload(jwrap_target(jplat), JReplayConfig())
        wl.register_all(trace, wrap_target(plat))
        jwl.register_all(jtrace, jwrap_target(jplat))
        for inv, jinv in zip(trace, jtrace):
            args = wl.args_for(inv)
            assert isinstance(args["x"], np.ndarray)
            y = plat.invoke(wl.name_for(inv), args)["y"]
            want = np.asarray(jplat.invoke(jwl.name_for(jinv),
                                           jwl.args_for(jinv))["y"])
            assert y.dtype.is_floating_point and str(y.dtype) == \
                "torch.float32"
            assert np.array_equal(y.numpy(), want)
    finally:
        plat.shutdown()
        jplat.shutdown()


@pytest.mark.parametrize("kind", ["platform", "cluster"])
def test_warm_executables_warms_every_cache_on_the_cpu(kind, tmp_path):
    trace, _ = trace_pair()
    if kind == "platform":
        target = HydraPlatform(platform_params(PlatformParams, device="cpu"))
    else:
        target = HydraCluster(ClusterParams(
            n_nodes=2, node_memory_bytes=256 * MB, share_exe_cache=False,
            platform=platform_params(PlatformParams, device="cpu")))
    try:
        adapter = wrap_target(target)
        assert adapter.target.device.type == "cpu"
        wl = build_workload(adapter, ReplayConfig())
        caches = adapter.exe_caches()
        assert len(caches) == (1 if kind == "platform" else 2)
        assert warm_executables(adapter, wl, trace) == len(caches)
        for cache in caches:
            assert cache.stats()["compiles"] == 1
    finally:
        target.shutdown()


# ---------------------------------------------------------------------------
GW = ["--device", "cpu", "--gateway", "--compress", "120"]


def assert_warmed(warm: dict, exe_cache: dict) -> None:
    """The replay's warm-up reached every cache, and nothing compiled on
    the clock."""
    assert warm["caches"] >= 1 and not warm["errors"]
    assert warm["warmed"] == warm["caches"]
    assert exe_cache["compiles"] == sum(warm["compiles_before_clock"])


def test_serve_gateway_on_cpu_accounts_every_request():
    out = serve.main(GW)
    ex = out["extras"]
    assert ex["submitted"] > 0 and not ex["errors"]
    assert_warmed(ex["warm"], ex["exe_cache"])
    assert out["requests"] + out["dropped"] == ex["submitted"]
    assert out["model"] == "live-platform"


def test_serve_gateway_cluster_on_cpu(tmp_path):
    out = serve.main(GW + ["--nodes", "2", "--snapshot-dir", str(tmp_path)])
    ex = out["extras"]
    assert not ex["errors"] and out["n_nodes"] == 2
    assert out["requests"] + out["dropped"] == ex["submitted"]
    assert "balancer" in ex
    assert_warmed(ex["warm"], ex["exe_cache"])


def test_serve_round_trip_returns_the_report():
    report = serve.main(GW + ["--pool", "2", "--round-trip"])
    assert report["ok"] and "calibration" in report
    assert set(report["gates"]) == {"cold_runtime", "p99_s"}
    rt = report["round_trip"]
    assert rt["cold_runtime"]["passed"] and rt["p99_s"]["passed"]
    assert_warmed(report["extras"]["warm"], report["extras"]["exe_cache"])


def test_serve_gateway_calibration_round_trips(tmp_path):
    path, jpath = tmp_path / "cal.json", tmp_path / "jcal.json"
    serve.main(GW + ["--calibration", str(path)])
    jserve.main(["--gateway", "--compress", "120",
                 "--calibration", str(jpath)])
    doc, jdoc = (json.loads(p.read_text()) for p in (path, jpath))
    assert doc["schema"] == jdoc["schema"] == "hydra-calibration/v1"
    assert sorted(doc["measured"]) == sorted(jdoc["measured"])
    assert_warmed(doc["meta"]["warm"], doc["meta"]["exe_cache"])
    measured = load_calibration(str(path))
    assert apply_calibration(SimParams(), measured) != SimParams()


def test_serve_closed_loop_calibration(tmp_path):
    path, jpath = tmp_path / "cal.json", tmp_path / "jcal.json"
    flags = ["--pool", "1", "--tenants", "1", "--requests", "1",
             "--max-new", "2", "--prompt-len", "4", "--calibration"]
    serve.main(["--device", "cpu", *flags, str(path)])
    jserve.main([*flags, str(jpath)])
    doc, jdoc = (json.loads(p.read_text()) for p in (path, jpath))
    assert doc["schema"] == jdoc["schema"] == "hydra-calibration/v1"
    assert doc["meta"] == jdoc["meta"] == {"source": "serve"}
    # a platform boots its pool and registers; no snapshot, no restore
    assert sorted(doc["measured"]) == sorted(jdoc["measured"]) == [
        "fn_register_s", "hydra_runtime_cold_s"]
    apply_calibration(SimParams(), load_calibration(str(path)))


def test_validate_cli_on_cpu_and_refuses_without_gpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "repro_torch.gateway.validate",
           "--compress", "120", "--pool", "2"]
    ok = subprocess.run(cmd + ["--device", "cpu", "--json"], env=env,
                        cwd=ROOT, capture_output=True, text=True,
                        timeout=300)
    assert ok.returncode == 0, ok.stderr[-2000:]
    assert '"ok": true' in ok.stdout
    # no device named: CUDA, which is not there, so it raises instead of
    # falling back to the CPU
    bad = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert bad.returncode != 0 and "no GPU" in bad.stderr
