"""Reproduce the paper's Azure-trace experiment (Figures 9/10) through
the PyTorch/CUDA port's copy of the simulator: memory-over-time and
latency percentiles for OpenWhisk / Photons / Hydra runtime models on a
synthetic Shahrad-calibrated trace, plus the multi-node cluster layer vs
a statically partitioned fleet, plus a replay of a real Azure Functions
2019-format trace (the bundled ``benchmarks/data/azure_sample.csv`` by
default). The simulator runs on the host: there is no device.

  PYTHONPATH=src python examples/torch_trace_replay.py [azure_trace.csv]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core.tracesim import (GB, MB, SimParams,  # noqa: E402
                                       Trace, discover_azure_tables,
                                       gen_trace, simulate,
                                       simulate_partitioned)

# the Azure replay's fleet-pressure regime (the reference's
# benchmarks/bench_trace.py AZURE_PARAMS): the single-node fixed pool is
# sized for the fleet's peak warm capacity (pool_size = n_nodes *
# pool_max) while the cluster's EWMA policy floats between pool_min and
# pool_max per node
AZURE_PARAMS = dict(runtime_cap=192 * MB, machine_cap=3 * GB, n_nodes=4,
                    pool_size=8, pool_min=1, pool_max=2)
AZURE_SAMPLE = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "benchmarks", "data",
    "azure_sample.csv"))


def sparkline(samples, width=60):
    vals = [m for _, m in samples]
    if not vals:
        return ""
    step = max(1, len(vals) // width)
    vals = vals[::step][:width]
    top = max(vals) or 1
    blocks = " ▁▂▃▄▅▆▇█"
    return "".join(blocks[int(v / top * (len(blocks) - 1))] for v in vals)


def main():
    trace = gen_trace()
    params = SimParams()
    n_fns = len({i.fid for i in trace})
    n_tenants = len({i.tenant for i in trace})
    print(f"trace: {len(trace)} invocations over {trace[-1].t:.0f}s, "
          f"{n_fns} fns, {n_tenants} tenants (default Azure-calibrated)\n")
    results = {}
    for model in ("openwhisk", "photons", "hydra", "hydra-pool"):
        r = simulate(trace, model, params)
        results[model] = r
        s = r.summary()
        print(f"== {model}")
        print(f"   mem  {sparkline(r.mem_samples)}")
        print(f"   mean_mem={s['mean_mem_mb']:.0f}MB "
              f"peak={s['peak_mem_mb']:.0f}MB "
              f"runtimes={s['mean_runtimes']:.1f} "
              f"cold_rt={s['cold_runtime']}")
        print(f"   p50={s['p50_s']:.3f}s p99={s['p99_s']:.3f}s "
              f"platform_overhead_p99={s['overhead_p99_ms']:.1f}ms\n")
    ow = results["openwhisk"].summary()
    hy = results["hydra"].summary()
    hp = results["hydra-pool"].summary()
    print(f"hydra vs openwhisk: memory -"
          f"{100*(1-hy['mean_mem_mb']/ow['mean_mem_mb']):.0f}% "
          f"(paper: -83%), platform-overhead p99 -"
          f"{100*(1-hy['overhead_p99_ms']/ow['overhead_p99_ms']):.0f}% "
          f"(paper: e2e p99 -68%)")
    print(f"platform pool vs hydra: cold starts {hp['cold_runtime']} vs "
          f"{hy['cold_runtime']}, p99 -"
          f"{1e3*(hy['p99_s']-hp['p99_s']):.1f}ms, memory -"
          f"{100*(1-hp['mean_mem_mb']/hy['mean_mem_mb']):.0f}%")

    # cluster layer under fleet pressure (budgets scaled with the trace —
    # see docs/benchmarks.md): 4-node cluster vs 4 independent
    # statically-partitioned hydra-pool nodes at equal aggregate memory
    fp = SimParams(n_nodes=4, runtime_cap=192 * MB, machine_cap=3 * GB)
    cl = simulate(trace, "hydra-cluster", fp)
    st = simulate_partitioned(trace, 4, fp)
    print(f"\n== hydra-cluster (4 nodes, 3 GB fleet)")
    print(f"   mem  {sparkline(cl.mem_samples)}")
    print(f"cluster vs static partition: cold starts "
          f"{cl.cold_runtime_starts} vs {st.cold_runtime_starts}, "
          f"p99 {cl.p(99):.3f}s vs {st.p(99):.3f}s, ops/GB-sec "
          f"{cl.ops_per_gb_s():.2f} vs {st.ops_per_gb_s():.2f}, "
          f"snapshot transfers {cl.transfers}")

    # real Azure Functions 2019-format replay (bundled sample, or any
    # trace passed on the command line); sibling durations/memory tables
    # are auto-discovered
    path = sys.argv[1] if len(sys.argv) > 1 else AZURE_SAMPLE
    if not os.path.exists(path):
        if len(sys.argv) > 1:
            sys.exit(f"trace file not found: {path}")
        return                         # bundled sample absent: skip leg
    azure = Trace.from_azure(path, **discover_azure_tables(path))
    print(f"\n== azure replay: {azure.describe()}")
    # the fleet-pressure, adaptive-vs-fixed-at-equal-peak regime that
    # the reference's benchmark rows use
    ap = SimParams(**AZURE_PARAMS)
    for model in ("hydra", "hydra-pool", "hydra-cluster"):
        r = simulate(azure, model, ap)
        print(f"   {model:14s} ops/GB-sec={r.ops_per_gb_s():.2f} "
              f"mean_mem={r.mean_mem()/MB:.0f}MB "
              f"cold_rt={r.cold_runtime_starts} p99={r.p(99):.3f}s")


if __name__ == "__main__":
    main()
