"""Live serving gateway: wall-clock trace replay against the real Hydra
stack (the port of ``repro.gateway``, on the device of the stack it
fronts: CUDA unless the stack was built with ``device="cpu"``).

Everything before this package measured the live stack with closed-loop
synthetic drivers and projected trace behaviour through the
discrete-event simulator (``repro_torch.core.sim``). The gateway closes the
gap: it replays a ``Trace`` (synthetic or Azure Functions 2019 CSV)
**open-loop in wall-clock time** — with a compression knob so a trace
minute replays in a second — against a real ``HydraRuntime``,
``HydraPlatform``, or ``HydraCluster``, and reports results in the
simulator's own ``SimResult`` schema so live and simulated replays diff
metric-by-metric (``repro_torch.gateway.validate``).

Pieces (one module each):

  * ``targets``  — adapters normalizing the three live stacks;
  * ``workload`` — trace fids materialized as real registered functions;
  * ``gateway``  — the front door: per-function routing, bounded
    per-tenant queues, token-bucket admission, SLO timeouts, worker
    threads; plus the platform ``Autoscaler``
    (``ArrivalRateEstimator`` -> ``AdaptivePoolPolicy`` ->
    ``resize_pool``) and the cluster ``ClusterBalancer`` (per-node
    commit spread + queue depth -> ``HydraCluster.rebalance()``
    mid-burst);
  * ``loadgen``  — open-loop arrival scheduling on the wall clock,
    optionally tenant-sharded across threads for high-compression
    replays (``ShardedLoadGenerator``);
  * ``recorder`` — live metrics -> ``SimResult``; the
    ``CalibrationProbe`` measures replay-window startup/warm/restore
    costs and RSS for the calibration round trip;
  * ``replay``   — ``replay_trace(trace, target, cfg)`` orchestration;
  * ``validate`` — sim-vs-real delta report + the enforced cold-start
    and p99 tolerance gates (CI ``gateway-smoke``), and the
    ``--round-trip`` mode that calibrates the sim from the live run
    itself and requires it to track live at least as tightly as the
    uncalibrated sim (CI ``roundtrip-smoke``).

Entry points: ``python -m repro_torch.launch.serve --gateway --trace-file ...
--compress 60`` for a live replay, ``python -m repro_torch.gateway.validate``
for the sim-vs-real diff (``--round-trip`` for the calibration loop).
"""
from repro_torch.gateway.gateway import (Autoscaler, ClusterBalancer, Gateway,
                                   GatewayParams)
from repro_torch.gateway.loadgen import (LoadGenerator, LoadResult,
                                   ShardedLoadGenerator, shard_trace)
from repro_torch.gateway.recorder import CalibrationProbe, Recorder
from repro_torch.gateway.replay import ReplayConfig, replay_trace
from repro_torch.gateway.targets import (ClusterTarget, PlatformTarget,
                                   RuntimeTarget, TargetAdapter, wrap_target)
from repro_torch.gateway.validate import (format_report, load_trace,
                                    round_trip_check, run_validation,
                                    sim_params_for_live)
from repro_torch.gateway.workload import TraceWorkload, scaled_runtime_budget

__all__ = [
    "Gateway", "GatewayParams", "Autoscaler", "ClusterBalancer",
    "LoadGenerator", "LoadResult", "ShardedLoadGenerator", "shard_trace",
    "Recorder", "CalibrationProbe",
    "ReplayConfig", "replay_trace", "TargetAdapter",
    "RuntimeTarget", "PlatformTarget", "ClusterTarget", "wrap_target",
    "TraceWorkload", "scaled_runtime_budget", "run_validation",
    "round_trip_check", "format_report", "sim_params_for_live",
    "load_trace",
]
