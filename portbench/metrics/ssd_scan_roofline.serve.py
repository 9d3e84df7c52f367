"""ssd_scan_roofline.serve: least time of the window's forward SSD scans
(``counts/ssd_scan`` at each prefill's shapes and B/C groups, one scan a
layer, under ``counts/peaks``) over the device time of the kernels that
ran them (names below, from torch.profiler), in %."""
from portbench import trace

KEYS = ("ssd_scan_kernel", "ssd_chunk_kernel", "ssd_state_kernel",
        "ssd_out_kernel")


def read(run):
    if not run.kernels:
        return None
    cfg = run.cfg
    count, peaks = run.registry.count("ssd_scan"), run.registry.count("peaks")
    D, P, N = cfg["d_model"], cfg["ssm_head_dim"], cfg["ssm_state"]
    H = cfg["ssm_expand"] * D // P
    groups = cfg.get("ssm_groups", 1)
    least = sum(peaks.bound_s(*count.cost(1, S, H, P, N,
                                          min(cfg["ssm_chunk"], S),
                                          groups=groups))
                for s in run.window_steps() for S in s["admitted"])
    least *= cfg["n_layers"]
    spent = trace.seconds_matching(run.kernels, run.t0, run.t1, KEYS)
    return 100.0 * least / spent if least and spent else None
