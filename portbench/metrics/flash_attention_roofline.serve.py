"""flash_attention_roofline.serve: least time of the window's prefill
attention (``counts/flash_attention`` at each prefill's length, times the
attention calls a forward makes, ``attention_calls`` of
``counts/model_flops.<family>``, under ``counts/peaks``) over the device
time of the forward flash-attention kernels (torch.profiler's names
below), in %. A cell whose family's count has no ``attention_calls``
raises; a configuration that makes none, or a run with no such kernel,
gives nothing."""
from portbench import trace

KEYS = ("flash_wgmma_kernel", "flash_fwd_kernel")


def read(run):
    cfg = run.cfg
    if not run.kernels:
        return None
    calls = run.registry.model_flops(cfg).attention_calls(cfg)
    if not calls:
        return None
    count, peaks = run.registry.count("flash_attention"), \
        run.registry.count("peaks")
    hq, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    least = calls * sum(peaks.bound_s(*count.cost(S, hq, hkv, hd))
                        for s in run.window_steps() for S in s["admitted"])
    spent = trace.seconds_matching(run.kernels, run.t0, run.t1, KEYS,
                                   exclude=("bwd",))
    return 100.0 * least / spent if least and spent else None
