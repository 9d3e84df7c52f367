"""decode_attention_roofline.serve: least time of the window's decode
attention (``counts/decode_attention`` of each decode step at the keys
its requests' tokens saw, times the attention calls a forward makes,
``attention_calls`` of ``counts/model_flops.<family>``, under
``counts/peaks``: the K/V bytes bound it) over the device time of the
split-KV decode kernels (torch.profiler's names below), in %. A cell
whose family's count has no ``attention_calls`` raises; a configuration
that makes none, or a run with no such kernel, gives nothing."""
from portbench import trace

KEYS = ("decode_scores_kernel", "decode_pv_kernel", "decode_combine_kernel")


def read(run):
    cfg = run.cfg
    if not run.kernels:
        return None
    calls = run.registry.model_flops(cfg).attention_calls(cfg)
    if not calls:
        return None
    count, peaks = run.registry.count("decode_attention"), \
        run.registry.count("peaks")
    hq, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    least = calls * sum(peaks.bound_s(*count.cost(s["ctx"], hq, hkv, hd))
                        for s in run.window_steps() if s["ctx"])
    spent = trace.seconds_matching(run.kernels, run.t0, run.t1, KEYS)
    return 100.0 * least / spent if least and spent else None
