"""serve_mfu: model flops of the window's work (each prefill, and each
token decoded for a request, at the keys it saw) over the window's
seconds, as a share of the bf16 peak (``counts/model_flops``,
``counts/peaks``), in %."""


def read(run):
    mf = run.registry.count("model_flops")
    peaks = run.registry.count("peaks")
    steps = run.window_steps()
    if not steps:
        return None
    flops = sum(sum(mf.prefill(run.cfg, S) for S in s["admitted"])
                + sum(mf.decode(run.cfg, c) for c in s["ctx"])
                for s in steps)
    return 100.0 * flops / run.window_s / peaks.FLOPS["bfloat16"]
