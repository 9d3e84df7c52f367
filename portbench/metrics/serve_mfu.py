"""serve_mfu: model flops of the window's work (each prefill, and each
token decoded for a request, at the keys it saw) over the window's
seconds, as a share of the bf16 peak (``counts/model_flops.<family>`` of
the cell's configuration, ``counts/peaks``), in %. A cell whose family
has no count raises: no other family's count stands in."""


def read(run):
    mf = run.registry.model_flops(run.cfg)
    peaks = run.registry.count("peaks")
    steps = run.window_steps()
    if not steps:
        return None
    flops = sum(sum(mf.prefill(run.cfg, S) for S in s["admitted"])
                + sum(mf.decode(run.cfg, c) for c in s["ctx"])
                for s in steps)
    return 100.0 * flops / run.window_s / peaks.FLOPS["bfloat16"]
