"""serve_tokens_per_s: prompt tokens prefilled plus tokens generated by
the window's steps, over the window's seconds (host clock)."""


def read(run):
    steps = run.window_steps()
    if not steps:
        return None
    return sum(s["prefill_tokens"] + s["gen"] for s in steps) / run.window_s
