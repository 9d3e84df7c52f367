"""peak_mem_gb: ``torch.cuda.max_memory_allocated()`` over set-up and the
window (the peak was reset when the process reached the card), read
before the check, in GB (1e9 bytes)."""


def read(run):
    return run.peak_mem_bytes / 1e9 if run.peak_mem_bytes else None
