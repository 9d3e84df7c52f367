"""The system under test as the drivers reach it: the port's
``ArchConfig`` for a configuration file, and the device helpers."""
from __future__ import annotations

import dataclasses
import gc
import resource
import time

import torch


def arch_config(cfg: dict):
    """The port's ``ArchConfig`` with every field the file names."""
    from repro_torch.configs.base import ArchConfig
    names = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(**{k: v for k, v in cfg.items() if k in names})


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def release(device) -> None:
    """Free what nothing holds any more, before the reference runs."""
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def settle() -> None:
    """The end of set-up: collect what set-up left and move every object
    that lives on into the collector's permanent generation, so that no
    collection inside the window walks the set-up's objects."""
    gc.collect()
    gc.freeze()


def build_kernels(device) -> None:
    """Build or load the port's CUDA kernels (the first run in a checkout
    builds them into the checkout, the later ones load them)."""
    if device.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()


def host_sample() -> tuple:
    """(wall s, this process's CPU s, its involuntary context switches,
    the machine's CPU jiffies: (steal, idle, total) from ``/proc/stat``)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    try:
        with open("/proc/stat") as f:
            j = [int(x) for x in f.readline().split()[1:]]
        cpu = (j[7] if len(j) > 7 else 0, j[3] + j[4], sum(j[:8]))
    except (OSError, ValueError, IndexError):
        cpu = (0, 0, 0)
    return (time.perf_counter(), ru.ru_utime + ru.ru_stime, ru.ru_nivcsw,
            cpu)


def host_delta(a: tuple, b: tuple) -> dict:
    """What the host did between two ``host_sample``s: the process's CPU
    share of the wall, its involuntary switches, and the machine's steal
    and busy shares of all its cores."""
    wall = b[0] - a[0]
    total = b[3][2] - a[3][2]
    out = {"wall_s": wall, "process_cpu_share": (b[1] - a[1]) / wall,
           "involuntary_switches": b[2] - a[2]}
    if total > 0:
        out["machine_steal_share"] = (b[3][0] - a[3][0]) / total
        out["machine_busy_share"] = 1.0 - (b[3][1] - a[3][1]) / total
    return out
