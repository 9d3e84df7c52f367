"""The device trace of a run's measured window (``--trace 1``), from
``torch.profiler`` with CUDA activity only, and the reductions the
readers share: busy time, device time by kernel name, idle gaps by what
the host was doing.

Kernel times come from the profiler (CUPTI) on the host's real-time
clock; the harness's own spans use ``time.perf_counter``. One offset,
read when the trace starts, puts both on the span clock.
"""
from __future__ import annotations

import bisect
import time

NAME_CHARS = 120            # a kernel's name as the breakdown keeps it


class DeviceTrace:
    """Kernels (name, start s, end s) on the span clock, between
    ``start()`` and ``stop()``; empty when off or off the card."""

    def __init__(self, on: bool, device):
        self.on = on and device.type == "cuda"
        self.kernels: list = []
        self._prof = None

    def start(self) -> None:
        if not self.on:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._offset_ns = time.time_ns() - time.perf_counter_ns()

    def stop(self) -> None:
        if self._prof is None:
            return
        import torch
        from torch.autograd import DeviceType
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        off = self._offset_ns
        out = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            t0 = (e.start_ns() - off) / 1e9
            out.append((e.name(), t0, t0 + e.duration_ns() / 1e9))
        out.sort(key=lambda k: k[1])
        self.kernels = out
        self._prof = None


def merged(kernels: list, t0: float, t1: float) -> list:
    """The union of the kernels' intervals inside [t0, t1], in order."""
    out: list = []
    for _, a, b in kernels:
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_s(kernels: list, t0: float, t1: float) -> float:
    return sum(b - a for a, b in merged(kernels, t0, t1))


def by_name(kernels: list, t0: float, t1: float) -> dict:
    """{kernel name: device seconds inside [t0, t1]}."""
    out: dict = {}
    for name, a, b in kernels:
        d = min(b, t1) - max(a, t0)
        if d > 0:
            out[name] = out.get(name, 0.0) + d
    return out


def seconds_matching(kernels: list, t0: float, t1: float, keys,
                     exclude=()) -> float:
    """Device seconds of the kernels whose name holds one of ``keys`` and
    none of ``exclude``."""
    return sum(s for n, s in by_name(kernels, t0, t1).items()
               if any(k in n for k in keys)
               and not any(x in n for x in exclude))


def idle_gaps(kernels: list, spans: list, t0: float, t1: float) -> list:
    """[(label, start, seconds)] of every stretch of [t0, t1] with no
    kernel running, labelled by the host span (start, end, label) it
    falls in (by its middle), ``between`` when none."""
    busy = merged(kernels, t0, t1)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    starts = [s[0] for s in spans]
    out = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        label = spans[i][2] if i >= 0 and spans[i][1] >= mid else "between"
        out.append((label, a, b - a))
    return out


def breakdown(kernels: list, spans: list, t0: float, t1: float) -> dict:
    """The result line's ``breakdown``: the 10 kernels with the most device
    time, and idle time by host span with the longest single gaps."""
    top = sorted(by_name(kernels, t0, t1).items(), key=lambda kv: -kv[1])
    gaps = idle_gaps(kernels, spans, t0, t1)
    total: dict = {}
    for label, _, d in gaps:
        total[label] = total.get(label, 0.0) + d
    idle = [[f"idle_in_{k}", v] for k, v in
            sorted(total.items(), key=lambda kv: -kv[1])]
    longest = sorted(gaps, key=lambda g: -g[2])
    idle += [[f"longest_idle_gap_in_{lab}", d]
             for lab, _, d in longest[:max(0, 10 - len(idle))]]
    return {"device_ops": [[n[:NAME_CHARS], s] for n, s in top[:10]],
            "idle_gaps": idle[:10]}
