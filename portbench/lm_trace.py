#!/usr/bin/env python3
"""The program's own spans in a traced run: the LM serving path's request
tracks and step track (``repro_torch.core.tracing``), on the clock the
device trace is put on (``time.perf_counter``), and the reductions the
readers of their metrics share.

While the device trace's profiler records, a ``ContinuousBatcher`` given
no tracer records into the process's profile tracer (a stopgap until the
serving harness passes the batcher a ``Tracer``). The first reader
that asks takes that tracer and keeps what it holds in ``run.extra``
(``"lm_trace"``), where the other readers find it. A program without the
profile tracer gives None, and each reader then reports nothing.

As a command it runs one cell once with ``--trace 1``, keeps the CUDA
launch records (``cudaLaunchKernel`` and the like, with their host
timestamps) beside the kernels, and prints one JSON line: the result,
what the host did while the card idled (idle time by innermost span),
the share of launch records that fall inside a step's child span, the
clock's drift from the trace's start to its stop, and the request
tracks' check (``validate_chrome``). The launch records and the drift
come from ``LaunchTrace``, a copy of ``trace.DeviceTrace`` that the
command puts in ``drivers/serving.py``'s place; ``run.py`` has neither,
so these figures come from this command alone until ``trace.DeviceTrace``
keeps the records itself and the copy goes::

    python3 portbench/lm_trace.py --workload mamba2-docs --seed 7 \\
        --seconds 50
"""
from __future__ import annotations

import bisect
import json
import sys
import time
from pathlib import Path

# the step's children that launch work on the card (a readback only
# waits for it: kernels that start inside one were launched before it)
LAUNCHING = ("bookkeeping", "prefill.forward", "prefill.insert",
             "decode.forward")
FORWARD = ("prefill.forward", "decode.forward")
CHILDREN = ("admit", "prefill.forward", "prefill.insert", "readback",
            "decode.forward", "bookkeeping")
# the host calls of CUPTI's launch records
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def of(run):
    """{"requests": [request track dicts], "steps": [(step id, spans)]}:
    the finished request tracks and the steps inside the run's window,
    each step's spans ``(name, t0, t1, attrs)`` parents first; None when
    the program recorded none."""
    if "lm_trace" not in run.extra:
        run.extra["lm_trace"] = _take(run.t0, run.t1)
    return run.extra["lm_trace"]


def _take(t0: float, t1: float):
    try:
        from repro_torch.core.tracing import take_profile_tracer
    except ImportError:          # a program without the profile tracer
        return None
    tracer = take_profile_tracer()
    if tracer is None:
        return None
    steps = []
    for step, spans in tracer.steps():
        spans = sorted(spans, key=lambda s: (s[1], -s[2]))
        if spans and spans[0][0] == "step" and t0 <= spans[0][1] \
                and spans[0][2] <= t1:
            steps.append((step, spans))
    return {"requests": tracer.traces(), "steps": steps}


def spans_named(lm, names) -> list:
    """[(name, t0, t1, attrs)] of the window's steps, in time order."""
    return sorted((s for _, sps in lm["steps"] for s in sps
                   if s[0] in names), key=lambda s: s[1])


def decode_windows(lm) -> list:
    """[(t0, t1)] from each step's ``decode.forward`` to the end of the
    readback that follows it."""
    out = []
    for _, sps in lm["steps"]:
        fwd = [s for s in sps if s[0] == "decode.forward"]
        if not fwd:
            continue
        rb = [s for s in sps if s[0] == "readback" and s[1] >= fwd[0][2]]
        out.append((fwd[0][1], rb[0][2] if rb else fwd[0][2]))
    return out


def idle_share(kernels: list, intervals: list) -> float | None:
    """Share of the intervals' wall with no kernel or copy running, in %;
    None when they hold no time."""
    from portbench import trace
    wall = sum(b - a for a, b in intervals)
    if not intervals or wall <= 0:
        return None
    lo = min(a for a, _ in intervals)
    hi = max(b for _, b in intervals)
    busy = _overlap(trace.merged(kernels, lo, hi), sorted(intervals))
    return 100.0 * (1.0 - busy / wall)


def _overlap(busy: list, intervals: list) -> float:
    """Seconds of ``busy`` (disjoint, sorted) inside ``intervals``
    (disjoint, sorted)."""
    out, j = 0.0, 0
    for a, b in intervals:
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < b:
            out += max(0.0, min(b, busy[k][1]) - max(a, busy[k][0]))
            k += 1
    return out


def owners(lm, starts: list) -> list:
    """The launching child span (``LAUNCHING``) each time in ``starts``
    falls to: the last one that began at or before it, since work starts
    on the card after its launch; None before the first."""
    spans = spans_named(lm, LAUNCHING)
    begin = [s[1] for s in spans]
    out = []
    for t in starts:
        i = bisect.bisect_right(begin, t) - 1
        out.append(spans[i] if i >= 0 else None)
    return out


def host_us_per_launch(lm, kernels: list, t0: float, t1: float):
    """The forward spans' wall over the kernels and copies they launched,
    in us: each device op is put down to the launching span it starts
    after (``owners``), which holds where the card keeps up with the
    host; None without any."""
    starts = [a for _, a, _ in kernels if t0 <= a <= t1]
    n = sum(1 for o in owners(lm, starts) if o is not None
            and o[0] in FORWARD)
    wall = sum(s[2] - s[1] for s in spans_named(lm, FORWARD))
    return 1e6 * wall / n if n else None


# ---------------------------------------------------------------------------
# idle time by innermost span
# ---------------------------------------------------------------------------
def _label(path: list) -> str:
    """The innermost span's place below its step, e.g.
    ``prefill.forward/mixer/ssd_scan`` (a kernel span by its name);
    ``step`` or ``admit`` where no child of theirs runs."""
    names = [(a or {}).get("name", n) if n == "kernel" else n
             for n, a, _ in path if n not in ("step", "admit")]
    return "/".join(names) if names else path[-1][0]


def segments(lm) -> list:
    """[(t0, t1, label)]: the window's steps cut into the stretches each
    innermost span covers (``_label``), in order (the spans of a step
    nest: one thread recorded them)."""
    out = []
    for _, sps in lm["steps"]:
        stack: list = []            # (name, attrs, end) of open spans
        cur = 0.0

        def emit(upto):
            nonlocal cur
            if upto > cur:
                out.append((cur, upto, _label(stack)))
                cur = upto

        for n, s0, s1, at in sps:
            while stack and stack[-1][2] <= s0:
                emit(stack[-1][2])
                stack.pop()
            if stack:
                emit(s0)
            stack.append((n, at, s1))
            cur = max(cur, s0)
        while stack:
            emit(stack[-1][2])
            stack.pop()
    return out


def idle_by_span(kernels: list, lm, t0: float, t1: float) -> dict:
    """{label: idle seconds} over [t0, t1]: every stretch with no kernel
    or copy running, cut by innermost span; ``between`` outside steps."""
    from portbench import trace
    busy = trace.merged(kernels, t0, t1)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    out: dict = {}
    segs = segments(lm)
    j = 0
    for a, b in gaps:
        covered = 0.0
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            d = min(b, segs[k][1]) - max(a, segs[k][0])
            if d > 0:
                out[segs[k][2]] = out.get(segs[k][2], 0.0) + d
                covered += d
            k += 1
        if b - a - covered > 0:
            out["between"] = out.get("between", 0.0) + (b - a - covered)
    return out


def host_by_span(lm, times: list) -> dict:
    """{label: [wall s, launches]}: each innermost span's host wall
    (``segments``) and the launch records whose host call began in it."""
    out: dict = {}
    segs = segments(lm)
    for a, b, label in segs:
        out.setdefault(label, [0.0, 0])[0] += b - a
    begin = [s[0] for s in segs]
    for t in times:
        i = bisect.bisect_right(begin, t) - 1
        if i >= 0 and t < segs[i][1]:
            out[segs[i][2]][1] += 1
    return out


def inside_children(lm, times: list) -> float | None:
    """Share of ``times`` that fall inside a child span of a step (any
    span but ``step`` itself), in %."""
    if not times:
        return None
    ivs = sorted((s[1], s[2]) for _, sps in lm["steps"] for s in sps
                 if s[0] in CHILDREN)
    merged: list = []
    for a, b in ivs:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    begin = [m[0] for m in merged]
    hit = 0
    for t in times:
        i = bisect.bisect_right(begin, t) - 1
        hit += i >= 0 and t <= merged[i][1]
    return 100.0 * hit / len(times)


# ---------------------------------------------------------------------------
# the command: one traced run with the launch records kept
# ---------------------------------------------------------------------------
def _launch_trace_class():
    from portbench.trace import DeviceTrace

    class LaunchTrace(DeviceTrace):
        """``DeviceTrace`` that also keeps CUPTI's launch records (host
        call, start s, end s), reads the clock offset again at ``stop``
        (the drift; past 100 us the offset is interpolated) and counts
        the caching allocator's device allocations over the window."""
        last = None

        def start(self) -> None:
            super().start()
            self.launches: list = []
            self.drift_s = None
            self.device_allocs = None
            self._allocs0 = _device_allocs()
            self._raw0 = time.time_ns()
            LaunchTrace.last = self

        def stop(self) -> None:
            if self._prof is None:
                return
            import torch
            from torch.autograd import DeviceType
            torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
            allocs = _device_allocs()
            if allocs is not None and self._allocs0 is not None:
                self.device_allocs = allocs - self._allocs0
            off0, raw0 = self._offset_ns, self._raw0
            off1 = time.time_ns() - time.perf_counter_ns()
            raw1 = time.time_ns()
            self.drift_s = (off1 - off0) / 1e9
            slope = (off1 - off0) / max(1, raw1 - raw0) \
                if abs(off1 - off0) > 100_000 else 0.0

            def clock(ns: int) -> float:
                return (ns - off0 - slope * (ns - raw0)) / 1e9

            kernels, launches = [], []
            for e in self._prof.profiler.kineto_results.events():
                a = clock(e.start_ns())
                span = (e.name(), a, a + e.duration_ns() / 1e9)
                if e.device_type() == DeviceType.CUDA:
                    kernels.append(span)
                elif e.name().startswith(LAUNCH_CALLS):
                    launches.append(span)
            self.kernels = sorted(kernels, key=lambda k: k[1])
            self.launches = sorted(launches, key=lambda k: k[1])
            self._prof = None

    return LaunchTrace


def _device_allocs():
    """The caching allocator's device allocations so far (cudaMalloc
    calls), where this PyTorch counts them."""
    import torch
    return torch.cuda.memory_stats().get("num_device_alloc")


def report(rec, launches: list, drift_s, device_allocs=None) -> dict:
    """What the command prints beside the run's result."""
    from repro_torch.core.tracing import chrome_trace, validate_chrome

    from portbench import trace
    lm = of(rec)
    if lm is None:
        return {"lm_trace": None}
    t0, t1 = rec.t0, rec.t1
    idle = idle_by_span(rec.kernels, lm, t0, t1)
    idle_s = sum(idle.values())
    launch_t = [a for _, a, _ in launches if t0 <= a <= t1]
    per = {}
    for o in owners(lm, launch_t):
        name = o[0] if o is not None else "before"
        per[name] = per.get(name, 0) + 1
    # launch records inside each forward span, exactly
    fwd = spans_named(lm, FORWARD)
    exact = {n: 0 for n in FORWARD}
    begin = [s[1] for s in fwd]
    for t in launch_t:
        i = bisect.bisect_right(begin, t) - 1
        if i >= 0 and t <= fwd[i][2]:
            exact[fwd[i][0]] += 1
    n_fwd = {n: sum(1 for s in fwd if s[0] == n) for n in FORWARD}
    wall = sum(s[2] - s[1] for s in fwd)
    steps = [s for _, sps in lm["steps"] for s in sps if s[0] == "step"]
    attrs = [s[3] or {} for s in steps]
    finished = [r for r in lm["requests"]
                if t0 <= r["t0"] and r["t0"] + r["total_s"] <= t1]
    doc = chrome_trace(finished)
    return {
        "steps": len(steps), "requests_finished": len(finished),
        "validate_chrome": validate_chrome(doc)[:5] if finished else None,
        "drift_us": None if drift_s is None else drift_s * 1e6,
        "launch_records": len(launch_t),
        "launches_in_children_pct": inside_children(lm, launch_t),
        "kernels_in_children_pct": inside_children(
            lm, [a for _, a, _ in rec.kernels if t0 <= a <= t1]),
        "launches_by_owner": per,
        "launches_per": {n: exact[n] / n_fwd[n] for n in FORWARD
                         if n_fwd[n]},
        "host_us_per_launch_exact": 1e6 * wall / sum(exact.values())
        if sum(exact.values()) else None,
        "host_us_per_launch_approx": host_us_per_launch(
            lm, rec.kernels, t0, t1),
        "idle_s": idle_s,
        "idle_uncovered_in_steps_pct": 100.0 * idle.get("step", 0.0)
        / idle_s if idle_s else None,
        "idle_by_span": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        "host_by_span": dict(sorted(host_by_span(lm, launch_t).items(),
                                    key=lambda kv: -kv[1][0])),
        "breakdown": trace.breakdown(rec.kernels, rec.spans, t0, t1),
        "programs_built": sum(a.get("programs_built", 0) for a in attrs),
        "device_allocs": device_allocs,
        "span_sites_per_step": _quartiles([a.get("spans", 0)
                                           for a in attrs]),
    }


def _quartiles(xs: list) -> list:
    from portbench.stats import percentile
    return [percentile(xs, q) for q in (0, 25, 50, 75, 100)]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True,
                    help="the cell (BENCHMARK.json's workloads)")
    ap.add_argument("--seed", type=int, required=True,
                    help="the run's seed, as run.py takes it")
    ap.add_argument("--seconds", type=float, required=True,
                    help="the measured window")
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(root), str(root / "src")]
    from portbench import run as runner
    runner.environment()
    import torch
    torch.set_num_threads(1)
    from portbench.drivers import serving
    from portbench.registry import Registry
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    trace_cls = _launch_trace_class()
    serving.DeviceTrace = trace_cls
    res, rec = runner.run_cell(Registry(), args.workload, args.seed,
                               args.seconds, True, device,
                               time.perf_counter())
    lt = trace_cls.last
    out = {"result": res, "card": runner.card(),
           **report(rec, lt.launches if lt else [],
                    lt.drift_s if lt else None,
                    lt.device_allocs if lt else None)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
