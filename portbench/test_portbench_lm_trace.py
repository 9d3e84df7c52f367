"""The readers of the program's spans (``lm_trace``) on hand-made
timelines: request tracks and a step track as the port's tracer keeps
them, kernels as the device trace keeps them. Also: a program without
the spans gives nothing and raises nothing, the idle time is cut by
innermost span, and a profiled run on the CPU hands the readers the
program's own request tracks."""
from __future__ import annotations

import numpy as np
import pytest

from portbench import lm_trace, run
from portbench.record import Record
from portbench.registry import Registry
from portbench.test_portbench_metrics import DOCS, MAMBA

REG = Registry()
NEW = ("queue_wait_p90_ms.serve", "itl_p90_ms.serve",
       "prefill_idle_share.serve", "decode_idle_share.serve",
       "host_us_per_launch.serve")


def read(name, rec):
    return REG.reader(name)(rec)


def step(i: int, admit: bool) -> tuple:
    """Step ``i`` over [i, i + 1) s: with ``admit``, an admission over
    [i, i + 0.5) (forward [i + 0.1, i + 0.4) holding a norm and a mixer
    with its ssd_scan kernel), then the decode: forward [i + 0.6, i + 0.8),
    readback to i + 0.9, bookkeeping to i + 0.95."""
    sps = [("step", i + 0.0, i + 1.0, {"slots": 2})]
    if admit:
        sps += [("admit", i + 0.0, i + 0.5, {"rid": i, "prompt": 1000}),
                ("bookkeeping", i + 0.0, i + 0.1, None),
                ("prefill.forward", i + 0.1, i + 0.4, None),
                ("norm", i + 0.1, i + 0.15, None),
                ("mixer", i + 0.15, i + 0.35, None),
                ("kernel", i + 0.2, i + 0.3, {"name": "ssd_scan"}),
                ("prefill.insert", i + 0.4, i + 0.45, None),
                ("readback", i + 0.45, i + 0.5, {"kind": "first"})]
    sps += [("decode.forward", i + 0.6, i + 0.8, None),
            ("readback", i + 0.8, i + 0.9, {"kind": "decode"}),
            ("bookkeeping", i + 0.9, i + 0.95, None)]
    return i, sorted(sps, key=lambda s: (s[1], -s[2]))


def lm_record(kernels=()) -> Record:
    """A 10 s window of 10 steps, even ones admitting; 4 requests whose
    queue waits are 10, 20, 30 and 40 ms (the last admitted after the
    window) and whose tokens come 0.3 s apart."""
    rec = Record(cfg=MAMBA, mix=DOCS, registry=REG, t0=0.0, t1=10.0)
    reqs = []
    for k in range(4):
        t_adm = 2.0 * k + 1.0 + (12.0 if k == 3 else 0.0)
        w = 0.01 * (k + 1)
        reqs.append({"t0": t_adm - w, "total_s": 2.0, "spans": [
            {"name": "queue_wait", "t0": t_adm - w, "t1": t_adm},
            {"name": "prefill", "t0": t_adm, "t1": t_adm + 0.5}],
            "token_times": [t_adm + 0.3 * j for j in range(4)]})
    rec.extra["lm_trace"] = {"requests": reqs,
                             "steps": [step(i, i % 2 == 0)
                                       for i in range(10)]}
    rec.kernels = list(kernels)
    return rec


def test_request_track_readers():
    rec = lm_record()
    assert read("queue_wait_p90_ms.serve", rec) == pytest.approx(
        np.percentile([10.0, 20.0, 30.0], 90))
    # three requests with four tokens in the window: nine gaps of 300 ms
    assert read("itl_p90_ms.serve", rec) == pytest.approx(300.0)


def test_device_readers():
    # per step: one kernel inside the prefill's ssd_scan span (the
    # admitting steps), one over half the decode forward, two copies
    # launched from the decode forward that start in its readback
    ks = []
    for i in range(10):
        if i % 2 == 0:
            ks.append(("ssd_chunk_kernel", i + 0.2, i + 0.3))
        ks += [("elementwise_kernel", i + 0.6, i + 0.7),
               ("Memcpy DtoH", i + 0.82, i + 0.84),
               ("Memcpy DtoH", i + 0.85, i + 0.86)]
    rec = lm_record(ks)
    # admits: 0.5 s each, 0.1 busy
    assert read("prefill_idle_share.serve", rec) == pytest.approx(80.0)
    # decode windows: 0.3 s each (forward + readback), 0.13 busy
    assert read("decode_idle_share.serve", rec) == pytest.approx(
        100 * (1 - 0.13 / 0.3))
    # forward wall: 5 x 0.3 + 10 x 0.2 = 3.5 s over 5 + 30 device ops
    assert read("host_us_per_launch.serve", rec) == pytest.approx(
        1e6 * 3.5 / 35)


def test_a_program_without_the_spans_gives_nothing():
    rec = Record(cfg=MAMBA, mix=DOCS, registry=REG, t0=0.0, t1=10.0,
                 kernels=[("k", 1.0, 2.0)])
    rec.extra["lm_trace"] = None
    for name in NEW:
        assert read(name, rec) is None
    # no kernels (an untraced run, the CPU): the device readers give none
    rec = lm_record()
    for name in NEW[2:]:
        assert read(name, rec) is None


def test_idle_cut_by_innermost_span():
    rec = lm_record([("ssd_chunk_kernel", 0.2, 0.3)])
    lm = lm_trace.of(rec)
    segs = lm_trace.segments(lm)
    assert [s[2] for s in segs[:9]] == [
        "bookkeeping", "prefill.forward/norm", "prefill.forward/mixer",
        "prefill.forward/mixer/ssd_scan", "prefill.forward/mixer",
        "prefill.forward", "prefill.insert", "readback", "step"]
    idle = lm_trace.idle_by_span(rec.kernels, lm, 0.0, 1.0)
    assert sum(idle.values()) == pytest.approx(0.9)
    assert "prefill.forward/mixer/ssd_scan" not in idle    # busy
    assert idle["prefill.forward/mixer"] == pytest.approx(0.1)
    assert idle["step"] == pytest.approx(0.1 + 0.05)   # 0.5-0.6, 0.95-1
    assert idle["decode.forward"] == pytest.approx(0.2)
    # a gap past the last step is "between"
    idle = lm_trace.idle_by_span([], lm, 9.0, 11.0)
    assert idle["between"] == pytest.approx(1.0)
    assert lm_trace.inside_children(lm, [0.05, 0.55, 0.85]) == \
        pytest.approx(200 / 3)
    host = lm_trace.host_by_span(lm, [0.22, 0.25, 0.61])
    assert host["prefill.forward/mixer/ssd_scan"] == [pytest.approx(0.5), 2]
    assert host["decode.forward"][1] == 1


def test_profiled_cpu_run_hands_the_readers_the_program_spans(tiny, cpu):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.tracing import take_profile_tracer
    take_profile_tracer()
    with profile(activities=[ProfilerActivity.CPU]):
        res, rec = run.run_cell(tiny, "tiny-ssm-docs", 2**31 + 7, 2.0,
                                True, cpu)
    assert res["correct"], rec.checks
    for name in NEW[:2]:
        assert res["metrics"][name]["value"] > 0
    lm = lm_trace.of(rec)
    assert lm["steps"] and all(rec.t0 <= sps[0][1] and sps[0][2] <= rec.t1
                               for _, sps in lm["steps"])
    assert len(lm["steps"]) == len(rec.window_steps())
    for name in NEW[2:]:                  # no device trace on the CPU
        assert name not in res["metrics"]
