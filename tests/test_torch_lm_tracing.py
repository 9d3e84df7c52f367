"""Tracing inside the port's LM serving path (``core/tracing``), on the CPU.

A ``ContinuousBatcher`` over reduced mamba2-780m (ssm) and qwen2.5-3b
(dense) with a ``Tracer``: every request's track conserves (its phases
plus ``unattributed`` equal its total) and holds one time per token; the
tokens are the ones an untraced run gives, and an untraced run records
nothing (every site hands out the shared no-op span); every step-track
span is in the closed vocabulary and nests (a model or kernel span in a
forward span in a ``step``); a batcher with no tracer records into the
profile tracer only on a thread a profiler records on;
``launch/serve --trace-out`` writes a file that ``--check`` accepts; and
every span call site of the port names a span of its own closed
vocabulary and is used as a context manager.
"""
import ast
import json
import threading
from pathlib import Path

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core import ContinuousBatcher, HydraRuntime, LMSpec
from repro_torch.core import tracing
from repro_torch.core.tracing import (FORWARD_SPANS, MODEL_SPANS, NULL_STEP,
                                      NULL_TRACE, PHASES, STEP_SPANS,
                                      Tracer, chrome_trace,
                                      take_profile_tracer, validate_chrome)
from repro_torch.launch import serve
from repro_torch.models.programs import ModelProgram

ARCHS = ("mamba2-780m", "qwen2.5-3b")
LM_PHASES = {"queue_wait", "prefill", "decode", "prefill_stall"}


def make_batcher(arch, tracer=None, slots=2):
    cfg = get_config(arch).reduced()
    rt = HydraRuntime(device="cpu", n_workers=0, janitor=False)
    rt.register_function("fn", LMSpec(cfg=cfg, params=ModelProgram(
        cfg).init(0, device="cpu"), max_seq=64, slots=slots))
    return rt, ContinuousBatcher(rt, "fn", tracer=tracer)


def serve_requests(arch, tracer=None, n=5, max_new=4):
    """``n`` requests of growing prompts through one batcher of 2 slots,
    traced when ``tracer`` is given: their tokens."""
    rt, b = make_batcher(arch, tracer)
    rng = np.random.default_rng(0)
    try:
        futs = [b.submit(rng.integers(2, 100, 5 + 3 * i).tolist(), max_new,
                         tracer.start_request("fn") if tracer
                         else NULL_TRACE) for i in range(n)]
        b.run_until_done(max_steps=100)
        return [f.result() for f in futs]
    finally:
        b.close()
        rt.shutdown()


@pytest.fixture(scope="module", params=ARCHS)
def traced(request):
    tracer = Tracer()
    tokens = serve_requests(request.param, tracer)
    return request.param, tracer, tokens


def test_request_tracks_conserve_and_hold_every_token(traced):
    _, tracer, tokens = traced
    traces = tracer.traces()
    assert len(traces) == len(tokens) == 5
    for t in traces:
        spans = [(s["name"], s["t0"], s["t1"], s.get("attrs"))
                 for s in t["spans"]]
        bd = tracing.PhaseBreakdown.compute(spans, t["total_s"])
        assert bd.conservation_error_s() < 1e-3
        assert bd.overlap_s < 1e-9                    # disjoint phases
        assert set(t["phases"]) <= LM_PHASES | {"unattributed"}
        assert {"queue_wait", "prefill", "decode"} <= set(t["phases"])
        times = t["token_times"]
        assert len(times) == 4 and times == sorted(times)
        prefill = [s for s in t["spans"] if s["name"] == "prefill"]
        assert len(prefill) == 1
        assert prefill[0]["t0"] < times[0] <= prefill[0]["t1"]
        assert t["t0"] <= min(s["t0"] for s in t["spans"])
        assert max(s["t1"] for s in t["spans"]) <= t["t0"] + t["total_s"]
    # two slots: the later requests wait while the first two decode, and
    # the first ones stall behind the later prefills
    assert any("prefill_stall" in t["phases"] for t in traces)


def test_tracing_leaves_the_tokens_and_off_records_nothing(traced,
                                                           monkeypatch):
    arch, _, tokens = traced
    made = []
    init = tracing.Span.__init__

    def counting(self, *a):
        made.append(a[1])
        init(self, *a)
    monkeypatch.setattr(tracing.Span, "__init__", counting)
    assert serve_requests(arch) == tokens
    assert made == []                   # no span was made with tracing off
    assert tracing.step_span("mixer") is tracing._NULL_SPAN
    assert tracing.step_span("kernel", "rmsnorm") is tracing._NULL_SPAN
    rt, b = make_batcher(arch)
    try:
        assert b._step_trace() is NULL_STEP
    finally:
        b.close()
        rt.shutdown()


def test_step_track_vocabulary_and_nesting(traced):
    arch, tracer, _ = traced
    steps = tracer.steps()
    assert steps and [s for s, _ in steps] == sorted(s for s, _ in steps)
    names = {n for _, sps in steps for n, *_ in sps}
    assert names <= set(STEP_SPANS)
    assert {"step", "admit", "prefill.forward", "prefill.insert",
            "readback", "decode.forward", "bookkeeping", "embed", "norm",
            "mixer", "lm_head", "cache_pack", "kernel"} <= names
    if arch == "qwen2.5-3b":
        assert "ffn" in names
    kernels = {(a or {}).get("name") for _, sps in steps
               for n, _, _, a in sps if n == "kernel"}
    assert kernels == ({"rmsnorm", "ssd_scan", "ssd_decode", "mamba_conv",
                        "mamba_gate"}
                       if arch == "mamba2-780m" else
                       {"rmsnorm", "flash_attention", "decode_attention"})
    for step, sps in steps:
        top = [s for s in sps if s[0] == "step"]
        assert len(top) == 1
        _, s0, s1, attrs = top[0]
        assert attrs["spans"] == len(sps) and attrs["programs_built"] >= 0
        assert 0 <= attrs["slots"] <= 2
        assert set(attrs) == {"spans", "programs_built", "slots"}
        for n, _, _, a in sps:
            if n == "admit":
                assert set(a) == {"rid", "prompt"} and a["prompt"] >= 5
            if n == "readback":
                assert a in ({"kind": "first"}, {"kind": "decode"})
        kinds = [a["kind"] for n, _, _, a in sps if n == "readback"]
        assert kinds == (["first"] * sum(n == "admit" for n, *_ in sps)
                         + ["decode"] * ("decode.forward" in
                                         {n for n, *_ in sps}))
        fwd = [s for s in sps if s[0] in FORWARD_SPANS]
        for n, a, b, _ in sps:
            assert s0 <= a <= b <= s1, n
            if n in MODEL_SPANS:
                assert any(f[1] <= a and b <= f[2] for f in fwd), n
    doc = chrome_trace(tracer.traces(), steps=steps)
    assert validate_chrome(doc) == []
    assert sum(e["cat"] == "step" for e in doc["traceEvents"]) == \
        sum(len(sps) for _, sps in steps)


def test_validate_chrome_checks_the_step_track(traced):
    _, tracer, _ = traced
    doc = chrome_trace(tracer.traces(), steps=tracer.steps())
    evs = doc["traceEvents"]
    step = next(e for e in evs if e.get("cat") == "step"
                and e["name"] == "step")
    stray = dict(step, name="mixer", ts=step["ts"] - 1e6)
    odd = dict(step, name="made_up_span")
    doc["traceEvents"] = evs + [stray, odd]
    errors = validate_chrome(doc)
    assert any("lies in no step span" in e for e in errors)
    assert any("unknown step span 'made_up_span'" in e for e in errors)
    assert set(PHASES) >= LM_PHASES


def test_profiled_thread_records_and_other_threads_do_not():
    take_profile_tracer()
    rt, b = make_batcher("mamba2-780m")
    rt2, b2 = make_batcher("mamba2-780m")
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            fut = b.submit([3, 4, 5, 6], 3)
            other = threading.Thread(target=lambda: (
                b2.submit([7, 8, 9], 3), b2.run_until_done(max_steps=20)))
            other.start()
            other.join(timeout=60)
            assert not other.is_alive()
            b.run_until_done(max_steps=20)
        got = take_profile_tracer()
        assert got is not None and take_profile_tracer() is None
        assert len(got.traces()) == 1                 # b's request alone
        assert got.traces()[0]["token_times"] and fut.result()
        assert len(got.steps()) == b._ticks           # none of b2's steps
        # unprofiled: nothing is recorded, and nothing is kept
        b.submit([1, 2, 3], 2)
        b.run_until_done(max_steps=20)
        assert take_profile_tracer() is None
    finally:
        for x in (b, b2):
            x.close()
        rt.shutdown()
        rt2.shutdown()


def test_serve_trace_out_round_trip(tmp_path, capsys):
    path = tmp_path / "spans.json"
    stats = serve.main(["--device", "cpu", "--pool", "0", "--tenants", "2",
                        "--requests", "4", "--max-new", "3",
                        "--prompt-len", "6", "--trace-out", str(path)])
    assert stats["tokens"] == 4 * 3
    assert tracing.main(["--check", str(path)]) == 0
    out = capsys.readouterr().out
    assert "OK — 4 request tracks" in out
    doc = json.loads(path.read_text())
    assert {e["name"] for e in doc["traceEvents"]
            if e["cat"] == "step"} >= {"step", "admit", "decode.forward"}


SRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch"
TRACING = SRC / "core" / "tracing" / "__init__.py"


def span_sites():
    """(file, line, kind, name, used in a with) of every span call site of
    the port with a literal name: the step track's (``step_span`` and
    ``StepTrace.child``) and the request tracks' (``.span``, ``.add_span``).
    The tracing package itself, which defines them, is left out."""
    out = []
    for path in sorted(SRC.rglob("*.py")):
        if path == TRACING:
            continue
        tree = ast.parse(path.read_text(), filename=str(path))
        in_with = {id(item.context_expr) for node in ast.walk(tree)
                   if isinstance(node, (ast.With, ast.AsyncWith))
                   for item in node.items}
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            f = node.func
            meth = f.attr if isinstance(f, ast.Attribute) else \
                f.id if isinstance(f, ast.Name) else None
            kind = {"step_span": "step", "child": "step", "span": "request",
                    "add_span": "request"}.get(meth)
            if kind is not None:
                out.append((path.relative_to(SRC), node.lineno, meth,
                            node.args[0].value, id(node) in in_with))
    return out


def test_every_span_site_names_the_closed_vocabulary():
    # the port's own registry: HL008 holds .span/.add_span sites to the
    # reference's PHASES, which lacks the LM path's phases and knows no
    # step track, so this holds every site to the port's
    sites = span_sites()
    step = [s for s in sites if s[2] in ("step_span", "child")]
    assert len(step) >= 30
    assert {s[3] for s in step} == set(STEP_SPANS)
    for path, line, meth, name, with_ in sites:
        vocab = STEP_SPANS if meth in ("step_span", "child") else PHASES
        assert name in vocab, f"{path}:{line} {meth}({name!r})"
        if meth != "add_span":
            assert with_, f"{path}:{line} {meth}({name!r}) outside a with"
    assert {s[3] for s in sites if s[2] == "add_span"} >= LM_PHASES
