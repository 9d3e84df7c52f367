"""The readers on hand-made timelines: each rate and percentile is taken
over all the window's work and time, and the device readers over the
kernels of the window alone."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import stats, trace
from portbench.record import Record
from portbench.registry import Registry

HERE = Path(__file__).parent
MAMBA = json.loads((HERE / "configs/mamba2-780m.json").read_text())
DOCS = json.loads((HERE / "traffic/docs.json").read_text())
REG = Registry()


def read(name, rec):
    return REG.reader(name)(rec)


def serve_record() -> Record:
    # a 10 s window: steps of 1 s; odd steps admit one 1,000-token
    # prompt; every step makes 5 tokens
    rec = Record(cfg=MAMBA, mix=DOCS, registry=REG, t0=0.0, t1=10.0)
    for i in range(10):
        adm = [1000] if i % 2 else []
        rec.steps.append(dict(t0=i + (0.5 if adm else 0.75), t1=i + 1.0,
                              admitted=adm, prefill_tokens=sum(adm), gen=5,
                              ctx=[2000] * 5))
    # requests sent at 0.5 k s, each done 1 + 0.01 k s later; one more
    # done after the window
    for k in range(12):
        rec.requests.append(dict(rid=k, send=0.5 * k, admitted=0.5 * k + 0.4,
                                 done=0.5 * k + 1 + k * 0.01, prompt=1000,
                                 n_out=8))
    rec.requests.append(dict(rid=99, send=9.0, admitted=9.5, done=12.0,
                             prompt=1000, n_out=8))
    return rec


def test_percentile_is_numpys_linear():
    xs = np.random.default_rng(0).random(101)
    for q in (0, 10, 50, 90, 99.5, 100):
        assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    assert stats.percentile([], 90) is None


def test_serve_window_metrics():
    rec = serve_record()
    assert read("serve_tokens_per_s", rec) == pytest.approx(
        (5 * 1000 + 10 * 5) / 10.0)
    lat = [(1 + k * 0.01) * 1e3 for k in range(12)]   # all done in window
    assert read("request_p90_ms", rec) == pytest.approx(
        np.percentile(lat, 90))
    assert read("decode_step_ms.serve", rec) == pytest.approx(250.0)
    assert read("ttft_p90_ms.serve", rec) == pytest.approx(
        np.percentile([400.0] * 12 + [500.0], 90))
    # admitting steps take 500 ms, the median decode 250: 250 ms a prompt
    assert read("prefill_ms_per_ktok.serve", rec) == pytest.approx(250.0)
    mf = REG.model_flops(MAMBA)
    flops = 5 * mf.prefill(MAMBA, 1000) + 50 * mf.decode(MAMBA, 2000)
    assert read("serve_mfu", rec) == pytest.approx(
        100 * flops / 10.0 / 989e12)
    # no trace: the device readers have nothing to read
    for name in ("device_idle_share.serve", "ssd_scan_roofline.serve"):
        assert read(name, rec) is None


def test_a_step_past_the_window_is_not_counted():
    rec = serve_record()
    rec.steps.append(dict(t0=10.0, t1=11.0, admitted=[4000],
                          prefill_tokens=4000, gen=5, ctx=[4000] * 5))
    assert read("serve_tokens_per_s", rec) == pytest.approx(505.0)


def kernels_record() -> Record:
    rec = serve_record()
    # per second: an ssd_scan kernel of 10 ms, a GEMM of 5 ms, an
    # elementwise one of 100 ms; one kernel before the window
    rec.kernels = [("ssd_out_kernel_64", -1.0, -0.5)]
    for i in range(10):
        rec.kernels += [
            ("_anon::ssd_chunk_kernel<bf16>", i + 0.10, i + 0.11),
            ("sm90_xmma_gemm_bf16", i + 0.20, i + 0.205),
            ("at::native::elementwise_kernel", i + 0.30, i + 0.40),
            ("at::native::elementwise_kernel", i + 0.35, i + 0.45)]
    rec.spans = [(s["t0"], s["t1"], "admit" if s["admitted"] else "decode")
                 for s in rec.steps]
    return rec


def test_trace_reductions():
    rec = kernels_record()
    busy = trace.busy_s(rec.kernels, 0.0, 10.0)
    assert busy == pytest.approx(10 * (0.01 + 0.005 + 0.15))
    assert read("device_idle_share.serve", rec) == pytest.approx(
        100 * (1 - busy / 10.0))
    names = trace.by_name(rec.kernels, 0.0, 10.0)
    assert names["at::native::elementwise_kernel"] == pytest.approx(2.0)
    gaps = trace.idle_gaps(rec.kernels, rec.spans, 0.0, 10.0)
    assert sum(d for _, _, d in gaps) == pytest.approx(10.0 - busy)
    assert {g[0] for g in gaps} == {"admit", "decode", "between"}
    bd = trace.breakdown(rec.kernels, rec.spans, 0.0, 10.0)
    assert bd["device_ops"][0] == ["at::native::elementwise_kernel",
                                   pytest.approx(2.0)]
    assert len(bd["idle_gaps"]) <= 10
    assert sum(v for k, v in bd["idle_gaps"] if k.startswith("idle_in_")) \
        == pytest.approx(10.0 - busy)


def test_roofline_readers():
    rec = kernels_record()
    peaks = REG.count("peaks")
    # five 1,000-token prefills, one scan a layer: 48 heads of 64, state 128
    ssd = REG.count("ssd_scan").cost(1, 1000, 48, 64, 128, 256)
    least = 5 * 48 * peaks.bound_s(*ssd)
    assert read("ssd_scan_roofline.serve", rec) == pytest.approx(
        100 * least / 0.1)
    # a configuration of two B/C groups counts its scans so
    rec.cfg = dict(MAMBA, ssm_groups=2)
    two = REG.count("ssd_scan").cost(1, 1000, 48, 64, 128, 256, groups=2)
    assert two != ssd
    assert read("ssd_scan_roofline.serve", rec) == pytest.approx(
        100 * 5 * 48 * peaks.bound_s(*two) / 0.1)
    rec.kernels = [k for k in rec.kernels if "ssd" not in k[0]]
    assert read("ssd_scan_roofline.serve", rec) is None
