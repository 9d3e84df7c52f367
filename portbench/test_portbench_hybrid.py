"""The published Zamba2 block (the ``hybrid`` family with
``hybrid_layer_ids``) in the harness: a reduced configuration from a
test directory of its own (``test_hybrid/``) runs ``correct`` through
``run.run_cell`` on the CPU with its per-layer metrics read; its model
flops against a count worked by hand at the published sizes; the new
readers on hand-made timelines; and the ssm family's weights as they
were."""
from __future__ import annotations

import hashlib
import json

import pytest
import torch

from portbench import run, weights
from portbench.conftest import write_parts
from portbench.record import Record
from portbench.registry import HERE, Registry
from portbench.test_portbench_lm_trace import step
from portbench.test_portbench_metrics import DOCS, MAMBA

PARTS = HERE / "test_hybrid"
ZAMBA = json.loads((HERE / "configs/zamba2-7b-instruct.json").read_text())
CELL = "tiny-hybrid-docs"
NEW = ("flash_attention_roofline.serve", "decode_attention_roofline.serve",
       "shared_block_share.serve")
# the kernel the CPU run's kernel spans stand for, by the span's name
STAND_INS = {"flash_attention": "flash_wgmma_kernel<32>",
             "decode_attention": "decode_pv_kernel<bf16, 32, 1>",
             "ssd_scan": "ssd_chunk_kernel<16>", "rmsnorm": "rmsnorm_kernel"}


def hybrid_spec(tmp_path) -> dict:
    spec = write_parts(tmp_path)
    spec["workloads"].append(dict(name=CELL, config="tiny-hybrid",
                                  traffic="tiny-docs", chips=1))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    return spec


class CpuTrace:
    """The device trace's stand-in on the CPU: a CPU profiler records
    while it is on, so the batcher records its spans, and each kernel
    span the program recorded in the window becomes a kernel over the
    same stretch, under the name its CUDA kernel has."""

    def __init__(self, on, device):
        self.on, self.kernels, self._prof = on, [], None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        if self.on:
            self._prof = profile(activities=[ProfilerActivity.CPU])
            self._prof.__enter__()

    def stop(self):
        from repro_torch.core.tracing import profile_tracer
        if self._prof is None:
            return
        self._prof.__exit__(None, None, None)
        self._prof = None
        self.kernels = sorted(
            (STAND_INS[s[3]["name"]], s[1], s[2])
            for _, sps in profile_tracer().steps() for s in sps
            if s[0] == "kernel" and s[3]["name"] in STAND_INS)


@pytest.mark.parametrize("seed", [2**31 + 13, 77])
def test_a_reduced_hybrid_runs_correct_with_its_metrics(tmp_path,
                                                        monkeypatch, seed):
    from repro_torch.core.tracing import take_profile_tracer

    from portbench.drivers import serving
    from portbench.registry import ROOT
    before = (ROOT / "portbench/lm_trace.py").read_bytes()
    reg = Registry([PARTS, tmp_path], hybrid_spec(tmp_path))
    cfg = reg.config("tiny-hybrid")
    assert cfg["family"] == "hybrid" and cfg["ssm_groups"] == 2
    monkeypatch.setattr(serving, "DeviceTrace", CpuTrace)
    take_profile_tracer()
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res, rec = run.run_cell(reg, CELL, seed, 2.0, True,
                                torch.device("cpu"))
    finally:
        torch.set_num_threads(torch_threads)
    assert res["correct"], rec.checks
    m = {k: v["value"] for k, v in res["metrics"].items()}
    mf = reg.model_flops(cfg)
    flops = sum(sum(mf.prefill(cfg, S) for S in s["admitted"])
                + sum(mf.decode(cfg, c) for c in s["ctx"])
                for s in rec.window_steps())
    assert m["serve_mfu"] == pytest.approx(100 * flops / rec.window_s
                                           / 989e12) and flops > 0
    for name in NEW + ("ssd_scan_roofline.serve",):
        assert m[name] > 0, name
    assert m["shared_block_share.serve"] < 100
    assert (ROOT / "portbench/lm_trace.py").read_bytes() == before


def test_model_flops_at_the_published_sizes_by_hand():
    mf = Registry().model_flops(ZAMBA)
    # in_proj 3584 x (7168 + 7168 + 2*2*64 + 112), conv 4 x 7424, out_proj
    # 7168 x 3584
    mamba = 3584 * 14704 + 4 * 7424 + 7168 * 3584
    assert mamba == mf.mamba_params(ZAMBA) == 78_418_944
    # q, k, v from 7168 to 32 x 224 each, o 7168 x 3584, MLP 3 x 3584 x
    # 14336, adapter 128 x (3584 + 28672), linear 3584 x 3584
    inv = (3 * 7168 * 7168 + 7168 * 3584 + 3 * 3584 * 14336
           + 128 * (3584 + 28672) + 3584 * 3584)
    assert inv == mf.invocation_params(ZAMBA) == 350_945_280
    body = 81 * mamba + 13 * inv
    head = 3584 * 32000
    # S = 2,500 in chunks of 256: 9 full and one of 196, so 9 x 32,896 +
    # 19,306 (l, s) pairs with s <= l; a scan layer: C B^T per group, the
    # diagonal products per head, states and their read
    pairs = 9 * 256 * 257 // 2 + 196 * 197 // 2
    scan = (2 * 2 * pairs * 64 + 2 * 112 * pairs * 64
            + 4 * 112 * 2500 * 64 * 64)
    attn = 4 * 13 * 32 * 224 * (2500 * 2501 // 2)
    assert mf.prefill(ZAMBA, 2500) == pytest.approx(
        2 * body * 2500 + 2 * head + 81 * scan + attn, rel=1e-12)
    assert mf.decode(ZAMBA, 2700) == pytest.approx(
        2 * (body + head) + 4 * 112 * 64 * 64 * 81
        + 4 * 13 * 32 * 224 * 2700, rel=1e-12)
    # the shared blocks take 42% of the body's weights a token meets
    assert 13 * inv / body == pytest.approx(0.418, abs=1e-3)


def hybrid_record(kernels, steps) -> Record:
    reg = Registry()
    rec = Record(cfg=ZAMBA, mix=DOCS, registry=reg, t0=0.0, t1=10.0)
    rec.steps = steps
    rec.kernels = kernels
    return rec


def test_attention_rooflines_on_a_hand_made_timeline():
    peaks = Registry().count("peaks")
    steps = [dict(t0=i, t1=i + 1.0, admitted=[1000] if i % 2 else [],
                  prefill_tokens=0, gen=2, ctx=[2000, 3000])
             for i in range(10)]
    ks = [("void flash_wgmma_kernel<224>(...)", i + 0.1, i + 0.2)
          for i in range(1, 10, 2)]
    ks += [("decode_scores_kernel", i + 0.5, i + 0.52) for i in range(10)]
    ks += [("decode_pv_kernel", i + 0.6, i + 0.63) for i in range(10)]
    ks += [("flash_attention_bwd_dq", 3.0, 3.5), ("elementwise", 4.0, 5.0)]
    rec = hybrid_record(ks, steps)
    reg = Registry()
    flash = 13 * 5 * peaks.bound_s(
        1000 * 224 * (2 * 32 + 2 * 32) * 2, 4.0 * 32 * 224 * 1000 * 1001 // 2)
    assert reg.reader("flash_attention_roofline.serve")(rec) == \
        pytest.approx(100 * flash / 0.5)
    kv = 2 * 5000 * 32 * 224 * 2 + 2 * 2 * 32 * 224 * 2
    dec = 13 * 10 * peaks.bound_s(kv, 4.0 * 32 * 224 * 5000)
    assert reg.reader("decode_attention_roofline.serve")(rec) == \
        pytest.approx(100 * dec / 0.5)
    # no such kernel, or a configuration without attention: nothing
    assert reg.reader("flash_attention_roofline.serve")(
        hybrid_record([("elementwise", 1.0, 2.0)], steps)) is None
    rec.cfg = dict(ZAMBA, hybrid_layer_ids=[])
    for name in ("flash_attention_roofline.serve",
                 "decode_attention_roofline.serve"):
        assert reg.reader(name)(rec) is None


@pytest.mark.parametrize("name", ["flash_attention_roofline.serve",
                                  "decode_attention_roofline.serve"])
def test_attention_rooflines_refuse_a_family_without_a_call_count(name):
    """The calls a forward makes come from the family's flops count; a
    family whose count has none (the ssm family's) raises, as serve_mfu
    does for a family with no count, and no other family's stands in."""
    steps = [dict(t0=0.0, t1=1.0, admitted=[1000], prefill_tokens=0,
                  gen=2, ctx=[2000])]
    rec = hybrid_record([("void flash_wgmma_kernel<224>(...)", 0.1, 0.2),
                         ("decode_pv_kernel", 0.5, 0.6)], steps)
    rec.cfg = dict(MAMBA, n_heads=32, n_kv_heads=32, head_dim=224)
    with pytest.raises(AttributeError, match="attention_calls"):
        Registry().reader(name)(rec)


def test_shared_block_share_on_a_hand_made_timeline():
    reg = Registry()
    rec = hybrid_record([], [])
    steps = []
    for i in range(4):
        sid, sps = step(i, admit=i % 2 == 0)
        if i % 2 == 0:        # a shared span inside the prefill's mixer
            sps = sorted(sps + [("shared", i + 0.25, i + 0.3,
                                 {"block": 0, "invocation": 0})],
                         key=lambda s: (s[1], -s[2]))
        steps.append((sid, sps))
    rec.extra["lm_trace"] = {"requests": [], "steps": steps}
    # per admitting step: 0.05 s of device time inside the shared span,
    # 0.1 s in the prefill outside it; decode work counts nowhere
    rec.kernels = []
    for i in (0, 2):
        rec.kernels += [("gemm", i + 0.26, i + 0.31),
                        ("ssd_chunk_kernel", i + 0.15, i + 0.25),
                        ("gemm", i + 0.6, i + 0.7)]
    assert reg.reader("shared_block_share.serve")(rec) == \
        pytest.approx(100 * 0.05 / 0.15)
    rec.extra["lm_trace"] = None
    assert reg.reader("shared_block_share.serve")(rec) is None


def _digest_small_leaves(reg, cfg, seed) -> str:
    """sha256 of the ssm layout (paths, shapes, kinds) and of the values
    of its leaves under 1M elements at ``seed`` (the projections' values
    come from the same calls on larger shapes)."""
    h = hashlib.sha256()
    for path, (shape, kind) in weights.layout(reg, cfg).items():
        h.update(f"{path}{shape}{kind}".encode())
        n = 1
        for d in shape:
            n *= d
        if n < 1 << 20:
            t = weights.make_leaf(seed, path, (shape, kind), torch.float32,
                                  "cpu")
            h.update(t.numpy().tobytes())
    return h.hexdigest()


def test_the_mamba2_weights_are_as_they_were():
    reg = Registry()
    assert _digest_small_leaves(reg, MAMBA, 2**31 + 1) == (
        "0254b50934e339516bccb31ce85de7881366afab25ded09a9899f24478fe806c")


def test_a_hybrid_reference_refuses_the_jax_layout():
    from portbench.reference import hybrid
    old = dict(ZAMBA, hybrid_layer_ids=None, name="zamba2-2.7b")
    with pytest.raises(ValueError, match="hybrid_layer_ids"):
        hybrid.shapes(old)
