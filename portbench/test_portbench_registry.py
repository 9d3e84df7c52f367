"""The harness is driven by data: a later change adds a configuration, a
mix, a metric, a count and a reference as files of their own, found by
name, and edits no file that is there; a configuration of another model
family brings its reference, weights' layout and model flops so too.

The runs here are on the CPU, on a step clock (``conftest.StepClock``),
so that what their windows hold does not depend on the host's load."""
from __future__ import annotations

import hashlib
import json
from pathlib import Path

import pytest
import torch

from portbench import run, weights
from portbench.conftest import SSM, write_parts
from portbench.program import arch_config
from portbench.record import Record
from portbench.registry import HERE, Registry


def digest() -> str:
    h = hashlib.sha256()
    for p in sorted(HERE.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(p.read_bytes())
    return h.hexdigest()


FAMILY = HERE / "test_family"     # the ``dense`` family's parts


def test_parts_added_from_a_directory_of_their_own(tmp_path, step_clock):
    before = digest()
    spec = write_parts(tmp_path)
    (tmp_path / "configs/wider-ssm.json").write_text(json.dumps(dict(
        SSM, name="wider-ssm", d_model=96)))
    (tmp_path / "traffic/short.json").write_text(json.dumps(dict(
        kind="serving", callers=2, slots=2, max_seq=32,
        prompt=dict(dist="fixed", value=12, min=12, max=12),
        output=dict(dist="uniform", min=3, max=4), block=4,
        check=dict(tokens=8))))
    (tmp_path / "limits/wider-short.json").write_text(json.dumps(
        {"numbers": {"token_gap": {"limit": 0.1}}}))
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics/admitted_prompts.serve.py").write_text(
        "def read(run):\n"
        "    n = run.registry.count('twice').twice(sum(len(s['admitted'])\n"
        "        for s in run.window_steps()))\n"
        "    return n or None\n")
    (tmp_path / "counts").mkdir()
    (tmp_path / "counts/twice.py").write_text(
        "def twice(n):\n    return 2 * n\n")
    (tmp_path / "reference").mkdir()
    (tmp_path / "reference/other.py").write_text(
        "from portbench.reference import ssm\nlogits = ssm.logits\n")
    spec["workloads"].append(dict(name="wider-short", config="wider-ssm",
                                  traffic="short", chips=1))
    spec["per_layer"].append(dict(
        name="admitted_prompts.serve", unit="prompts", better="higher",
        source="host_clock", layer="core/scheduler",
        moves="serve_tokens_per_s", workloads=["wider-short"]))
    reg = Registry([tmp_path], spec)
    assert reg.config("wider-ssm")["d_model"] == 96
    assert reg.module("reference", "other").logits is \
        reg.module("reference", "ssm").logits
    assert reg.config("mamba2-780m")["d_model"] == 1536   # the package's
    res, rec = run.run_cell(reg, "wider-short", 2**31 + 9, 1.0, True,
                            torch.device("cpu"), t_start=0.0)
    assert res["correct"], rec.checks
    n = sum(len(s["admitted"]) for s in rec.window_steps())
    assert res["metrics"]["admitted_prompts.serve"]["value"] == 2 * n > 0
    assert digest() == before


def dense_spec(tmp_path) -> dict:
    """The reduced cells' spec with a cell of the ``dense`` family, on
    every package metric that a dense model has (no SSD scan)."""
    spec = write_parts(tmp_path)
    spec["workloads"].append(dict(name="tiny-dense-answers",
                                  config="tiny-dense",
                                  traffic="tiny-answers", chips=1))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and not m["name"].startswith("ssd_scan"):
            m["workloads"].append("tiny-dense-answers")
    return spec


@pytest.mark.parametrize("seed", [2**31 + 11, 5])
def test_a_family_joins_from_a_directory_of_its_own(tmp_path, step_clock,
                                                    seed):
    before = digest()
    reg = Registry([FAMILY, tmp_path], dense_spec(tmp_path))
    cfg = reg.config("tiny-dense")
    assert cfg["family"] == "dense" and cfg["n_kv_heads"] < cfg["n_heads"]
    for mod in (reg.reference(cfg), reg.model_flops(cfg)):
        assert Path(mod.__file__).parent.parent == FAMILY
    res, rec = run.run_cell(reg, "tiny-dense-answers", seed, 1.0, True,
                            torch.device("cpu"), t_start=0.0)
    assert res["correct"], rec.checks
    mf = reg.model_flops(cfg)
    flops = sum(sum(mf.prefill(cfg, S) for S in s["admitted"])
                + sum(mf.decode(cfg, c) for c in s["ctx"])
                for s in rec.window_steps())
    assert res["metrics"]["serve_mfu"]["value"] == pytest.approx(
        100 * flops / rec.window_s / 989e12) and flops > 0
    assert "ssd_scan_roofline.serve" not in res["metrics"]
    assert digest() == before


def test_the_dense_reference_is_the_ports_model():
    from repro_torch.models import transformer as tf
    reg = Registry([FAMILY])
    cfg = dict(reg.config("tiny-dense"), dtype="float32")
    for tied in (True, False):
        c = dict(cfg, tie_embeddings=tied)
        params = weights.make(reg, c, 2**31 + 3, torch.float32, "cpu")
        assert list(weights.flatten(params)) == list(
            weights.layout(reg, c))
        tokens = torch.randint(0, c["vocab_size"], (2, 19),
                               generator=torch.Generator().manual_seed(2))
        port = tf.forward(params, arch_config(c), tokens)[0]
        ref = reg.reference(c).logits(params, c, tokens)
        torch.testing.assert_close(ref, port, rtol=1e-4, atol=1e-4)


def test_a_family_without_a_flops_count_is_refused(tmp_path):
    spec = dense_spec(tmp_path)
    reg = Registry([tmp_path], spec)       # the dense parts left out
    (tmp_path / "configs/tiny-dense.json").write_text(
        (FAMILY / "configs/tiny-dense.json").read_text())
    cfg = reg.config("tiny-dense")
    with pytest.raises(FileNotFoundError, match="model_flops.dense"):
        reg.model_flops(cfg)
    rec = Record(cfg=cfg, mix=reg.mix("tiny-docs"), registry=reg, t0=0.0,
                 t1=1.0, steps=[dict(t0=0.1, t1=0.2, admitted=[12],
                                     prefill_tokens=12, gen=1, ctx=[])])
    with pytest.raises(FileNotFoundError):
        reg.reader("serve_mfu")(rec)


def test_unknown_names_are_refused(tmp_path):
    reg = Registry([tmp_path], write_parts(tmp_path))
    with pytest.raises(FileNotFoundError):
        reg.config("no-such-config")
    with pytest.raises(ValueError):
        reg.mix("../traffic/docs")
    with pytest.raises(KeyError):
        reg.workload("no-such-cell")


def test_the_benchmark_file_names_only_parts_that_exist():
    reg = Registry()
    spec = reg.spec
    for w in spec["workloads"]:
        reg.config(w["config"]), reg.mix(w["traffic"]), reg.limits(w["name"])
        kind = reg.mix(w["traffic"])["kind"]
        assert callable(reg.module("drivers", kind).run)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(reg.reader(m["name"]))
    for c in spec["configs"]:
        cfg = json.loads((HERE.parent / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        layout = reg.reference(cfg).shapes(cfg)
        assert layout and all(len(leaf) == 2 for leaf in layout.values())
        mf = reg.model_flops(cfg)
        assert mf.prefill(cfg, 64) > mf.decode(cfg, 64) > 0
    assert Path(HERE.parent / spec["command"][1]).is_file()
