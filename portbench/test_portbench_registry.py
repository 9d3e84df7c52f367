"""The harness is driven by data: a later change adds a configuration, a
mix, a metric, a count and a reference as files of their own, found by
name, and edits no file that is there."""
from __future__ import annotations

import hashlib
import json
from pathlib import Path

import pytest
import torch

from portbench import run
from portbench.conftest import SSM, write_parts
from portbench.registry import HERE, Registry


def digest() -> str:
    h = hashlib.sha256()
    for p in sorted(HERE.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(p.read_bytes())
    return h.hexdigest()


def test_parts_added_from_a_directory_of_their_own(tmp_path):
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
    res, rec = run.run_cell(reg, "wider-short", 2**31 + 9, 3.0, True,
                            torch.device("cpu"))
    assert res["correct"], rec.checks
    n = sum(len(s["admitted"]) for s in rec.window_steps())
    assert res["metrics"]["admitted_prompts.serve"]["value"] == 2 * n > 0
    assert digest() == before


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
        reg.module("reference", cfg["family"])
    assert Path(HERE.parent / spec["command"][1]).is_file()
