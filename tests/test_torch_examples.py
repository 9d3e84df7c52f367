"""The port's five examples (``examples/torch_*.py``) on the CPU.

* ``torch_trace_replay.py`` prints what ``examples/trace_replay.py``
  prints, byte for byte once the trace's path is normalised: the same
  simulator copies, the same traces.
* The quickstart's flow, with the reference's LM weights and catalog
  params carried across, gives the reference's shapes, its 8 tokens and
  its function and arena counters.
* ``torch_gateway_replay.py --device cpu`` passes its gates;
  ``torch_serve_multitenant.py --device cpu`` serves both legs;
  ``torch_train_lm.py --device cpu --steps 30`` restores at its injected
  failure and resumes on the losses it had, which stay finite and fall.
* Without ``--device`` an example runs on CUDA, and with no GPU it
  raises: there is no fallback to the CPU.
"""
import ast
import importlib.util
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import functions as jfunctions
from repro.configs import get_config as jget_config
from repro.models.programs import ModelProgram as JProgram
from repro_torch.configs import get_config
from repro_torch.functions import catalog_params_from_numpy
from repro_torch.models.convert import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
SAMPLE = str(ROOT / "benchmarks" / "data" / "azure_sample.csv")


def run_example(name: str, *args, tmp_path=None, timeout=120, env=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               **(env or {}))
    if tmp_path is not None:
        env["TMPDIR"] = str(tmp_path)
    return subprocess.run([sys.executable, str(EXAMPLES / name), *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)


def load_example(name: str, monkeypatch):
    """The example file as a module (its sys.path edits undone after
    the test)."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        f"example_{Path(name).stem}", EXAMPLES / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trace_replay_prints_the_reference_output():
    ref = run_example("trace_replay.py")
    port = run_example("torch_trace_replay.py")
    assert ref.returncode == 0, ref.stderr
    assert port.returncode == 0, port.stderr
    norm = lambda s: s.replace(os.path.realpath(SAMPLE), "<sample>") \
        .replace(SAMPLE, "<sample>")
    assert "== azure replay:" in port.stdout
    assert norm(port.stdout) == norm(ref.stdout)


def printed(out: str) -> dict:
    """The quickstart's printed values, by label."""
    vals = {}
    for line in out.splitlines():
        m = re.match(r"\s*(filehashing|thumbnail|lm generate)\s+-> (.*)",
                     line) or re.match(r"\s+(functions|arenas):\s+(.*)", line)
        if m:
            vals[m.group(1)] = ast.literal_eval(m.group(2))
    return vals


def test_quickstart_flow_matches_reference(monkeypatch, capsys):
    """The reference example's printed values against the port's flow on
    the same weights: the reference's seeded LM init cast to bf16 and its
    catalog params, carried across as numpy arrays."""
    load_example("quickstart.py", monkeypatch).main()
    want = printed(capsys.readouterr().out)
    assert set(want) == {"filehashing", "thumbnail", "lm generate",
                         "functions", "arenas"}

    jcfg = jget_config("qwen2.5-3b").reduced()
    jparams = jax.tree.map(
        lambda x: np.asarray(x.astype(jnp.bfloat16)
                             if x.dtype == jnp.float32 else x),
        JProgram(jcfg).init(jax.random.PRNGKey(0)))
    jcat = jfunctions.catalog()
    catalog_params = catalog_params_from_numpy(
        {k: jax.tree.map(np.asarray, s.params) for k, s in jcat.items()
         if s.params is not None}, "cpu")
    quickstart = load_example("torch_quickstart.py", monkeypatch)
    res = quickstart.run("cpu", get_config("qwen2.5-3b").reduced(),
                         quickstart.BUDGET,
                         params_from_numpy(jparams, "cpu"),
                         catalog_params=catalog_params)
    got = printed(capsys.readouterr().out)
    assert got == want
    assert res["tokens"] == want["lm generate"] and len(res["tokens"]) == 8
    assert res["filehashing"] == {"digest": ()}
    assert res["thumbnail"] == (64, 64, 3)
    assert res["stats"]["exe_cache"]["compiles"] >= 3
    assert res["generate_s"] > 0


def test_quickstart_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    quickstart = load_example("torch_quickstart.py", monkeypatch)
    with pytest.raises(RuntimeError, match="no GPU is visible"):
        quickstart.main([])


@pytest.mark.parametrize("name", ["torch_gateway_replay.py",
                                  "torch_serve_multitenant.py",
                                  "torch_train_lm.py"])
def test_examples_refuse_to_fall_back_to_the_cpu(name):
    """Run as a user runs them, without --device, where no GPU is
    visible: each raises resolve_device's error before doing any work."""
    args = ("--steps", "2") if name == "torch_train_lm.py" else ()
    out = run_example(name, *args, env={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "no GPU is visible" in out.stderr


def test_gateway_replay_passes_its_gates():
    out = run_example("torch_gateway_replay.py", "--device", "cpu")
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "live gateway: 1172 served" in out.stdout
    assert "-> FAIL" not in out.stdout
    assert out.stdout.count("-> PASS") >= 4
    assert "derived calibration" in out.stdout


def test_serve_multitenant_serves_both_legs():
    out = run_example("torch_serve_multitenant.py", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    single = lines.index("=== single-node HydraPlatform ===")
    cluster = lines.index("=== two-node HydraCluster ===")
    for leg in (lines[single:cluster], lines[cluster:]):
        served = [ln for ln in leg if ln.startswith("[serve] 24 requests")]
        assert len(served) == 1
        assert int(re.search(r"(\d+) tokens", served[0]).group(1)) == 24 * 12
    assert any("platform: " in ln for ln in lines[single:cluster])
    assert any("cluster placement" in ln for ln in lines[cluster:])
    assert "on cpu" in out.stdout


def test_train_lm_restores_at_its_failure(tmp_path):
    out = run_example("torch_train_lm.py", "--device", "cpu", "--steps",
                      "30", tmp_path=tmp_path, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    text = out.stdout
    assert "[train] FAILURE: injected node failure at step 25" in text
    assert "[train] restored step 0, resuming at 1" in text
    before, after = text.split("[train] restored step")
    step = re.compile(r"\[train\] step\s+(\d+) loss\s+(\S+)")
    first = {int(s): float(v) for s, v in step.findall(before)}
    second = {int(s): float(v) for s, v in step.findall(after)}
    assert set(first) == {0, 5, 10, 15, 20}
    assert set(second) == {5, 10, 15, 20, 25, 29}
    for s in (5, 10, 15, 20):            # resumed on the same run
        assert second[s] == first[s]
    losses = list(first.values()) + list(second.values())
    assert all(math.isfinite(v) for v in losses)
    done = re.search(r"first loss (\S+) last loss (\S+);", text)
    assert float(done.group(2)) < float(done.group(1))
    ckpt = re.search(r"checkpoints in (\S+)", text).group(1)
    assert Path(ckpt).parent == tmp_path
    assert sorted(os.listdir(ckpt))
