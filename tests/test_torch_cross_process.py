"""Cross-process restore in the port: a function snapshotted and exported
by one process restores in a fresh Python process with zero compiles.

The parent registers, serves, snapshots and exports a function, then
shuts its platform down; a child with its own interpreter imports the
exported record, restores the weights from the on-disk snapshot, serves
the function, and reports its program-cache stats: ``compiles`` must be
0 and ``disk_hits`` >= 1, because the parent's persisted program record
for the same key (and the kernel libraries it names: none are loaded on
the CPU) is still on disk. The port's analog of
tests/test_cross_process.py, on the CPU."""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import CallableSpec, HydraPlatform, LMSpec
from repro_torch.ft import checkpoint as ckpt
from repro_torch.models.programs import ModelProgram

MB = 1 << 20
REPO_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")

# the child rebuilds the SAME spec (program name + shapes, or the LM
# config = the cache key); the weights come from the snapshot
CHILD_SCRIPT = r"""
import json, sys
import torch
from repro_torch.configs import get_config
from repro_torch.core import CallableSpec, HydraPlatform, LMSpec

meta = json.load(open(sys.argv[1]))

def fn(params, args):
    return {"y": args["x"] * params["w"] + 1.0}

if meta["kind"] == "callable":
    spec = CallableSpec(name="xproc", fn=fn,
                        example_args={"x": torch.ones(64)},
                        params=None, arena_bytes=1 << 20)
    params_spec = {"w": torch.empty((64,), device="meta")}
else:
    spec = LMSpec(cfg=get_config(meta["arch"]).reduced(), params=None,
                  max_seq=64, slots=2)
    params_spec = {}             # nested dict of meta tensors
    for key, leaf in meta["leaves"].items():
        *head, last = key.split("/")
        d = params_spec
        for h in head:
            d = d.setdefault(h, {})
        d[last] = torch.empty(leaf["shape"],
                              dtype=getattr(torch, leaf["dtype"]),
                              device="meta")
plat = HydraPlatform(pool_size=1, runtime_budget_bytes=1 << 30,
                     snapshot_dir=meta["snapshot_dir"], device="cpu")
try:
    plat.import_function({
        "fid": meta["fid"], "spec": spec, "tenant": meta["tenant"],
        "mem_budget": meta["mem_budget"], "need_bytes": meta["need_bytes"],
        "params_spec": params_spec, "invocations": meta["invocations"],
        "snapshot_path": meta["snapshot_path"]})
    plat.restore(meta["fid"])
    if meta["kind"] == "callable":
        out = plat.invoke(meta["fid"], {"x": torch.full((64,), 3.0)})
        result = float(out["y"][0])
    else:
        result = plat.generate(meta["fid"], list(range(8)), max_new_tokens=5)
    print(json.dumps({"result": result, **plat.exe_cache.stats()}))
finally:
    plat.shutdown()
"""


def run_child(tmp_path, meta: dict) -> dict:
    meta_path = tmp_path / "export.json"
    meta_path.write_text(json.dumps(meta))
    child = tmp_path / "child.py"
    child.write_text(CHILD_SCRIPT)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, str(child), str(meta_path)],
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def export_meta(plat, exported, kind: str, **extra) -> dict:
    return {"kind": kind, "snapshot_dir": plat.params.snapshot_dir,
            "fid": exported["fid"], "tenant": exported["tenant"],
            "mem_budget": exported["mem_budget"],
            "need_bytes": exported["need_bytes"],
            "invocations": exported["invocations"],
            "snapshot_path": exported["snapshot_path"], **extra}


def test_restore_in_fresh_process_zero_recompiles(tmp_path):
    def fn(params, args):
        return {"y": args["x"] * params["w"] + 1.0}

    spec = CallableSpec(name="xproc", fn=fn,
                        example_args={"x": torch.ones(64)},
                        params={"w": torch.full((64,), 2.0)},
                        arena_bytes=1 * MB)
    plat = HydraPlatform(pool_size=1, runtime_budget_bytes=64 * MB,
                         snapshot_dir=str(tmp_path), device="cpu")
    try:
        plat.register_function("t0/f", spec, tenant="t0")
        before = plat.invoke("t0/f", {"x": torch.full((64,), 3.0)})
        exported = plat.export_function("t0/f")
    finally:
        plat.shutdown()
    # one program; the reference's 2 include its compiled arena zeroer
    assert plat.exe_cache.stats()["compiles"] == 1

    stats = run_child(tmp_path, export_meta(plat, exported, "callable"))
    assert stats["result"] == float(before["y"][0]) == 7.0
    assert stats["compiles"] == 0
    assert stats["disk_hits"] >= 1
    assert stats["xla_cache_enabled"] is False    # no XLA in the port


@pytest.mark.parametrize("arch", ["qwen2.5-3b"])
def test_lm_restores_in_fresh_process_with_same_tokens(tmp_path, arch):
    cfg = get_config(arch).reduced()
    params = ModelProgram(cfg).init(0, device="cpu", dtype=torch.bfloat16)
    leaves = {k: {"shape": list(v.shape), "dtype": ckpt.dtype_name(v.dtype)}
              for k, v in ckpt._flatten(params).items()}
    plat = HydraPlatform(pool_size=1, runtime_budget_bytes=1 << 30,
                         snapshot_dir=str(tmp_path), device="cpu")
    try:
        plat.register_function("t0/lm", LMSpec(cfg=cfg, params=params,
                                               max_seq=64, slots=2),
                               tenant="t0")
        before = plat.generate("t0/lm", list(range(8)), max_new_tokens=5)
        exported = plat.export_function("t0/lm")
    finally:
        plat.shutdown()
    assert plat.exe_cache.stats()["compiles"] == 2   # decode + one prefill

    meta = export_meta(plat, exported, "lm", arch=arch, leaves=leaves)
    stats = run_child(tmp_path, meta)
    assert stats["result"] == before
    assert stats["compiles"] == 0
    assert stats["disk_hits"] == 2
