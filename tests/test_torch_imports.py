"""repro_torch stands alone: no file of the port, nor chip_smoke.py,
chip_ab.py, chip_mesh.py or the port's examples (``examples/torch_*.py``),
imports ``jax``, anything of the reference package ``repro`` or
``benchmarks`` (whose modules import ``repro``), and importing every
module of the port leaves ``jax`` unloaded."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def port_files() -> list:
    return (sorted(PORT.rglob("*.py"))
            + [ROOT / "chip_smoke.py", ROOT / "chip_ab.py",
               ROOT / "chip_mesh.py"]
            + sorted((ROOT / "examples").glob("torch_*.py")))


def imported_modules(path: Path) -> list:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_port_has_files():
    files = port_files()
    assert len(files) > 30
    assert (PORT / "kernels" / "csrc" / "rmsnorm.cu").exists()
    examples = [p.name for p in files if p.parent.name == "examples"]
    assert examples == ["torch_gateway_replay.py", "torch_quickstart.py",
                        "torch_serve_multitenant.py", "torch_trace_replay.py",
                        "torch_train_lm.py"]


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro", "benchmarks"), \
            f"{path.relative_to(ROOT)} imports {mod}"


def test_importing_every_port_module_leaves_jax_out():
    code = """
import importlib, json, pkgutil, sys
import repro_torch
mods = []
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    if info.name.endswith("__main__"):
        continue
    importlib.import_module(info.name)
    mods.append(info.name)
print(json.dumps({"mods": mods,
                  "jax": [m for m in sys.modules if m.split(".")[0] == "jax"],
                  "repro": [m for m in sys.modules
                            if m.split(".")[0] == "repro"]}))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["jax"] == [] and res["repro"] == []
    for mod in ("repro_torch.core.runtime", "repro_torch.kernels.ops",
                "repro_torch.launch.serve", "repro_torch.models.convert",
                "repro_torch.gateway", "repro_torch.gateway.validate",
                "repro_torch.functions"):
        assert mod in res["mods"]
