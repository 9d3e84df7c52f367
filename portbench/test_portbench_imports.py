"""Nothing the benchmark runs imports JAX, the JAX package or the JAX
side's benchmarks (top-level module names compared whole), and the plain
references import nothing of the port."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

from portbench import run

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def imported(path: Path) -> set:
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not imported(path) & FORBIDDEN, path
    assert "repro_torch" not in FORBIDDEN   # the port's name is allowed


def test_references_import_nothing_of_the_port():
    allowed = {"__future__", "contextlib", "math", "torch", "portbench"}
    for path in (HERE / "reference").glob("*.py"):
        assert imported(path) <= allowed, path
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("portbench"):
                assert node.module.startswith("portbench.reference"), path


def test_a_run_loads_no_jax_and_writes_only_where_it_may(tmp_path):
    """Every part of the benchmark loaded and a reduced serving cell run
    in a fresh process: no forbidden top-level module in sys.modules, and
    no file written outside the checkout, HOME, XDG_CACHE_HOME and
    TMPDIR (Python's audit events for opens and directory changes)."""
    code = (
        "import sys, os, json, tempfile, pathlib\n"
        "written = []\n"
        "def hook(event, args):\n"
        "    if event == 'open' and isinstance(args[0], str) and (\n"
        "            any(m in str(args[1]) for m in 'wax+')\n"
        "            or (args[2] or 0) & (os.O_WRONLY | os.O_RDWR)):\n"
        "        written.append(os.path.realpath(args[0]))\n"
        "    elif event in ('os.mkdir', 'os.rename', 'os.replace'):\n"
        "        written.append(os.path.realpath(str(args[0])))\n"
        "sys.addaudithook(hook)\n"
        "import torch\n"
        f"sys.path[:0] = [{str(HERE.parent)!r}, {str(HERE.parent / 'src')!r}]\n"
        "from portbench import run, readings, faults\n"
        "from portbench.conftest import write_parts\n"
        "from portbench.registry import Registry\n"
        "d = pathlib.Path(tempfile.mkdtemp())\n"
        "reg = Registry([d], write_parts(d))\n"
        "for kind in ('metrics', 'counts', 'reference', 'drivers'):\n"
        "    for p in (pathlib.Path(run.ROOT) / 'portbench' / kind)"
        ".glob('*.py'):\n"
        "        reg.module(kind, p.stem)\n"
        "res, rec = run.run_cell(reg, 'tiny-ssm-docs', 3, 3.0, False, "
        "torch.device('cpu'))\n"
        "print(json.dumps([res['correct'], run.forbidden_modules(), "
        "written]))\n")
    env = dict(os.environ, HOME=str(tmp_path / "home"),
               XDG_CACHE_HOME=str(tmp_path / "cache"),
               TMPDIR=str(tmp_path / "tmp"), PYTHONDONTWRITEBYTECODE="1",
               OMP_NUM_THREADS="1")
    for d in ("home", "cache", "tmp"):
        (tmp_path / d).mkdir()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(HERE.parent),
                         env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    correct, found, written = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and found == []
    # every file the run opened for writing lies in the checkout or in the
    # run's own HOME, XDG_CACHE_HOME or TMPDIR: none in /tmp, /dev/shm
    allowed = [os.path.realpath(p) for p in
               (HERE.parent, tmp_path / "home", tmp_path / "cache",
                tmp_path / "tmp")]
    for path in written:
        assert path == os.devnull or any(path == a or path.startswith(a + os.sep)
                   for a in allowed), path


def test_forbidden_names_are_whole_top_level_names():
    ok = ["repro_torch", "repro_torch.core.runtime", "reprox", "jaxtyping",
          "benchmarks_x", "torch"]
    assert run.forbidden_modules(ok) == []
    assert run.forbidden_modules(ok + ["repro.core", "jax.numpy"]) == \
        ["jax", "repro"]
