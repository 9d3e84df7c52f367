"""Run a reference test module's assertions against the port's copies.

``port_tests("test_sim")`` reads ``tests/test_sim.py``, points its imports
of ``repro.core``, ``repro.gateway``, ``repro.data``, ``repro.ft``,
``repro.optim`` and ``repro.launch`` at the same modules of
``repro_torch``, executes the result as a
module of its own, and returns its test functions (with their
``parametrize`` marks) and the fixtures they need. A ``test_torch_*.py``
file binds them at module level, where pytest collects them as its own
tests: the same assertions then hold the port's copy, with no second copy
of the test code. Tracebacks point at the reference test's lines.
"""
from __future__ import annotations

import re
from pathlib import Path

TESTS = Path(__file__).resolve().parent


def port_tests(module: str, *, include=None, exclude=(), fixtures=(),
               drop_lines=(), replace=()) -> dict:
    """{name: object} for the test functions of ``tests/<module>.py``
    (all, or those in ``include``, less those in ``exclude``) and the
    named ``fixtures``, executed against the port. ``drop_lines`` are
    source lines removed first (imports of modules not ported yet; the
    tests that need them go in ``exclude``). ``replace`` is a sequence of
    ``(old, new)`` source substitutions, each of which must occur: the
    port runs on CUDA unless told otherwise, so a test that builds a
    stack with no device is pinned to the CPU this way, e.g.
    ``("PlatformParams(", 'PlatformParams(device="cpu", ')``."""
    path = TESTS / f"{module}.py"
    src = path.read_text()
    for line in drop_lines:
        if line not in src.splitlines():
            raise ValueError(f"{module}: no line {line!r} to drop")
        src = src.replace(line + "\n", "")
    for old, new in replace:
        if old not in src:
            raise ValueError(f"{module}: no {old!r} to replace")
        src = src.replace(old, new)
    src = re.sub(r"\brepro\.(core|gateway|data|ft|optim|launch)\b",
                 r"repro_torch.\1", src)
    ns = {"__name__": f"{module}_on_port", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), ns)  # noqa: S102 — the repo's own test
    names = [n for n in ns if n.startswith("test_") and callable(ns[n])]
    if include is not None:
        missing = set(include) - set(names)
        if missing:
            raise ValueError(f"{module}: no tests {sorted(missing)}")
        names = [n for n in names if n in include]
    unknown = set(exclude) - set(names)
    if unknown:
        raise ValueError(f"{module}: cannot exclude {sorted(unknown)}")
    out = {n: ns[n] for n in names if n not in exclude}
    out.update({f: ns[f] for f in fixtures})
    return out


def bind(namespace: dict, tests: dict) -> None:
    """Add ``tests`` to a test module's globals, refusing to shadow."""
    clash = set(tests) & set(namespace)
    if clash:
        raise ValueError(f"names already bound: {sorted(clash)}")
    namespace.update(tests)
