"""Finds the benchmark's parts by name, so that a later cell, configuration,
mix or metric is added as files and ``BENCHMARK.json`` entries alone:

  configs/<config>.json     a model configuration as it is run
  traffic/<mix>.json        a mix's parameters, read by ``generator``
  limits/<workload>.json    each compared number's limit, and its readings
  metrics/<metric>.py       ``read(run)``: one metric from a run's record
  counts/<name>.py          frozen operation and byte counts
  drivers/<kind>.py         ``run(ctx)``: set-up, window and check of a kind

and, for each model family (a configuration's ``family``):

  reference/<family>.py           the plain float32 reference model
                                  (``logits``) and its weights' layout
                                  (``shapes``), which ``weights`` makes
  counts/model_flops.<family>.py  the family's model flops a token
                                  (``prefill``, ``decode``)

so a configuration of a new family joins as files of its own too.

Each is looked up in the search roots in order (the package's own folder
last), so a test can add parts from a directory of its own.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Registry:
    def __init__(self, roots=(), benchmark: Path | dict | None = None):
        self.roots = [Path(r) for r in roots] + [HERE]
        if benchmark is None:
            benchmark = ROOT / "BENCHMARK.json"
        self.spec = benchmark if isinstance(benchmark, dict) \
            else json.loads(Path(benchmark).read_text())
        self._mods: dict = {}

    def path(self, kind: str, name: str, ext: str) -> Path:
        if not name or "/" in name or name.startswith("."):
            raise ValueError(f"{kind} name {name!r}")
        for root in self.roots:
            p = root / kind / f"{name}{ext}"
            if p.is_file():
                return p
        raise FileNotFoundError(f"no {kind}/{name}{ext} under "
                                f"{[str(r) for r in self.roots]}")

    def data(self, kind: str, name: str) -> dict:
        return json.loads(self.path(kind, name, ".json").read_text())

    def module(self, kind: str, name: str):
        """``<kind>/<name>.py``: the package's module where it is one,
        else loaded from its file (a metric's name may hold dots, which an
        import name may not)."""
        p = self.path(kind, name, ".py")
        key = str(p)
        if key not in self._mods and p.parent.parent == HERE and \
                name.isidentifier():
            self._mods[key] = importlib.import_module(
                f"portbench.{kind}.{name}")
        if key not in self._mods:
            mod_name = f"portbench_{kind}_{len(self._mods)}"
            spec = importlib.util.spec_from_file_location(mod_name, p)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[mod_name] = mod
            spec.loader.exec_module(mod)
            self._mods[key] = mod
        return self._mods[key]

    # ------------------------------------------------------------------
    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self.data("configs", name)

    def mix(self, name: str) -> dict:
        return self.data("traffic", name)

    def limits(self, workload: str) -> dict:
        return self.data("limits", workload)

    def metrics(self, workload: str, trace: bool) -> list:
        """The metric entries a run of ``workload`` reports: its end-to-end
        metrics, or with ``trace`` its per-layer ones."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.spec[key]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str):
        return self.module("metrics", metric).read

    def count(self, name: str):
        return self.module("counts", name)

    def reference(self, cfg: dict):
        """``reference/<family>.py`` of the configuration's family."""
        return self.module("reference", cfg["family"])

    def model_flops(self, cfg: dict):
        """``counts/model_flops.<family>.py`` of the configuration's
        family; a family without one has no model flops to read."""
        return self.count(f"model_flops.{cfg['family']}")
