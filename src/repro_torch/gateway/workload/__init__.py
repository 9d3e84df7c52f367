"""Trace → live functions: materialize a ``Trace``'s integer fids as
real registered functions on a runtime/platform/cluster (the port of
``repro.gateway.workload``; its weights are tensors on the target's
device, its payloads host numpy, as the reference's).

The simulator replays abstract invocations; the live gateway needs each
trace function to exist on the real stack — registered, AOT-compiled,
placeable, snapshotable. Every trace fid becomes a tiny ``CallableSpec``
(one affine program, identical shapes for all functions, so the
whole workload shares ONE built program through the fleet
``ExecutableCache`` — code-cache sharing exactly as the paper's
same-language tenants do) with per-function weights and a per-function
arena sized from the trace's memory column.

Trace memory is scaled by ``mem_scale`` (default 1/64) so a dataset
whose functions average ~140 MB replays on CI hardware: a 128 MB trace
function becomes a 2 MB arena. Scale the runtime/node budgets by the
same factor to preserve the sim's packing ratios
(``scaled_runtime_budget`` does this) — the *shape* of placement,
pool churn, and cold starts is preserved while absolute bytes shrink.

The invocation's *duration* is emulated by the gateway worker (which
sleeps ``duration_s / compress`` after the real invoke), not here: a
device program cannot sleep, and the real code path — registry lookup,
arena acquire, program call — is exactly what we want measured.

This module is a package (``workload/__init__.py``) rather than
``workload.py`` so that the documentation's bare ``workload.py``
references keep resolving to one file (hydralint HL006).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core.registry import CallableSpec

MB = 1 << 20
VEC = 64                      # element count of the emulated program


def _affine(params, args):
    return {"y": args["x"] * params["w"] + params["b"]}


@dataclass
class TraceWorkload:
    """Registered live twins of a trace's functions.

    ``fid_name``/``tenant_name`` define the stable naming scheme
    (``fn00017`` / ``tenant0003``); ``register_all`` admits every
    function appearing in the trace (placement stays lazy — the first
    live invocation claims/packs a runtime, which is the cold-start
    path under measurement); ``args_for`` builds the invocation payload.
    """
    mem_scale: float = 1.0 / 64
    min_arena_bytes: int = 256 * 1024
    # cap so even the biggest trace function stays admissible on one
    # runtime (a function's placement estimate is ~2 arenas); None = no cap
    max_arena_bytes: Optional[int] = None
    registered: dict = field(default_factory=dict)   # fid -> (name, tenant)
    # the device the target runs on: weights and example args live there
    device: Optional[torch.device] = None

    @staticmethod
    def fid_name(fid: int) -> str:
        return f"fn{fid:05d}"

    @staticmethod
    def tenant_name(tenant: int) -> str:
        return f"tenant{tenant:04d}"

    def arena_bytes(self, mem_bytes: int) -> int:
        nb = max(self.min_arena_bytes, int(mem_bytes * self.mem_scale))
        if self.max_arena_bytes is not None:
            nb = min(nb, self.max_arena_bytes)
        return nb

    def spec_for(self, fid: int, mem_bytes: int) -> CallableSpec:
        # one program name + identical shapes for every function: the
        # program is built once and shared fleet-wide; weights differ per
        # function (they are arguments, not closed over)
        f32, dev = torch.float32, self.device
        w = torch.full((VEC,), 1.0 + (fid % 13) * 0.5, dtype=f32, device=dev)
        b = torch.full((VEC,), float(fid % 7), dtype=f32, device=dev)
        return CallableSpec(name="trace-emulated", fn=_affine,
                            example_args={"x": torch.ones((VEC,), dtype=f32,
                                                          device=dev)},
                            params={"w": w, "b": b},
                            arena_bytes=self.arena_bytes(mem_bytes))

    def register_all(self, trace, adapter) -> int:
        """Register every distinct function in ``trace`` on the adapted
        target. Returns the number of functions registered. A trace that
        publishes its workload directly (``StreamingTrace.functions()``)
        registers from that metadata without expanding one invocation."""
        fns = getattr(trace, "functions", None)
        if callable(fns):
            seen = {f.fid: (f.tenant, f.mem_bytes) for f in fns()}
        else:
            seen = {}
            for inv in trace:
                if inv.fid not in seen:
                    seen[inv.fid] = (inv.tenant, inv.mem_bytes)
        n = 0
        for fid, (tenant, mem_bytes) in sorted(seen.items()):
            name = self.fid_name(fid)
            tenant = self.tenant_name(tenant)
            adapter.register(name, self.spec_for(fid, mem_bytes),
                             tenant=tenant)
            self.registered[fid] = (name, tenant)
            n += 1
        return n

    def args_for(self, inv) -> dict:
        # host-side payload, like a real request body arriving over the
        # wire: the runtime's program moves it to the device on call
        # (core/runtime's arg_conformer), once per request
        return {"x": np.full((VEC,), float(inv.fid % 11), np.float32)}

    def name_for(self, inv):
        entry = self.registered.get(inv.fid)
        return entry[0] if entry else None


def scaled_runtime_budget(sim_runtime_cap: int,
                          mem_scale: float = 1.0 / 64,
                          floor_bytes: int = 4 * MB) -> int:
    """Map a simulator per-runtime cap onto a live runtime budget at the
    workload's memory scale, so live packing saturates at the same
    functions-per-runtime ratio the sim models."""
    return max(floor_bytes, int(sim_runtime_cap * mem_scale))
