"""Failure injection, straggler detection, elastic re-placement: a port of
``repro/ft/failures.py``.

On a real pod these hook the runtime's heartbeat bus; on one card they
drive the SAME recovery code paths (restore + re-place + resume) so the
logic is exercised end-to-end in tests and examples. ``InjectedFailure``,
``FailureInjector``, ``HeartbeatMonitor`` and ``StepGuard`` are pure
Python copies; ``elastic_remesh`` is the one-device form (see there).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch


class InjectedFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Deterministic or probabilistic step failures (node-loss simulation)."""
    fail_at_steps: tuple = ()
    fail_prob: float = 0.0
    seed: int = 0
    _fired: set = field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise InjectedFailure(f"injected node failure at step {step}")
        if self.fail_prob > 0:
            rng = np.random.default_rng((self.seed, step))
            if rng.random() < self.fail_prob and step not in self._fired:
                self._fired.add(step)
                raise InjectedFailure(f"random node failure at step {step}")


class HeartbeatMonitor:
    """Deadline-based straggler/failure detection.

    Workers call ``beat(worker_id)`` each step; ``stragglers(deadline_s)``
    returns workers silent for longer than the deadline. The trainer uses
    this to trigger checkpoint-restore-reshard (elastic) instead of hanging
    on a dead collective.
    """

    def __init__(self):
        self._last: dict = {}
        self._lock = threading.Lock()

    def beat(self, worker_id: str):
        with self._lock:
            self._last[worker_id] = time.monotonic()

    def stragglers(self, deadline_s: float) -> list:
        now = time.monotonic()
        with self._lock:
            return [w for w, t in self._last.items() if now - t > deadline_s]

    def workers(self) -> list:
        with self._lock:
            return list(self._last)


def elastic_remesh(tree, device):
    """Re-place a tree of host arrays (or tensors) onto ``device``.

    Used after restore when the device changed: checkpoint leaves are host
    arrays; this copies each onto the device. The reference scatters them
    onto the shardings of a new mesh; the port has one device and no mesh
    or sharding yet, so this is that call's one-device counterpart and
    takes a device in place of shardings.
    """
    dev = torch.device(device)
    if isinstance(tree, dict):
        return {k: elastic_remesh(v, dev) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    return torch.from_numpy(np.array(tree)).to(dev)


@dataclass
class StepGuard:
    """Wraps the train loop body with failure detection + bounded retry."""
    monitor: HeartbeatMonitor
    injector: FailureInjector
    max_retries: int = 2

    def run(self, step: int, fn, *args, **kwargs):
        attempts = 0
        while True:
            try:
                self.injector.check(step)
                out = fn(*args, **kwargs)
                self.monitor.beat("worker0")
                return out
            except InjectedFailure:
                attempts += 1
                if attempts > self.max_retries:
                    raise
                # the caller restores from checkpoint on re-raise; here we
                # model a fast in-place retry (straggler mitigation)
                continue
