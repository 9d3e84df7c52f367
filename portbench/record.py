"""What a driver hands back from one run, for the readers and the result
line, and what a driver is given."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Context:
    """One run's inputs: the cell, its parts and the run's arguments."""
    registry: object
    cfg: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object               # torch.device
    t_start: float               # perf_counter at the process's start


@dataclass
class Record:
    """One run's record. Times are ``time.perf_counter`` seconds.

    ``steps``: one dict per scheduler step of the window (``t0``, ``t1``,
    ``admitted`` prompt lengths, ``prefill_tokens``, ``gen`` tokens made,
    ``ctx`` the keys each decoded token saw). ``requests``: the requests,
    with ``send``, ``admitted``, ``done``, ``prompt``, ``n_out``.
    ``spans``: (start, end, label) host spans for the idle breakdown.
    ``checks``: {name: {"value", "limit"}} of the compared numbers."""
    cfg: dict
    mix: dict
    registry: object
    setup_s: float = 0.0
    setup_parts: dict = field(default_factory=dict)
    t0: float = 0.0
    t1: float = 0.0
    steps: list = field(default_factory=list)
    requests: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    kernels: list = field(default_factory=list)
    peak_mem_bytes: int = 0
    attempted: int = 0
    failed: int = 0
    checks: dict = field(default_factory=dict)
    extra: dict = field(default_factory=dict)   # what the check compared
    check_s: float = 0.0                         # the check's own seconds
    host: dict = field(default_factory=dict)     # the host over the window

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def window_steps(self) -> list:
        return [s for s in self.steps if self.t0 <= s["t0"] and
                s["t1"] <= self.t1]
