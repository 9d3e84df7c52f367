"""Request scheduling: continuous batching for decode (the high-density
serving analog of the paper's many-isolates-per-runtime) and per-tenant
token buckets (the cgroup CPU-share analog, §3.7).

The module is a package (``core/scheduler/__init__.py``) rather than
``core/scheduler.py`` so that the documentation's bare ``core/scheduler.py``
references keep resolving to one file (hydralint HL006); the
module path mirrors ``repro.core.scheduler``.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import torch


class TokenBucket:
    """Per-tenant rate limiting (cgroup CPU-share analog)."""

    def __init__(self, rate: float, burst: float):
        self.rate = rate
        self.burst = burst
        self._tokens = burst
        self._t = time.monotonic()
        self._lock = threading.Lock()

    def try_take(self, n: float = 1.0) -> bool:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t) * self.rate)
            self._t = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False


@dataclass
class _Request:
    prompt: list
    max_new: int
    future: Future
    slot: int = -1
    emitted: list = field(default_factory=list)


class ContinuousBatcher:
    """Slot-based continuous batching over one LM function's decode program.

    All active requests share ONE decode program and ONE arena (the
    batched cache slab, updated in place); new requests prefill into free
    slots while others keep decoding — runtime virtualization at the
    request level.
    """

    def __init__(self, runtime, fid: str):
        self.rt = runtime
        self.fid = fid
        self.func = runtime.registry.get(fid)
        self.spec = self.func.spec
        self.slots = self.spec.slots
        self.pending: list[_Request] = []
        self.active: dict[int, _Request] = {}
        self.free = list(range(self.slots))
        self._lock = threading.Lock()
        self.arena = runtime.arena_pool.acquire(
            self.func.arena_sig, self.func.arena_factory)
        self.cache = self.arena.buffers
        self.cur_tok = torch.zeros((self.slots, 1), dtype=torch.int32,
                                   device=runtime.device)
        self.steps = 0

    def submit(self, prompt_tokens, max_new: int) -> Future:
        fut: Future = Future()
        with self._lock:
            self.pending.append(_Request(list(prompt_tokens), max_new, fut))
        return fut

    # ------------------------------------------------------------------
    def _admit(self):
        while self.free and self.pending:
            with self._lock:
                req = self.pending.pop(0)
            slot = self.free.pop(0)
            req.slot = slot
            prompt = torch.as_tensor(req.prompt, dtype=torch.int32,
                                     device=self.rt.device).reshape(1, -1)
            exe = self.rt._lm_prefill_exe(self.func, prompt.shape[1])
            tok, self.cache = exe(self.spec.params, self.cache, prompt, slot)
            first = int(tok[0])
            req.emitted.append(first)
            self.cur_tok[slot, 0] = first
            self.active[slot] = req

    def step(self) -> int:
        """One scheduler tick: admit, then decode every slot (free slots
        included, as the reference does: their rows are ignored)."""
        self._admit()
        if not self.active:
            return 0
        tok, self.cache = self.func.entry["decode"](
            self.spec.params, self.cache, self.cur_tok)
        self.cur_tok = tok.reshape(self.slots, 1)
        self.steps += 1
        toks = tok.tolist()
        done = []
        for slot, req in self.active.items():
            req.emitted.append(toks[slot])
            if len(req.emitted) >= req.max_new:
                done.append(slot)
        for slot in done:
            req = self.active.pop(slot)
            self.free.append(slot)
            req.future.set_result(req.emitted)
        return len(self.active) + len(done)

    def run_until_done(self, max_steps: int = 10_000):
        while (self.active or self.pending) and max_steps > 0:
            self.step()
            max_steps -= 1

    def close(self):
        self.arena.buffers = self.cache
        self.rt.arena_pool.release(self.arena)
