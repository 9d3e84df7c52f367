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
from typing import Any

import torch

from repro_torch.core.tracing import (NULL_STEP, NULL_TRACE, StepTrace,
                                      profile_tracer, trace_now)

# whether a torch profiler records on this thread (one C call). A
# stopgap: the benchmark's serving harness passes no Tracer yet, so a
# batcher given none traces into the profile tracer while the harness's
# profiler records; it goes once the harness passes a Tracer
_profiled = torch.autograd._profiler_enabled


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
    rid: int = 0                     # submit order in this batcher
    ctx: Any = NULL_TRACE            # its RequestTrace, or NULL_TRACE
    t_submit: float = 0.0            # trace clock; read when traced


class ContinuousBatcher:
    """Slot-based continuous batching over one LM function's decode program.

    All active requests share ONE decode program and ONE arena (the
    batched cache slab, updated in place); new requests prefill into free
    slots while others keep decoding — runtime virtualization at the
    request level.

    Tracing (``core/tracing``): a request submitted with a sampled
    ``RequestTrace`` gets its phases (queue_wait, prefill, decode,
    prefill_stall) and token times; each step goes to the step track of
    ``tracer``, or, with no tracer, of the process's profile tracer
    while a torch profiler records on this thread (then a request
    submitted with no context is traced there too). With neither, every
    span site hands out the shared no-op span.
    """

    def __init__(self, runtime, fid: str, tracer=None):
        self.rt = runtime
        self.fid = fid
        self.func = runtime.registry.get(fid)
        self.spec = self.func.spec
        self.slots = self.spec.slots
        self.tracer = tracer
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
        self._ticks = 0          # step() calls: the step track's ids
        self._submitted = 0
        self._traced = 0         # traced requests pending or active

    def submit(self, prompt_tokens, max_new: int, ctx=NULL_TRACE) -> Future:
        fut: Future = Future()
        if not ctx.sampled and self.tracer is None and _profiled():
            ctx = profile_tracer().start_request(self.fid)
        t = trace_now() if ctx.sampled else 0.0
        with self._lock:
            self.pending.append(_Request(list(prompt_tokens), max_new, fut,
                                         rid=self._submitted, ctx=ctx,
                                         t_submit=t))
            self._submitted += 1
            self._traced += ctx.sampled
        return fut

    # ------------------------------------------------------------------
    def _step_trace(self):
        """The step's trace: to the tracer, the profile tracer while
        profiled, unpublished while traced requests are in flight, else
        the no-op one. ``_traced`` is read without the lock (one int): a
        traced request submitted from another thread after the read and
        admitted by this step misses this step's spans, which its track
        then counts as ``unattributed``."""
        tracer = self.tracer
        if tracer is None and _profiled():
            tracer = profile_tracer()
        # hydralint: disable=HL001 — one int read, a benign race (above)
        if tracer is None and not self._traced:
            return NULL_STEP
        return StepTrace(tracer, self._ticks)

    def _admit(self, st) -> list:
        """Admit into free slots; with a step trace, each admission's
        (request, start, end, first-token time)."""
        out, traced = [], st is not NULL_STEP
        while self.free and self.pending:
            with self._lock:
                req = self.pending.pop(0)
            slot = self.free.pop(0)
            req.slot = slot
            with st.child("admit") as adm:
                if traced:
                    adm.set(rid=req.rid, prompt=len(req.prompt))
                with st.child("bookkeeping"):
                    prompt = torch.as_tensor(
                        req.prompt, dtype=torch.int32,
                        device=self.rt.device).reshape(1, -1)
                    exe = self.rt._lm_prefill_exe(self.func, prompt.shape[1])
                # prefill.forward and prefill.insert are the program's
                tok, self.cache = exe(self.spec.params, self.cache, prompt,
                                      slot)
                with st.child("readback") as rb:
                    if traced:
                        rb.set(kind="first")
                    first = int(tok[0])
                with st.child("bookkeeping"):
                    req.emitted.append(first)
                    self.cur_tok[slot, 0] = first
                    self.active[slot] = req
            if traced:
                out.append((req, adm.t0, adm.t1, rb.t1))
        return out

    def step(self) -> int:
        """One scheduler tick: admit, then decode every slot (free slots
        included, as the reference does: their rows are ignored)."""
        st = self._step_trace()
        self._ticks += 1
        counted = st.tracer is not None
        if counted:
            built = self._built()
        with st, st.child("step") as sp:
            n = self._step(st)
            if counted:
                sp.set(programs_built=self._built() - built,
                       slots=len(self.active), spans=len(st.spans) + 1)
        return n

    def _built(self) -> int:
        ec = self.rt.exe_cache
        return ec.compiles + ec.disk_hits

    def _step(self, st) -> int:
        admitted, traced = self._admit(st), st is not NULL_STEP
        if not self.active:
            return 0
        with st.child("decode.forward") as fwd:
            tok, self.cache = self.func.entry["decode"](
                self.spec.params, self.cache, self.cur_tok)
            self.cur_tok = tok.reshape(self.slots, 1)
        self.steps += 1
        with st.child("readback") as rb:
            if traced:
                rb.set(kind="decode")
            toks = tok.tolist()
        with st.child("bookkeeping") as bk:
            done = []
            for slot, req in self.active.items():
                req.emitted.append(toks[slot])
                if len(req.emitted) >= req.max_new:
                    done.append(slot)
            finished = []
            for slot in done:
                req = self.active.pop(slot)
                self.free.append(slot)
                req.future.set_result(req.emitted)
                finished.append(req)
        if traced:
            self._track(admitted, fwd.t0, rb.t1, bk.t1, finished)
        return len(self.active) + len(done)

    # hydralint: disable=HL008 — prefill, decode and prefill_stall are
    # the port's own request phases: its PHASES (repro_torch core/tracing)
    # holds them, and tests/test_torch_lm_tracing.py checks these sites
    def _track(self, admitted: list, d0: float, t_token: float,
               t_end: float, finished: list) -> None:
        """Record this step on its traced requests' tracks: an admitted
        one's queue_wait, prefill and first token; for each request in
        flight, the later admissions as prefill_stall, the step's decode
        and its token."""
        for req in list(self.active.values()) + finished:
            ctx = req.ctx
            if not ctx.sampled:
                continue
            own = next((i for i, a in enumerate(admitted)
                        if a[0] is req), None)
            if own is not None:
                _, a0, a1, t_first = admitted[own]
                ctx.add_span("queue_wait", req.t_submit, a0)
                ctx.add_span("prefill", a0, a1, rid=req.rid)
                ctx.add_token(t_first)
            for _, a0, a1, _ in admitted[0 if own is None else own + 1:]:
                ctx.add_span("prefill_stall", a0, a1)
            ctx.add_span("decode", d0, t_end)
            ctx.add_token(t_token)
        for req in finished:
            if req.ctx.sampled:
                req.ctx.finish()
                with self._lock:
                    self._traced -= 1

    def run_until_done(self, max_steps: int = 10_000):
        while (self.active or self.pending) and max_steps > 0:
            self.step()
            max_steps -= 1

    def close(self):
        self.arena.buffers = self.cache
        self.rt.arena_pool.release(self.arena)
