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

from repro_torch.core.arena import tree_leaves
from repro_torch.core.runtime import pinned_device
from repro_torch.core.tracing import (NULL_STEP, NULL_TRACE, StepTrace,
                                      profile_tracer, trace_now)
from repro_torch.kernels import ops as kernel_ops

# whether a torch profiler records on this thread (one C call). A
# stopgap: the benchmark's serving harness passes no Tracer yet, so a
# batcher given none traces into the profile tracer while the harness's
# profiler records; it goes once the harness passes a Tracer
_profiled = torch.autograd._profiler_enabled

# per device, the side stream its decode steps are captured on and the
# anchor of the memory pool their graphs share, one each for every batcher
# there: cuBLAS makes its workspace for the stream once a device, and the
# graphs' temporaries take one pool's room, not one pool a batcher. Sharing
# the pool is safe as the graphs never run at once (they replay on the
# stepping thread's stream) and a step reads its tokens from ``cur_tok``,
# outside the pool.
_capture_sides: dict = {}


def _graphs_on(device: torch.device) -> bool:
    """Whether a batcher on ``device`` replays its decode step as a CUDA
    graph: where the runtime runs on CUDA."""
    return device.type == "cuda"


def _capture_side(device: torch.device) -> tuple:
    """(capture stream, anchor graph) of ``device``; the decode graphs
    capture into the anchor's pool. The device and host allocators retire
    a pool that no graph holds, and a retired pool takes no capture, so
    the anchor, a one-node graph never replayed, holds it for the process
    (a ``torch.cuda.MemPool`` holds the device allocator's side only)."""
    device = pinned_device(device)       # "cuda" and "cuda:0" are one card
    side = _capture_sides.get(device)
    if side is None:
        stream, anchor = torch.cuda.Stream(device), torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            anchor.capture_begin(torch.cuda.graph_pool_handle(),
                                 capture_error_mode="thread_local")
            try:
                torch.zeros((), device=device)  # an empty graph warns
            finally:
                anchor.capture_end()
        side = _capture_sides[device] = (stream, anchor)
    return side


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

    Decode graph: on CUDA the decode step, whose shapes never change,
    is captured once into a ``torch.cuda.CUDAGraph`` and replayed on
    every later step (one launch in place of one per kernel). The first
    decode runs eagerly (it loads the kernels and cuBLAS); the second is
    captured, which runs nothing, then replayed once to run; the rest
    replay. The graph reads the params, the slab's leaves and
    ``cur_tok`` at the addresses they had at capture, and its last node
    copies the sampled tokens into ``cur_tok``, so the step is keyed on
    those addresses: when one moves (a slab or a tenant's weights
    replaced) the graph is dropped and the next step captures again.
    The runtime's ``decode_graph.captures`` and ``decode_graph.replays``
    count them, and a traced step's ``decode.forward`` carries ``graph``
    (eager, capture or replay). A replayed step records no span below
    ``decode.forward``; the kernel wrappers' ``launches`` go up on each
    replay by what the capture counted, and not for the capture.
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
        self._graphs = _graphs_on(runtime.device)
        self._graph = None       # (addresses, CUDAGraph, launches)
        self._decoded = False    # a decode has run eagerly
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
            tok, how = self._decode()
            if traced:
                fwd.set(graph=how)
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

    def _decode_eager(self) -> torch.Tensor:
        """Decode every slot; the sampled tokens, (slots,), are also
        copied into ``cur_tok``, where the next step reads them."""
        tok, self.cache = self.func.entry["decode"](
            self.spec.params, self.cache, self.cur_tok)
        self.cur_tok.copy_(tok.reshape(self.slots, 1))
        return tok

    def _decode(self) -> tuple:
        """(sampled tokens, how: eager, capture or replay); the class
        docstring gives the order."""
        if not self._graphs:
            return self._decode_eager(), "eager"
        key = tuple(x.data_ptr() for x in tree_leaves(
            (self.spec.params, self.cache, self.cur_tok)))
        if self._graph is not None and self._graph[0] != key:
            self._graph = None
        how = "replay"
        if self._graph is None:
            if not self._decoded:
                self._decoded = True
                return self._decode_eager(), "eager"
            self._graph = (key, *self._capture())
            # hydralint: disable=HL004 — a port-only counter: the sim
            # models no launch cost inside a step
            self.rt.metrics.inc("decode_graph.captures")
            how = "capture"
        _, graph, launched = self._graph
        graph.replay()
        kernel_ops.add_launches(launched)
        # hydralint: disable=HL004 — a port-only counter (above)
        self.rt.metrics.inc("decode_graph.replays")
        return self.cur_tok.view(-1), how

    def _capture(self) -> tuple:
        """Capture the decode step: (the graph, the kernel launches it
        makes, by wrapper). The capture runs nothing, so it counts no
        launch (a launch another thread makes meanwhile is counted with
        the step's). Not ``torch.cuda.graph``: that empties the
        allocator's cache at every capture, under every other tenant on
        the card."""
        stream, anchor = _capture_side(self.rt.device)
        graph = torch.cuda.CUDAGraph()
        before = kernel_ops.launch_counts()
        torch.cuda.synchronize(self.rt.device)  # as torch.cuda.graph does
        with torch.cuda.stream(stream):
            # thread_local: the runtime's worker and janitor threads may
            # use the card while this thread captures
            graph.capture_begin(anchor.pool(),
                                capture_error_mode="thread_local")
            try:
                self._decode_eager()
            finally:
                graph.capture_end()
        launched = {k: n - before[k]
                    for k, n in kernel_ops.launch_counts().items()}
        kernel_ops.add_launches({k: -n for k, n in launched.items()})
        return graph, launched

    def run_until_done(self, max_steps: int = 10_000):
        while (self.active or self.pending) and max_steps > 0:
            self.step()
            max_steps -= 1

    def close(self):
        self._graph = None       # before the slab it reads goes back
        self.arena.buffers = self.cache
        self.rt.arena_pool.release(self.arena)
