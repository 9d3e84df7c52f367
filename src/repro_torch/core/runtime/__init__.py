"""HydraRuntime: one virtualized runtime hosting many functions (paper §3).

The request path mirrors the paper's Listing 1:
  invoke -> registry lookup -> arena (isolate) acquire from pool ->
  program execution -> arena release.

Registration (paper §3.1/§3.4) takes the weights and builds every
entrypoint through the shared ExecutableCache, so no program is built on
the request path. Programs update their arena slab in place (the
reference donates it), and the slab goes back to the pool afterwards.

The runtime runs on CUDA unless it is given ``device="cpu"``; with no GPU
and no explicit device it raises.

The module is a package (``core/runtime/__init__.py``) rather than
``core/runtime.py`` so that the documentation's bare ``core/runtime.py``
references keep resolving to one file (hydralint HL006); the
module path mirrors ``repro.core.runtime``.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Optional

import torch

from repro_torch.core.arena import ArenaPool, tree_bytes, tree_leaves
from repro_torch.core.budget import MemoryBudget
from repro_torch.core.executable_cache import ExecutableCache
from repro_torch.core.metrics import Metrics
from repro_torch.core.registry import (CallableSpec, Function,
                                       FunctionRegistry, LMSpec)
from repro_torch.core.tracing import NULL_TRACE, trace_now
from repro_torch.device import resolve_device
from repro_torch.models.programs import ModelProgram

GB = 1 << 30


def registration_budget(spec, prog=None) -> tuple:
    """(registration reservation bytes, one-arena bytes) for a spec. Pass
    ``prog`` when an LMSpec's ModelProgram is already built."""
    if isinstance(spec, CallableSpec):
        reserve = (tree_bytes(spec.example_args) + tree_bytes(spec.params)
                   + spec.arena_bytes)
        return reserve, spec.arena_bytes
    if isinstance(spec, LMSpec):
        prog = prog or ModelProgram(spec.cfg)
        cache = prog.cache_bytes(spec.slots, spec.max_seq)
        return tree_bytes(spec.params) + cache, cache
    raise TypeError(type(spec))


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    # torch.argmax returns the first index of the maximum, as jnp.argmax
    return torch.argmax(logits, dim=-1).to(torch.int32)


class HydraRuntime:
    def __init__(self, *,
                 device=None,
                 memory_budget_bytes: int = 2 * GB,  # paper: 2 GB per runtime
                 arena_ttl_s: float = 10.0,
                 n_workers: int = 4,
                 executable_cache: Optional[ExecutableCache] = None,
                 janitor: bool = True,
                 hist_max_samples: Optional[int] = None):
        self.device = resolve_device(device)
        self.metrics = Metrics(hist_max_samples=hist_max_samples)
        self.budget = MemoryBudget(memory_budget_bytes, name="hydra")
        self.registry = FunctionRegistry()
        self.exe_cache = executable_cache or ExecutableCache()
        self.arena_pool = ArenaPool(budget=self.budget, ttl_s=arena_ttl_s,
                                    metrics=self.metrics)
        self._queue: "queue.Queue" = queue.Queue()
        self._workers = [threading.Thread(target=self._worker_loop,
                                          daemon=True, name=f"hydra-w{i}")
                         for i in range(n_workers)]
        self._shutdown = threading.Event()
        for w in self._workers:
            w.start()
        self._janitor = None
        if janitor:
            self._janitor = threading.Thread(target=self._janitor_loop,
                                             daemon=True, name="hydra-janitor")
            self._janitor.start()

    # ------------------------------------------------------------------
    # Registration (paper §3.1)
    # ------------------------------------------------------------------
    def register_function(self, fid: str, spec, *, tenant: str = "default",
                          # hydralint: disable=HL002 — registration is the
                          # modeled fn_register_s cost (program build and
                          # slab factory install), not the steady-state
                          # request path
                          mem_budget: Optional[int] = None) -> bool:
        with self.metrics.timeit("register_s"):
            if isinstance(spec, CallableSpec):
                func = self._register_callable(fid, spec, tenant, mem_budget)
            elif isinstance(spec, LMSpec):
                func = self._register_lm(fid, spec, tenant, mem_budget)
            else:
                raise TypeError(type(spec))
        ok = self.registry.add(func)
        if not ok:
            self.budget.release(func.mem_budget)
        self.metrics.inc("registered", int(ok))
        return ok

    def _check_device(self, tree, what: str) -> None:
        for x in tree_leaves(tree):
            if isinstance(x, torch.Tensor) and x.device.type != self.device.type:
                raise ValueError(f"{what} on {x.device}, runtime on "
                                 f"{self.device}")

    def _register_callable(self, fid, spec: CallableSpec, tenant,
                           mem_budget) -> Function:
        self._check_device((spec.params, spec.example_args), "CallableSpec")
        budget = mem_budget or registration_budget(spec)[0]
        self.budget.reserve(budget)
        shapes_key = tuple(
            (tuple(x.shape), str(x.dtype))
            for x in tree_leaves((spec.params, spec.example_args)))
        key = ("callable", spec.name, shapes_key)
        raw = spec.fn

        def build():
            def invoke(params, args):
                with torch.no_grad():
                    return raw(params, args)
            return invoke

        entry = self.exe_cache.get_or_compile(key, build, fid=fid)
        nb = max(spec.arena_bytes, 8)
        dev = self.device
        # the factory mints a slab at most once per pooled arena (cold
        # path only); warm claims reuse pooled device memory
        factory = lambda: {"scratch": torch.zeros((nb // 4,),
                                                  dtype=torch.float32,
                                                  device=dev)}
        arena_sig = ("scratch", nb)
        self.arena_pool.register_signature(arena_sig, factory)
        return Function(fid=fid, tenant=tenant, spec=spec, mem_budget=budget,
                        entry={"invoke": entry.compiled},
                        arena_sig=arena_sig, arena_factory=factory)

    def _register_lm(self, fid, spec: LMSpec, tenant, mem_budget) -> Function:
        self._check_device(spec.params, "LMSpec params")
        prog = ModelProgram(spec.cfg)
        B, S = spec.slots, spec.max_seq
        cache_specs = prog.cache_specs(B, S)
        budget = mem_budget or registration_budget(spec, prog)[0]
        self.budget.reserve(budget)
        fkey = spec.family_key

        def build():
            # decode + greedy sample over all slots; the cache is updated
            # in place and handed back
            def decode_sample(params, cache, tokens):
                with torch.no_grad():
                    logits, cache = prog.decode_step(params, cache,
                                                     {"tokens": tokens})
                    return _greedy(logits), cache
            return decode_sample

        entry_dec = self.exe_cache.get_or_compile(fkey + ("decode",), build,
                                                  fid=fid)
        dev = self.device

        def factory():
            return {k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
                    for k, s in cache_specs.items()}

        self.arena_pool.register_signature(("lm",) + fkey, factory)
        func = Function(fid=fid, tenant=tenant, spec=spec, mem_budget=budget,
                        entry={"decode": entry_dec.compiled},
                        arena_sig=("lm",) + fkey, arena_factory=factory)
        func.prog = prog
        return func

    def _lm_prefill_exe(self, func: Function, prompt_len: int):
        """Exact-length prefill program, built + cached on first use of
        this prompt length (production would use length buckets)."""
        spec: LMSpec = func.spec
        prog: ModelProgram = func.prog
        key = spec.family_key + ("prefill", prompt_len)
        if prompt_len > spec.max_seq:
            raise ValueError(f"prompt of {prompt_len} tokens exceeds "
                             f"max_seq={spec.max_seq}")

        def build():
            def prefill_insert(params, arena_cache, tokens, slot: int):
                """prefill (1, prompt_len), then write the slot's whole
                row of every leaf of the arena cache slab in place, as the
                reference writes the source padded to the slab's shape:
                a leaf whose source row has the slot row's shape (an SSM
                conv window or state) is copied whole; one with a
                sequence axis (K/V, (L, S, Hkv, hd)) gets the prompt's
                rows and zeros up to max_seq; length = prompt_len."""
                with torch.no_grad():
                    logits, cache = prog.prefill(params, {"tokens": tokens})
                    for k, src in cache.items():
                        dst = arena_cache[k]
                        if k == "length":
                            dst[slot] = prompt_len
                            continue
                        row, src_row = dst[:, slot], src[:, 0]
                        if src_row.shape == row.shape:
                            row.copy_(src_row)
                        else:
                            row[:, :prompt_len] = src_row
                            row[:, prompt_len:] = 0
                    return _greedy(logits), arena_cache
            return prefill_insert

        return self.exe_cache.get_or_compile(key, build, fid=func.fid).compiled

    # ------------------------------------------------------------------
    # Invocation (paper Listing 1)
    # ------------------------------------------------------------------
    def invoke(self, fid: str, args: Any, ctx=None) -> Any:
        return self.invoke_async(fid, args, ctx).result()

    def invoke_async(self, fid: str, args: Any, ctx=None) -> Future:
        # the trace context rides the queue item: the worker thread that
        # dequeues it continues the same request's spans
        fut: Future = Future()
        self._queue.put(("invoke", fid, args, time.perf_counter(), fut, ctx))
        return fut

    def generate(self, fid: str, prompt_tokens, max_new_tokens: int = 16):
        fut: Future = Future()
        self._queue.put(("generate", fid, (prompt_tokens, max_new_tokens),
                         time.perf_counter(), fut, None))
        return fut.result()

    def deregister_function(self, fid: str) -> bool:
        try:
            func = self.registry.get(fid)
        except Exception:
            return False
        ok = self.registry.remove(fid)
        if ok:
            self.budget.release(func.mem_budget)
            self.metrics.inc("deregistered")
        return ok

    # ------------------------------------------------------------------
    def _worker_loop(self):
        while not self._shutdown.is_set():
            try:
                item = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            kind, fid, args, t_enq, fut, ctx = item
            if ctx is not None and ctx.sampled:
                ctx.add_span("dispatch", t_enq, trace_now())
            try:
                if kind == "invoke":
                    result = self._do_invoke(fid, args, ctx)
                else:
                    result = self._do_generate(fid, *args)
                self.metrics.observe("invoke_latency_s",
                                     time.perf_counter() - t_enq)
                fut.set_result(result)
            except Exception as e:  # surface to caller
                fut.set_exception(e)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _do_invoke(self, fid: str, args, ctx=None):
        ctx = ctx or NULL_TRACE
        func = self.registry.get(fid)
        func.invocations += 1
        arena = self.arena_pool.acquire(func.arena_sig, func.arena_factory,
                                        owner=fid, ctx=ctx)
        try:
            with ctx.span("compute"):
                result = func.entry["invoke"](func.spec.params, args)
                self._sync()
        finally:
            self.arena_pool.release(arena)
        return result

    def _do_generate(self, fid: str, prompt_tokens, max_new: int):
        func = self.registry.get(fid)
        func.invocations += 1
        spec: LMSpec = func.spec
        prompt = torch.as_tensor(prompt_tokens, dtype=torch.int32,
                                 device=self.device).reshape(1, -1)
        prefill_exe = self._lm_prefill_exe(func, prompt.shape[1])
        arena = self.arena_pool.acquire(func.arena_sig, func.arena_factory,
                                        owner=fid)
        try:
            tok, cache = prefill_exe(spec.params, arena.buffers, prompt, 0)
            toks = [int(tok[0])]
            tok = tok.reshape(1, 1).repeat(spec.slots, 1)
            for _ in range(max_new - 1):
                tok, cache = func.entry["decode"](spec.params, cache, tok)
                toks.append(int(tok[0]))
                tok = tok.reshape(spec.slots, 1)
            arena.buffers = cache   # updated in place; hand back the slab
        finally:
            self.arena_pool.release(arena)
        return toks

    def _janitor_loop(self):
        while not self._shutdown.is_set():
            time.sleep(min(1.0, self.arena_pool.ttl_s / 4))
            self.arena_pool.evict_idle()

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "functions": len(self.registry),
            "budget_used": self.budget.used,
            "budget_peak": self.budget.peak,
            "arena": self.arena_pool.stats(),
            "exe_cache": self.exe_cache.stats(),
            "metrics": self.metrics.snapshot(),
        }

    def shutdown(self):
        self._shutdown.set()
        for w in self._workers:
            w.join(timeout=2.0)
        if self._janitor:
            self._janitor.join(timeout=2.0)
        self.arena_pool.drain()
