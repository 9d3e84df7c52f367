"""Arenas: the memory-isolate analog (paper §3.2), slab-allocated.

An Arena is a pre-allocated, fixed-budget set of device buffers (KV-cache
slabs / scratch) that hosts ONE in-flight invocation. Arenas are pooled:
``acquire`` pops a warm arena in microseconds (the paper's <500 us
isolate start), ``release`` returns it, idle arenas are destroyed after a
TTL (paper default: 10 s) releasing memory back to the device allocator.

The pool is a *slab allocator*: device memory for a signature is minted at
most once per slab (``register_signature`` / ``prealloc`` pre-touch slabs
off the clock), and the warm claim path never copies host memory. Two
warm claim flavors exist:

- **donated reuse** (``arena.reuse``): the claimant owns the slab's
  previous contents (same ``owner``) — the slab is handed out as-is, zero
  work. Programs update the slab in place, so it already holds the
  owner's own state.
- **zeroed reuse** (``arena.zeroed``): the slab last belonged to a
  different owner; it is scrubbed where it lives with an in-place
  ``zero_()`` on each buffer's own storage. Nothing is compiled and
  nothing is copied from the host.

A reused slab is therefore indistinguishable from a freshly allocated one
for any owner other than its donor.

The module is a package (``core/arena/__init__.py``) rather than
``core/arena.py`` so that the documentation's bare ``core/arena.py``
references keep resolving to one file (hydralint HL006); the
module path mirrors ``repro.core.arena``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch.core.budget import MemoryBudget
from repro_torch.core.metrics import Metrics
from repro_torch.core.tracing import NULL_TRACE

DEFAULT_TTL_S = 10.0


def tree_leaves(tree) -> list:
    """Leaves of a tree of dicts/lists/tuples, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def _zero_tree(bufs) -> None:
    # in place, on the buffers' own device: no host staging, no new memory
    for x in tree_leaves(bufs):
        if isinstance(x, torch.Tensor):
            x.zero_()


@dataclass
class Arena:
    signature: tuple
    buffers: Any                       # tree of device tensors
    nbytes: int
    owner: Optional[str] = None        # fid of the last claimant
    last_used: float = field(default_factory=time.monotonic)
    uses: int = 0


class ArenaPool:
    """Signature-keyed slab pool with TTL eviction and watermark prealloc."""

    def __init__(self, budget: Optional[MemoryBudget] = None,
                 ttl_s: float = DEFAULT_TTL_S,
                 metrics: Optional[Metrics] = None):
        self.budget = budget
        self.ttl_s = ttl_s
        self.metrics = metrics or Metrics()
        self._free: dict[tuple, list[Arena]] = {}
        self._factories: dict[tuple, Callable[[], Any]] = {}
        self._lock = threading.Lock()
        self.live = 0

    # ------------------------------------------------------------------
    # Registration-time work (off the request path)
    # ------------------------------------------------------------------
    def register_signature(self, signature: tuple,
                           factory: Callable[[], Any]) -> None:
        """Install the slab factory for ``signature``. The scrub is an
        in-place fill, so unlike the reference nothing is compiled here."""
        with self._lock:
            self._factories.setdefault(signature, factory)

    def prealloc(self, signature: tuple, factory: Callable[[], Any],
                 n: int, owner: Optional[str] = None) -> None:
        """Pre-touch ``n`` slabs off the clock (paper: pre-allocated cached
        isolates). Pass ``owner`` to pre-assign the slabs (a factory-fresh
        slab is already zeroed, so the owner's first claim skips even the
        scrub)."""
        self.register_signature(signature, factory)
        arenas = [self.acquire(signature, factory, owner=owner)
                  for _ in range(n)]
        for arena in arenas:
            self.release(arena)

    # ------------------------------------------------------------------
    # Request path
    # ------------------------------------------------------------------
    def acquire(self, signature: tuple,
                factory: Optional[Callable[[], Any]] = None,
                owner: Optional[str] = None, ctx=None) -> Arena:
        ctx = ctx or NULL_TRACE
        with ctx.span("arena_acquire") as sp:
            with self._lock:
                arena = None
                free = self._free.get(signature)
                if free:
                    if owner is not None:
                        # prefer a slab this owner donated back: its contents
                        # are the owner's own, so no scrub is needed
                        for i in range(len(free) - 1, -1, -1):
                            if free[i].owner == owner:
                                arena = free.pop(i)
                                break
                    if arena is None:
                        arena = free.pop()
                if arena is not None:
                    arena.last_used = time.monotonic()
                    arena.uses += 1
                    donated = arena.owner == owner
            if arena is not None:
                self.metrics.inc("arena.warm")
                if donated:
                    sp.set(kind="reuse")
                    self.metrics.inc("arena.reuse")
                else:
                    _zero_tree(arena.buffers)
                    sp.set(kind="zeroed")
                    self.metrics.inc("arena.zeroed")
                arena.owner = owner
                return arena
            sp.set(kind="cold")
            return self._acquire_cold(signature, factory, owner)

    def _acquire_cold(self, signature: tuple,
                      factory: Optional[Callable[[], Any]],
                      owner: Optional[str] = None) -> Arena:
        if factory is None:
            with self._lock:
                factory = self._factories.get(signature)
        if factory is None:
            raise KeyError(f"no factory for arena signature {signature!r}")
        # cold path: allocate outside the lock (paper Fig 3: allocation
        # latency grows with concurrent isolates — keep it off the fast path)
        self.metrics.inc("arena.cold")
        with self.metrics.timeit("arena.alloc_s"):
            buffers = factory()
        nbytes = tree_bytes(buffers)
        if self.budget is not None:
            self.budget.reserve(nbytes)
        with self._lock:
            self.live += 1
        return Arena(signature=signature, buffers=buffers, nbytes=nbytes,
                     owner=owner, uses=1)

    def release(self, arena: Arena) -> None:
        arena.last_used = time.monotonic()
        with self._lock:
            self._free.setdefault(arena.signature, []).append(arena)

    # ------------------------------------------------------------------
    def evict_idle(self, now: Optional[float] = None) -> int:
        """Destroy arenas idle beyond the TTL; returns bytes released."""
        now = now if now is not None else time.monotonic()
        released = 0
        with self._lock:
            for sig, free in self._free.items():
                keep = []
                for a in free:
                    if now - a.last_used > self.ttl_s:
                        released += a.nbytes
                        self.live -= 1
                        self.metrics.inc("arena.evicted")
                    else:
                        keep.append(a)
                self._free[sig] = keep
        if released and self.budget is not None:
            self.budget.release(released)
        return released

    def drain(self) -> int:
        with self._lock:
            for a_list in self._free.values():
                for a in a_list:
                    if self.budget is not None:
                        self.budget.release(a.nbytes)
                    self.live -= 1
            n = sum(len(v) for v in self._free.values())
            self._free.clear()
        return n

    @property
    def idle_count(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._free.values())

    def stats(self) -> dict:
        return {"live": self.live, "idle": self.idle_count,
                **self.metrics.snapshot()["counters"]}
