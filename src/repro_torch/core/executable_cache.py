"""ExecutableCache: program build + code-cache sharing (paper §3.3/§3.4).

Programs are built ONCE per *program signature* — (architecture family,
entrypoint, abstract shapes, dtype) — with weights passed as arguments,
never closed over. Every tenant whose function shares a signature
therefore shares a single program.

PyTorch runs eagerly, so a "compile" here builds the entry's callable once
per key (the kernels it reaches are built once per process by
``kernels/_build.py``). The counters keep the reference's contract:
``entries``, ``hits`` and ``compiles``, with ``shared=False`` keying each
entry per fid. Persisting programs to disk (``persist_dir``) and the XLA
compile cache (``xla_cache_dir``) are not ported.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


@dataclass
class CacheEntry:
    key: tuple
    compiled: Any
    compile_s: float
    hits: int = 0
    created_at: float = field(default_factory=time.monotonic)


class ExecutableCache:
    def __init__(self, persist_dir: Optional[str] = None,
                 shared: bool = True,
                 xla_cache_dir: Optional[str] = None):
        """``shared=False`` emulates the per-context-JIT baseline (every
        registration builds its own copy) for the Fig 4 experiment."""
        if persist_dir is not None or xla_cache_dir is not None:
            raise NotImplementedError(
                "persist_dir/xla_cache_dir are not ported to repro_torch yet")
        self._entries: dict[tuple, CacheEntry] = {}
        self._lock = threading.Lock()
        self.shared = shared
        self.total_compile_s = 0.0
        self.compiles = 0        # programs built
        self.disk_hits = 0       # always 0: nothing is persisted yet

    def get_or_compile(self, key: tuple, build_fn: Callable[[], Any],
                       *, fid: Optional[str] = None) -> CacheEntry:
        """``build_fn()`` returns the entry's callable."""
        if not self.shared and fid is not None:
            key = key + ("fid", fid)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                entry.hits += 1
                return entry

        t0 = time.perf_counter()
        compiled = build_fn()
        compile_s = time.perf_counter() - t0

        entry = CacheEntry(key=key, compiled=compiled, compile_s=compile_s)
        with self._lock:
            # racing registration of the same signature: first one wins
            existing = self._entries.get(key)
            if existing is not None:
                existing.hits += 1
                return existing
            self._entries[key] = entry
            self.total_compile_s += compile_s
            self.compiles += 1
        return entry

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "hits": sum(e.hits for e in self._entries.values()),
                "compiles": self.compiles,
                "disk_hits": self.disk_hits,
                "total_compile_s": self.total_compile_s,
                "xla_cache_enabled": False,
            }
