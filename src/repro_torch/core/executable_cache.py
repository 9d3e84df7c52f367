"""ExecutableCache: program build + code-cache sharing (paper §3.3/§3.4).

Programs are built ONCE per *program signature* — (architecture family,
entrypoint, abstract shapes, dtype) — with weights passed as arguments,
never closed over. Every tenant whose function shares a signature
therefore shares a single program.

PyTorch runs eagerly, so a "compile" here builds the entry's callable once
per key (the kernels it reaches are built once per process by
``kernels/_build.py``). The counters keep the reference's contract:
``entries``, ``hits``, ``compiles`` and ``disk_hits``, with
``shared=False`` keying each entry per fid.

**Persisted entries** (``persist_dir``). The reference deserializes an XLA
executable from disk. The port has no XLA: its costly compiled artifacts
are the nvcc-built kernel libraries, whose file names carry a hash of
their sources and flags. So every entry built with ``persist_dir`` set
writes a small record, atomically, at ``exe_<sha256(repr(key))[:16]>
.json``: the key's ``repr`` and the kernel libraries this process had
loaded. A later process that finds a record for the same key, all of
whose libraries are still on disk, counts a ``disk_hits`` instead of a
``compiles``. What such a disk hit saves in the port is the nvcc build of
those libraries and nothing else: the entry's callable is rebuilt in
microseconds either way. A record that is missing, stale (another key)
or unreadable counts a compile and is rewritten. The reference's second
layer, jax's persistent compilation cache (``xla_cache_dir``), has no
counterpart, so ``xla_cache_enabled`` stays False.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from repro_torch.kernels import _build


@dataclass
class CacheEntry:
    key: tuple
    compiled: Any
    compile_s: float
    hits: int = 0


class ExecutableCache:
    def __init__(self, persist_dir: Optional[str] = None,
                 shared: bool = True,
                 xla_cache_dir: Optional[str] = None):
        """``shared=False`` emulates the per-context-JIT baseline (every
        registration builds its own copy) for the Fig 4 experiment.
        ``persist_dir``: keep a record per entry there (module doc)."""
        if xla_cache_dir is not None:
            raise NotImplementedError(
                "xla_cache_dir has no counterpart in repro_torch (no XLA)")
        self._entries: dict[tuple, CacheEntry] = {}
        self._lock = threading.Lock()
        self.persist_dir = persist_dir
        self.shared = shared
        self.total_compile_s = 0.0
        self.compiles = 0        # programs built with no usable record
        self.disk_hits = 0       # programs whose persisted record held
        if persist_dir:
            os.makedirs(persist_dir, exist_ok=True)

    # ------------------------------------------------------------------
    def _disk_path(self, key: tuple) -> Optional[str]:
        if not self.persist_dir:
            return None
        # stable across processes (builtin hash() is salted per process)
        h = hashlib.sha256(repr(key).encode()).hexdigest()[:16]
        return os.path.join(self.persist_dir, f"exe_{h}.json")

    @staticmethod
    def _record_holds(path: str, key: tuple) -> bool:
        """True when ``path`` is a record of ``key`` whose kernel libraries
        are all on disk, so that serving it runs no nvcc."""
        try:
            with open(path) as f:
                rec = json.load(f)
            return (rec["key"] == repr(key)
                    and all((_build.BUILD_DIR / lib).is_file()
                            for lib in rec["kernel_libs"]))
        except (OSError, ValueError, KeyError, TypeError):
            return False

    @staticmethod
    def _write_record(path: str, key: tuple) -> None:
        rec = {"key": repr(key), "kernel_libs": _build.loaded_libraries()}
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, path)                    # atomic: readers see old
                                                 # or new, never a torn file

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
        path = self._disk_path(key)
        from_disk = path is not None and self._record_holds(path, key)
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
            if from_disk:
                self.disk_hits += 1
            else:
                self.compiles += 1
        if path is not None and not from_disk:
            self._write_record(path, key)
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
