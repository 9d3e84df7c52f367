"""Function registry: the paper's register/deregister surface (§3.1).

Two function kinds:
  * CallableSpec — an arbitrary PyTorch function ``(params, args) ->
    result`` over tensors (the analog of the paper's benchmark functions).
  * LMSpec — a model-serving function: an architecture served through
    prefill/decode programs.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core.errors import FunctionNotRegisteredError

MB = 1 << 20
DEFAULT_ARENA_BYTES = 1 * MB   # paper: 1 MB pre-allocated isolate heap


@dataclass(frozen=True)
class CallableSpec:
    name: str                       # program identity (shared across fids)
    fn: Callable                    # (params, args) -> result
    example_args: Any               # tree of tensors (defines shapes)
    params: Any = None
    arena_bytes: int = DEFAULT_ARENA_BYTES


@dataclass(frozen=True)
class LMSpec:
    cfg: ArchConfig
    params: Any                     # device weights (bf16 for serving)
    max_seq: int = 2048             # decode cache slots per request
    slots: int = 1                  # batched decode slots (continuous batching)

    @property
    def family_key(self) -> tuple:
        """Signature shared by every tenant serving this architecture —
        weights are arguments, so programs are shared (code-cache sharing
        across tenants)."""
        return ("lm", dataclasses.replace(self.cfg, name=""),
                self.max_seq, self.slots)


@dataclass
class Function:
    fid: str
    tenant: str
    spec: Any
    mem_budget: int
    entry: dict = field(default_factory=dict)   # name -> program callable
    arena_sig: tuple = ()
    arena_factory: Optional[Callable] = None
    registered_at: float = field(default_factory=time.monotonic)
    invocations: int = 0


class FunctionRegistry:
    def __init__(self):
        self._funcs: dict[str, Function] = {}
        self._lock = threading.Lock()

    def add(self, func: Function) -> bool:
        with self._lock:
            if func.fid in self._funcs:
                return False
            self._funcs[func.fid] = func
            return True

    def get(self, fid: str) -> Function:
        with self._lock:
            func = self._funcs.get(fid)
        if func is None:
            raise FunctionNotRegisteredError(fid)
        return func

    def remove(self, fid: str) -> bool:
        with self._lock:
            return self._funcs.pop(fid, None) is not None

    def list(self) -> list:
        with self._lock:
            return list(self._funcs)

    def __len__(self) -> int:
        with self._lock:
            return len(self._funcs)
