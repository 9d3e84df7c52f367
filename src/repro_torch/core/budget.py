"""Byte-accurate memory budgets (paper §3.1 registration budget + §3.7
scaling/OOM semantics)."""
from __future__ import annotations

import threading

from repro_torch.core.errors import AdmissionError, HydraOOMError


class MemoryBudget:
    """Thread-safe byte accounting with a hard capacity.

    ``reserve`` raises — the paper's behaviour is an explicit OOM error when
    a function over-allocates, and admission failure when the runtime is
    saturated (a real deployment spills to another worker node).
    """

    def __init__(self, capacity_bytes: int, *, name: str = "runtime"):
        self.capacity = int(capacity_bytes)
        self.name = name
        self._used = 0
        self._peak = 0
        self._lock = threading.Lock()

    @property
    def used(self) -> int:
        with self._lock:                   # HL001: paired with reserve()
            return self._used

    @property
    def peak(self) -> int:
        with self._lock:
            return self._peak

    @property
    def free(self) -> int:
        with self._lock:
            return self.capacity - self._used

    def reserve(self, nbytes: int, *, admission: bool = False) -> None:
        nbytes = int(nbytes)
        with self._lock:
            if self._used + nbytes > self.capacity:
                err = AdmissionError if admission else HydraOOMError
                raise err(
                    f"{self.name}: reserve {nbytes} exceeds capacity "
                    f"{self.capacity} (used {self._used})")
            self._used += nbytes
            self._peak = max(self._peak, self._used)

    def release(self, nbytes: int) -> None:
        with self._lock:
            self._used = max(0, self._used - int(nbytes))

    def try_reserve(self, nbytes: int) -> bool:
        try:
            self.reserve(nbytes, admission=True)
            return True
        except AdmissionError:
            return False
