"""Hydra runtime error types (paper §3.1/§3.7 semantics)."""


class HydraError(Exception):
    pass


class FunctionNotRegisteredError(HydraError):
    """Invocation of an unknown fid (paper Listing 1, line 24)."""


class HydraOOMError(HydraError):
    """A function over-allocated its memory budget (paper §3.7)."""


class AdmissionError(HydraError):
    """Runtime-level capacity exhausted; request must go to another worker."""
