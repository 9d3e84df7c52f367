"""Trace layer for the discrete-event simulator: one ``Trace`` interface,
two sources.

  * ``Trace.synthetic(...)`` — the Shahrad-calibrated generator the repo
    has always shipped (Zipf popularity, hyperexponential bursts,
    lognormal durations/memory). ``gen_trace`` remains the raw
    list-returning entry point for back-compat.
  * ``Trace.from_azure(...)`` — the Azure Functions 2019 dataset
    (Shahrad et al. '20): the ``invocations_per_function_md`` CSV
    (HashOwner/HashApp/HashFunction + per-minute counts) plus the
    optional ``function_durations_percentiles`` and
    ``app_memory_percentiles`` tables. Counts are expanded to arrival
    timestamps (seeded-uniform within each minute) and can be
    deterministically *thinned* to a target mean rps so CI-sized replays
    of the 1440-minute dataset stay fast.
  * ``Trace.stream_azure(...)`` — the same CSVs through
    ``repro_torch.core.streaming``: chunked ingestion, lazy per-minute
    expansion with bounded memory, top-K/stratified tenant selection,
    minute-range windowing, and tenant sharding. ``from_azure`` is this
    stream materialized, so the two agree invocation-for-invocation.

A ``Trace`` is a ``Sequence[Invocation]`` — everything that accepted the
old ``list`` of invocations (``simulate``, ``len``, indexing) accepts a
``Trace`` unchanged.

A copy of ``repro.core.traces`` with its imports rewritten; a package
(``core/traces/__init__.py``) rather than ``core/traces.py`` so that the
documentation's bare references keep resolving to one file (hydralint
HL006).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

MB = 1 << 20
GB = 1 << 30

# Shahrad-calibrated lognormal shapes, shared by the synthetic generator
# and the Azure loader's fallbacks for absent duration/memory tables
DUR_LOG_MEAN, DUR_SIGMA = math.log(0.35), 0.7
DUR_CLIP_S = (0.1, 3.0)
MEM_LOG_MEAN, MEM_SIGMA = math.log(140), 0.35
MEM_CLIP_MB = (64, 512)


@dataclass(frozen=True)
class Invocation:
    t: float
    fid: int
    tenant: int
    duration_s: float
    mem_bytes: int


def gen_trace(n_functions: int = 120, n_tenants: int = 40,
              duration_s: float = 1800.0, mean_rps: float = 3.0,
              seed: int = 0) -> list:
    """Synthetic Azure-like trace (Shahrad et al. statistics): many owners,
    most of them sparse — rare tenants idle past the keep-alive window, so
    per-tenant runtimes churn (the cold-start regime the platform's
    pre-warmed pool targets)."""
    rng = np.random.default_rng(seed)
    # Zipf popularity over functions; functions assigned to tenants
    pop = 1.0 / np.arange(1, n_functions + 1) ** 1.1
    pop /= pop.sum()
    tenant_of = rng.integers(0, n_tenants, n_functions)
    # per-function memory: lognormal centered ~140 MB, clipped [64, 512] MB
    fn_mem = np.clip(rng.lognormal(MEM_LOG_MEAN, MEM_SIGMA, n_functions),
                     *MEM_CLIP_MB) * MB
    out = []
    t = 0.0
    # heavy-tailed inter-arrival (Shahrad et al.: bursty traffic): a
    # hyperexponential mix of short within-burst gaps and long idle gaps,
    # with the same mean as a Poisson process at ``mean_rps``
    burst_frac, burst_scale = 0.7, 0.1
    idle_scale = (1.0 - burst_frac * burst_scale) / (1.0 - burst_frac)
    while t < duration_s:
        scale = burst_scale if rng.random() < burst_frac else idle_scale
        t += rng.exponential(scale / mean_rps)
        fid = int(rng.choice(n_functions, p=pop))
        dur = float(np.clip(rng.lognormal(DUR_LOG_MEAN, DUR_SIGMA),
                            *DUR_CLIP_S))
        out.append(Invocation(t=t, fid=fid, tenant=int(tenant_of[fid]),
                              duration_s=dur, mem_bytes=int(fn_mem[fid])))
    return out


# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Trace(Sequence):
    """An ordered sequence of :class:`Invocation` plus provenance."""
    invocations: tuple
    source: str = "synthetic"
    meta: dict = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.invocations)

    def __getitem__(self, i):
        got = self.invocations[i]
        if isinstance(i, slice):
            return Trace(invocations=got, source=self.source, meta=self.meta)
        return got

    def __iter__(self):
        return iter(self.invocations)

    @property
    def duration_s(self) -> float:
        return self.invocations[-1].t if self.invocations else 0.0

    @property
    def mean_rps(self) -> float:
        d = self.duration_s
        return len(self) / d if d > 0 else 0.0

    def describe(self) -> dict:
        fids = {i.fid for i in self.invocations}
        tenants = {i.tenant for i in self.invocations}
        # meta first: the realized duration/rate must win over any
        # same-named generator kwargs recorded as provenance
        return {**self.meta,
                "source": self.source, "invocations": len(self),
                "functions": len(fids), "tenants": len(tenants),
                "duration_s": self.duration_s, "mean_rps": self.mean_rps}

    # -- sources -----------------------------------------------------------
    @classmethod
    def synthetic(cls, **kw) -> "Trace":
        return cls(invocations=tuple(gen_trace(**kw)), source="synthetic",
                   meta={k: v for k, v in kw.items()})

    @classmethod
    def from_azure(cls, invocations_csv: str,
                   durations_csv: Optional[str] = None,
                   memory_csv: Optional[str] = None,
                   target_rps: Optional[float] = None,
                   max_minutes: Optional[int] = None,
                   seed: int = 0) -> "Trace":
        return load_azure_trace(invocations_csv, durations_csv=durations_csv,
                                memory_csv=memory_csv, target_rps=target_rps,
                                max_minutes=max_minutes, seed=seed)

    @classmethod
    def stream_azure(cls, invocations_csv: str, **kw):
        """A lazily-expanded :class:`repro_torch.core.streaming.StreamingTrace`
        over the same CSV schema as :meth:`from_azure`, plus the
        streaming-only knobs (``minute_range``, ``chunk_rows``,
        ``top_k``/``select``, ``n_shards``/``shard_index``). Same seed
        and window -> byte-identical invocations to ``from_azure``."""
        from repro_torch.core.streaming import StreamingTrace
        return StreamingTrace(invocations_csv, **kw)


# ---------------------------------------------------------------------------
# Azure Functions 2019 dataset loader
# ---------------------------------------------------------------------------
def discover_azure_tables(invocations_csv: str) -> dict:
    """Sibling-table convention: ``<stem>_durations.csv`` /
    ``<stem>_memory.csv`` next to the invocations CSV. Returns the
    keyword arguments (``durations_csv`` / ``memory_csv``) for the
    tables that exist, ready to splat into :func:`load_azure_trace`."""
    stem = invocations_csv[:-4] if invocations_csv.endswith(".csv") \
        else invocations_csv
    out = {}
    if os.path.exists(stem + "_durations.csv"):
        out["durations_csv"] = stem + "_durations.csv"
    if os.path.exists(stem + "_memory.csv"):
        out["memory_csv"] = stem + "_memory.csv"
    return out


def load_azure_trace(invocations_csv: str,
                     durations_csv: Optional[str] = None,
                     memory_csv: Optional[str] = None,
                     target_rps: Optional[float] = None,
                     max_minutes: Optional[int] = None,
                     seed: int = 0) -> Trace:
    """Load an Azure Functions 2019-format trace into a :class:`Trace`.

    ``invocations_csv`` must carry the dataset's schema — ``HashOwner``,
    ``HashApp``, ``HashFunction`` plus integer-named per-minute count
    columns (``"1".."1440"``). ``durations_csv`` refines durations:
    per-function inverse-CDF sampling over the ``percentile_Average_*``
    columns (falling back to the ``Average`` ms column). ``memory_csv``
    refines memory with the per-app ``AverageAllocatedMb`` mean (the
    ``_pct*`` columns are accepted but not sampled — every invocation of
    an app shares its mean allocation). Absent tables fall back to the
    synthetic generator's seeded lognormals, so the invocations CSV
    alone is a complete workload.

    ``target_rps`` deterministically thins the replay: each per-minute
    count is down-sampled with a seeded binomial at
    ``min(1, target_rps / actual_rps)``, preserving the arrival *shape*
    (bursts, diurnal pattern) at CI-friendly volume. Same seed, same
    inputs -> byte-identical trace.

    This materializes :class:`repro_torch.core.streaming.StreamingTrace` (the
    chunked lazy loader), so the two paths agree invocation-for-
    invocation by construction; an empty expansion (all counts zero, or
    thinned to nothing) raises ``ValueError`` like any other unusable
    input.
    """
    from repro_torch.core.streaming import StreamingTrace
    st = StreamingTrace(invocations_csv, durations_csv=durations_csv,
                        memory_csv=memory_csv, target_rps=target_rps,
                        max_minutes=max_minutes, seed=seed)
    return Trace(invocations=tuple(st), source="azure",
                 meta={"path": invocations_csv, "target_rps": target_rps,
                       "thinning_keep": st.keep,
                       "raw_invocations": st.raw_invocations,
                       "minutes": st.meta["minutes"], "seed": seed})


def _norm_ppf(u: float) -> float:
    """Acklam's rational approximation to the standard-normal inverse CDF
    (scipy-free; |err| < 1.2e-9 on (0, 1))."""
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    plow, phigh = 0.02425, 1 - 0.02425
    if u < plow:
        q = math.sqrt(-2 * math.log(u))
        return ((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4])
                 * q + c[5])
                / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1))
    if u > phigh:
        q = math.sqrt(-2 * math.log(1 - u))
        return -((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4])
                  * q + c[5])
                 / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1))
    q = u - 0.5
    r = q * q
    return ((((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4])
             * r + a[5]) * q
            / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4])
               * r + 1))
