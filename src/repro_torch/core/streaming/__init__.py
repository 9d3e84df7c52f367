"""Streaming, shardable Azure Functions trace pipeline.

``Trace.from_azure`` materializes every invocation up front — fine for
the thinned CI sample, impossible for a full dataset day (tens of
thousands of functions, millions of invocations). ``StreamingTrace``
replays the same CSV with bounded memory:

  * **Chunked/columnar ingestion** — the invocations CSV is read once in
    ``chunk_rows``-row chunks; each row is reduced to a compact columnar
    record (ids, memory, duration-sampler reference, and sparse
    per-minute counts as numpy arrays). Invocations are never stored —
    only the count cells that compress them.
  * **Lazy per-minute expansion** — iteration walks the minute labels in
    order, expands one minute's cells into arrival timestamps with
    vectorized draws (the clockwork ``azure_functions.py`` idiom:
    per-minute counts -> within-minute arrival times), sorts the bucket,
    yields it, and drops it. Peak resident invocations are bounded by
    the busiest minute, not the trace length (``peak_buffered``).
  * **Cell-keyed determinism** — every (function-row, minute) cell draws
    from its own ``SeedSequence((seed, row_key_crc, minute))`` stream,
    so the expansion is invariant to chunk size, minute windowing,
    tenant selection, and sharding: a windowed/sharded/top-K replay
    yields byte-identical invocations for the cells it keeps.
  * **Seeded thinning** — ``target_rps`` down-samples each cell with a
    seeded binomial at ``keep = target_rps / actual_rps`` (the in-memory
    loader's semantics), computed over the selected workload *before*
    sharding so shards of one workload agree on ``keep``.
  * **Top-K / stratified tenant selection** — ``top_k`` keeps the K
    busiest function rows (``select="top"``) or one row per
    popularity stratum (``select="stratified"``: head, torso, and tail
    all stay represented) for bounded-hardware replays of a full day.
  * **Tenant-partitioned sharding** — ``shard(n, i)`` returns a
    StreamingTrace filtered to tenants with ``tenant % n == i``; the n
    shards partition the workload exactly and each one only expands its
    own rows (sharded gateway replay workers each iterate their shard).

``Trace.from_azure`` delegates to this module (materializing the
stream), so the two loaders are byte-identical by construction — the
parity tests in ``tests/test_traces.py`` / ``tests/test_sim.py`` pin it.

A copy of ``repro.core.streaming`` with its imports rewritten; a package
(``core/streaming/__init__.py``) rather than ``core/streaming.py`` so that the
documentation's bare references keep resolving to one file (hydralint
HL006).
"""
from __future__ import annotations

import csv
import zlib
from typing import NamedTuple, Optional

import numpy as np

from repro_torch.core.traces import (DUR_CLIP_S, DUR_LOG_MEAN, DUR_SIGMA, MB,
                                     MEM_CLIP_MB, MEM_LOG_MEAN, MEM_SIGMA,
                                     Invocation)

_REQUIRED_INV_COLS = ("HashOwner", "HashApp", "HashFunction")
# domain tags keeping the per-cell, per-app, and per-stratum SeedSequence
# streams disjoint even when their other entropy words collide
_CELL_TAG = 0x1
_APP_MEM_TAG = 0x2
_STRATUM_TAG = 0x3

SELECT_MODES = ("top", "stratified")


class TraceFunction(NamedTuple):
    """One registrable function of the (selected, sharded) workload —
    everything the gateway needs to register it without expanding a
    single invocation."""
    fid: int
    tenant: int
    mem_bytes: int
    total_invocations: int


class _Row(NamedTuple):
    """Columnar record of one invocations-CSV row (one function)."""
    fid: int
    tenant: int
    key_crc: int                    # crc32(owner|app|function): cell seed
    mem_bytes: int
    dur_cdf: Optional[tuple]        # (qs, vs) percentile inverse-CDF
    dur_mean_s: Optional[float]
    minutes: np.ndarray             # nonzero minute labels (sorted)
    counts: np.ndarray              # invocations per nonzero minute
    total: int


def _crc(*parts: str) -> int:
    return zlib.crc32("|".join(parts).encode())


def _norm_ppf_vec(u: np.ndarray) -> np.ndarray:
    """Vectorized Acklam inverse normal CDF (same coefficients as
    ``repro_torch.core.traces._norm_ppf``); valid on (0, 1)."""
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
    u = np.asarray(u, np.float64)
    plow, phigh = 0.02425, 1 - 0.02425
    out = np.empty_like(u)

    lo = u < plow
    hi = u > phigh
    mid = ~(lo | hi)

    if lo.any():
        q = np.sqrt(-2 * np.log(u[lo]))
        out[lo] = ((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4])
                    * q + c[5])
                   / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1))
    if hi.any():
        q = np.sqrt(-2 * np.log(1 - u[hi]))
        out[hi] = -((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q
                      + c[4]) * q + c[5])
                    / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1))
    if mid.any():
        q = u[mid] - 0.5
        r = q * q
        out[mid] = ((((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r
                      + a[4]) * r + a[5]) * q
                    / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r
                        + b[4]) * r + 1))
    return out


def _parse_count(val, path: str, row_no: int, col: str) -> int:
    """A malformed per-minute count is a schema error, never a silent
    skip: the dataset's columns are non-negative integers."""
    if val in (None, ""):
        return 0
    try:
        n = float(val)
    except ValueError:
        raise ValueError(
            f"azure trace {path}: row {row_no}, minute column {col!r}: "
            f"non-numeric invocation count {val!r}") from None
    if not np.isfinite(n) or n < 0 or n != int(n):
        raise ValueError(
            f"azure trace {path}: row {row_no}, minute column {col!r}: "
            f"invalid invocation count {val!r} (expected a non-negative "
            f"integer)")
    return int(n)


def _percentile_cdf(row: dict, prefix: str) -> Optional[tuple]:
    """(qs, vs) arrays for the ``<prefix><q>`` percentile columns of one
    durations-table row — the vectorizable form of
    ``traces._percentile_sampler``."""
    pts = []
    for col, val in row.items():
        if col.startswith(prefix) and val not in (None, ""):
            try:
                q = float(col[len(prefix):])
            except ValueError:
                continue
            pts.append((q, float(val)))
    pts.sort()
    if len(pts) < 2:
        return None
    qs = np.array([q for q, _ in pts]) / 100.0
    vs = np.array([v for _, v in pts])
    return qs, vs


def _app_mem_fallback(app: str, seed: int) -> int:
    """Apps the memory table doesn't cover get one seeded draw each,
    keyed by app identity (not row position) so every window/selection/
    shard of one trace agrees on the app's footprint."""
    rng = np.random.default_rng(
        np.random.SeedSequence((seed, _APP_MEM_TAG, _crc(app))))
    return int(np.clip(rng.lognormal(MEM_LOG_MEAN, MEM_SIGMA),
                       *MEM_CLIP_MB) * MB)


def _expand_cell(row: _Row, minute: int, keep: float, seed: int):
    """One (function-row, minute) cell -> (ts, fids, tenants, durs, mems)
    arrays, or None when thinning drops the whole cell. Deterministic per
    (seed, row identity, minute) — independent of every other cell."""
    rng = np.random.default_rng(
        np.random.SeedSequence((seed, _CELL_TAG, row.key_crc, minute)))
    n = int(row.counts[np.searchsorted(row.minutes, minute)])
    if keep < 1.0:
        n = int(rng.binomial(n, keep))
    if n <= 0:
        return None
    ts = 60.0 * (minute - 1) + np.sort(rng.uniform(0.0, 60.0, n))
    us = rng.uniform(0.001, 0.999, n)
    if row.dur_cdf is not None:
        qs, vs = row.dur_cdf
        durs = np.maximum(np.interp(us, qs, vs) / 1e3, 1e-3)
    elif row.dur_mean_s is not None:
        durs = np.full(n, max(row.dur_mean_s, 1e-3))
    else:
        durs = np.clip(np.exp(DUR_LOG_MEAN + DUR_SIGMA * _norm_ppf_vec(us)),
                       *DUR_CLIP_S)
    return ts, durs


class StreamingTrace:
    """A re-iterable, time-ordered stream of :class:`Invocation` expanded
    lazily from an Azure Functions 2019 invocations CSV.

    Construction performs the single chunked ingestion pass (schema
    validation, id assignment, selection, thinning-rate computation);
    each ``__iter__`` expands minute buckets on demand. See the module
    docstring for the memory model and determinism contract.
    """

    source = "azure-stream"

    def __init__(self, invocations_csv: str,
                 durations_csv: Optional[str] = None,
                 memory_csv: Optional[str] = None,
                 target_rps: Optional[float] = None,
                 max_minutes: Optional[int] = None,
                 minute_range: Optional[tuple] = None,
                 seed: int = 0,
                 chunk_rows: int = 4096,
                 top_k: Optional[int] = None,
                 select: str = "top",
                 n_shards: int = 1,
                 shard_index: Optional[int] = None):
        if chunk_rows < 1:
            raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
        if select not in SELECT_MODES:
            raise ValueError(f"select must be one of {SELECT_MODES}, "
                             f"got {select!r}")
        if top_k is not None and top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if shard_index is not None and not 0 <= shard_index < n_shards:
            raise ValueError(f"shard_index {shard_index} outside "
                             f"[0, {n_shards})")
        self.path = invocations_csv
        self.seed = seed
        self.target_rps = target_rps
        self.chunk_rows = chunk_rows
        self.top_k = top_k
        self.select = select
        self.n_shards = n_shards
        self.shard_index = shard_index
        self._kw = dict(durations_csv=durations_csv, memory_csv=memory_csv,
                        target_rps=target_rps, max_minutes=max_minutes,
                        minute_range=minute_range, seed=seed,
                        chunk_rows=chunk_rows, top_k=top_k, select=select)
        # iteration statistics (filled by ingestion / updated per pass)
        self.peak_buffered = 0         # max invocations resident at once
        self.last_count: Optional[int] = None   # invocations last pass

        dur_cdf, dur_mean = self._load_durations(durations_csv)
        mem_of = self._load_memory(memory_csv)
        rows = self._ingest(invocations_csv, dur_cdf, dur_mean, mem_of,
                            max_minutes, minute_range)
        rows = self._select(rows)

        total = sum(r.total for r in rows)
        if total == 0:
            raise ValueError(
                f"azure trace {invocations_csv}: selected window contains "
                f"zero invocations (minutes "
                f"{self._window[0]}..{self._window[-1]}, "
                f"top_k={top_k}, select={select!r})")
        # realized rate over the window's wall-clock span; matches the
        # in-memory loader's horizon semantics when the window starts at
        # minute 1
        window_s = 60.0 * (int(self._window[-1]) - (int(self._window[0]) - 1))
        actual_rps = total / window_s if window_s > 0 else 0.0
        self.keep = 1.0
        if target_rps is not None and actual_rps > target_rps > 0:
            self.keep = target_rps / actual_rps
        self.raw_invocations = total

        if shard_index is not None and n_shards > 1:
            rows = [r for r in rows if r.tenant % n_shards == shard_index]
        self._rows = rows
        # inverted per-minute index over the kept rows, in row order
        self._by_minute: dict = {}
        for idx, r in enumerate(rows):
            for m in r.minutes.tolist():
                self._by_minute.setdefault(m, []).append(idx)

    # -- ingestion ---------------------------------------------------------
    @staticmethod
    def _load_durations(durations_csv):
        dur_cdf: dict = {}
        dur_mean: dict = {}
        if not durations_csv:
            return dur_cdf, dur_mean
        with open(durations_csv, newline="") as f:
            reader = csv.DictReader(f)
            if reader.fieldnames is None:
                raise ValueError(f"azure durations {durations_csv}: "
                                 f"empty file (no header)")
            if "HashFunction" not in reader.fieldnames:
                raise ValueError(f"azure durations {durations_csv}: "
                                 f"missing HashFunction column")
            for r in reader:
                cdf = _percentile_cdf(r, "percentile_Average_")
                if cdf is not None:
                    dur_cdf[r["HashFunction"]] = cdf
                if r.get("Average") not in (None, ""):
                    dur_mean[r["HashFunction"]] = float(r["Average"]) / 1e3
        return dur_cdf, dur_mean

    @staticmethod
    def _load_memory(memory_csv):
        mem_of: dict = {}
        if not memory_csv:
            return mem_of
        with open(memory_csv, newline="") as f:
            reader = csv.DictReader(f)
            if reader.fieldnames is None:
                raise ValueError(f"azure memory {memory_csv}: empty file "
                                 f"(no header)")
            if "HashApp" not in reader.fieldnames \
                    or "AverageAllocatedMb" not in reader.fieldnames:
                raise ValueError(f"azure memory {memory_csv}: missing "
                                 f"HashApp/AverageAllocatedMb column(s)")
            for r in reader:
                mb = float(r["AverageAllocatedMb"])
                mem_of[r["HashApp"]] = int(np.clip(mb, 16, 1024) * MB)
        return mem_of

    def _ingest(self, path, dur_cdf, dur_mean, mem_of, max_minutes,
                minute_range) -> list:
        """One chunked pass over the invocations CSV: validate the
        schema, assign stable ids in file order, and reduce each row to
        a columnar :class:`_Row`. Only ``chunk_rows`` raw CSV rows are
        resident at a time."""
        fid_of: dict = {}
        tenant_of: dict = {}
        rows: list = []
        with open(path, newline="") as f:
            reader = csv.DictReader(f)
            header = reader.fieldnames
            if header is None:
                raise ValueError(f"azure trace {path}: empty file "
                                 f"(no header)")
            missing = [c for c in _REQUIRED_INV_COLS if c not in header]
            if missing:
                raise ValueError(
                    f"azure trace {path}: missing required column(s) "
                    f"{missing}; expected the Azure Functions 2019 "
                    f"invocations_per_function schema")
            minute_cols = sorted((c for c in header if c.isdigit()), key=int)
            if not minute_cols:
                raise ValueError(
                    f"azure trace {path}: no per-minute count columns "
                    f"(integer-named, e.g. '1'..'1440') found")
            if max_minutes is not None:
                minute_cols = [c for c in minute_cols
                               if int(c) <= max_minutes]
                if not minute_cols:
                    raise ValueError(
                        f"azure trace {path}: no minute columns within "
                        f"max_minutes={max_minutes}")
            if minute_range is not None:
                lo, hi = minute_range
                minute_cols = [c for c in minute_cols if lo <= int(c) <= hi]
                if not minute_cols:
                    raise ValueError(
                        f"azure trace {path}: no minute columns within "
                        f"minute_range={minute_range}")
            self._window = [int(c) for c in minute_cols]

            n_rows = 0
            chunk: list = []
            while True:
                row = next(reader, None)
                if row is not None:
                    chunk.append(row)
                if row is not None and len(chunk) < self.chunk_rows:
                    continue
                for r in chunk:
                    n_rows += 1
                    rows.append(self._reduce_row(
                        r, n_rows, path, minute_cols, fid_of, tenant_of,
                        dur_cdf, dur_mean, mem_of))
                chunk.clear()
                if row is None:
                    break
            if n_rows == 0:
                raise ValueError(f"azure trace {path}: no data rows")
        return [r for r in rows if r is not None]

    def _reduce_row(self, r, row_no, path, minute_cols, fid_of, tenant_of,
                    dur_cdf, dur_mean, mem_of) -> Optional[_Row]:
        fkey = r["HashFunction"]
        app = r["HashApp"]
        owner = r["HashOwner"]
        # stable integer ids in file order, assigned to EVERY row (even
        # all-zero ones) so ids never depend on windowing or selection
        fid = fid_of.setdefault(fkey, len(fid_of))
        tenant = tenant_of.setdefault(owner, len(tenant_of))
        minutes = []
        counts = []
        for col in minute_cols:
            n = _parse_count(r.get(col), path, row_no, col)
            if n > 0:
                minutes.append(int(col))
                counts.append(n)
        if not minutes:
            return None
        mem = mem_of.get(app)
        if mem is None:
            mem = _app_mem_fallback(app, self.seed)
        return _Row(fid=fid, tenant=tenant,
                    key_crc=_crc(owner, app, fkey), mem_bytes=mem,
                    dur_cdf=dur_cdf.get(fkey), dur_mean_s=dur_mean.get(fkey),
                    minutes=np.asarray(minutes, np.int32),
                    counts=np.asarray(counts, np.int64),
                    total=int(sum(counts)))

    def _select(self, rows: list) -> list:
        """Top-K / stratified selection over the windowed rows. ``top``
        keeps the K busiest function rows; ``stratified`` splits the
        popularity ranking into K strata and keeps one seeded pick per
        stratum, so a small budget still spans head, torso, and tail."""
        if self.top_k is None or self.top_k >= len(rows):
            return rows
        ranked = sorted(rows, key=lambda r: (-r.total, r.fid))
        if self.select == "top":
            kept = ranked[:self.top_k]
        else:
            strata = np.array_split(np.arange(len(ranked)), self.top_k)
            kept = []
            for i, stratum in enumerate(strata):
                if len(stratum) == 0:
                    continue
                rng = np.random.default_rng(
                    np.random.SeedSequence((self.seed, _STRATUM_TAG, i)))
                kept.append(ranked[int(rng.choice(stratum))])
        return sorted(kept, key=lambda r: r.fid)

    # -- streaming interface ----------------------------------------------
    def __iter__(self):
        count = 0
        for m in self._window:
            cell_rows = self._by_minute.get(m)
            if not cell_rows:
                continue
            ts_parts, dur_parts, fid_parts, ten_parts, mem_parts = \
                [], [], [], [], []
            for idx in cell_rows:
                row = self._rows[idx]
                cell = _expand_cell(row, m, self.keep, self.seed)
                if cell is None:
                    continue
                ts, durs = cell
                ts_parts.append(ts)
                dur_parts.append(durs)
                n = len(ts)
                fid_parts.append(np.full(n, row.fid, np.int64))
                ten_parts.append(np.full(n, row.tenant, np.int64))
                mem_parts.append(np.full(n, row.mem_bytes, np.int64))
            if not ts_parts:
                continue
            ts = np.concatenate(ts_parts)
            durs = np.concatenate(dur_parts)
            fids = np.concatenate(fid_parts)
            tenants = np.concatenate(ten_parts)
            mems = np.concatenate(mem_parts)
            # minute intervals are disjoint, so per-minute (t, fid) order
            # equals the in-memory loader's global sort
            order = np.lexsort((fids, ts))
            self.peak_buffered = max(self.peak_buffered, len(ts))
            count += len(ts)
            for i in order:
                yield Invocation(t=float(ts[i]), fid=int(fids[i]),
                                 tenant=int(tenants[i]),
                                 duration_s=float(durs[i]),
                                 mem_bytes=int(mems[i]))
        self.last_count = count

    def functions(self) -> list:
        """The registrable workload — one :class:`TraceFunction` per
        distinct fid of the kept rows — without expanding invocations."""
        by_fid: dict = {}
        for r in self._rows:
            f = by_fid.get(r.fid)
            if f is None:
                by_fid[r.fid] = TraceFunction(r.fid, r.tenant, r.mem_bytes,
                                              r.total)
            else:
                by_fid[r.fid] = f._replace(
                    total_invocations=f.total_invocations + r.total)
        return [by_fid[fid] for fid in sorted(by_fid)]

    def shard(self, n_shards: int, shard_index: int) -> "StreamingTrace":
        """The tenant-partitioned sub-trace ``tenant % n_shards ==
        shard_index``. Shards partition this trace exactly: selection
        and the thinning rate are fixed before the shard filter, so the
        union of all shards' invocations equals the unsharded stream."""
        return StreamingTrace(self.path, n_shards=n_shards,
                              shard_index=shard_index, **self._kw)

    def window(self, first_minute: int, last_minute: int) -> "StreamingTrace":
        """A minute-label window of the same trace (inclusive bounds)."""
        kw = dict(self._kw, minute_range=(first_minute, last_minute),
                  max_minutes=None)
        return StreamingTrace(self.path, n_shards=self.n_shards,
                              shard_index=self.shard_index, **kw)

    @property
    def meta(self) -> dict:
        return {"path": self.path, "target_rps": self.target_rps,
                "thinning_keep": self.keep,
                "raw_invocations": self.raw_invocations,
                "minutes": len(self._window), "seed": self.seed,
                "top_k": self.top_k, "select": self.select,
                "n_shards": self.n_shards, "shard_index": self.shard_index}

    @property
    def duration_s(self) -> float:
        return 60.0 * self._window[-1]

    def describe(self) -> dict:
        """Workload provenance without forcing an expansion pass:
        ``invocations`` is exact after one full iteration (the bench
        sweeps iterate before describing) and a thinning estimate
        before."""
        n = self.last_count if self.last_count is not None \
            else int(round(self.raw_invocations * self.keep))
        fns = self.functions()
        d = self.duration_s
        return {**self.meta, "source": self.source, "invocations": n,
                "functions": len(fns),
                "tenants": len({f.tenant for f in fns}),
                "duration_s": d,
                "mean_rps": n / d if d > 0 else 0.0}
