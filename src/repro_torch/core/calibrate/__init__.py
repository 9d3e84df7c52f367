"""Measured-cost calibration for the simulator.

``SimParams`` startup/memory constants default to the paper's
measurements. This module replaces them with values measured on *your*
host: ``benchmarks/bench_startup.py --emit-calibration out.json`` runs
the Fig-1 measurements and writes a calibration JSON; ``bench_trace
--calibration out.json`` (or :func:`apply_calibration` directly) then
replays traces with the measured constants, so simulated density/latency
deltas reflect this machine rather than the paper's testbed.
The reference's ``serve --calibration`` emits the same schema from live
serving metrics, and :func:`calibration_from_replay` derives it from one
live gateway replay (the gateway -> calibration -> sim round trip of the
reference's ``gateway.validate --round-trip``; the port's gateway comes
in a later slice).

A copy of ``repro.core.calibrate`` with its imports rewritten; a package
(``core/calibrate/__init__.py``) so that the documentation's bare
``calibrate.py`` references keep resolving to one file (hydralint HL006).

Schema (``hydra-calibration/v1``)::

    {
      "schema": "hydra-calibration/v1",
      "meta": {"host": "...", "source": "bench_startup"},
      "measured": {"hydra_runtime_cold_s": 0.041, ...}
    }

``measured`` keys must be :data:`CALIBRATABLE_FIELDS` — the ``SimParams``
fields a measurement can override. Unknown keys or non-numeric values
are schema errors (raise ``ValueError``), so a stale file fails loudly
instead of silently mis-calibrating a replay.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional, Union

from repro_torch.core.sim.engine import SimParams

SCHEMA = "hydra-calibration/v1"

# SimParams fields a measurement may override; int fields get rounded.
CALIBRATABLE_FIELDS: tuple = (
    "runtime_cold_s", "hydra_runtime_cold_s", "isolate_cold_s",
    "isolate_warm_s", "fn_register_s", "vm_boot_s", "pool_claim_s",
    "pool_refill_s", "snapshot_restore_s", "runtime_base",
    "hydra_runtime_base", "isolate_base",
)
_INT_FIELDS = frozenset(("runtime_base", "hydra_runtime_base",
                         "isolate_base"))


def _validate(measured: dict) -> dict:
    if not isinstance(measured, dict) or not measured:
        raise ValueError("calibration 'measured' must be a non-empty dict")
    unknown = sorted(set(measured) - set(CALIBRATABLE_FIELDS))
    if unknown:
        raise ValueError(
            f"calibration has unknown field(s) {unknown}; calibratable "
            f"SimParams fields are {sorted(CALIBRATABLE_FIELDS)}")
    out = {}
    for k, v in measured.items():
        if not isinstance(v, (int, float)) or isinstance(v, bool) \
                or not math.isfinite(v) or v < 0:
            raise ValueError(f"calibration field {k!r} must be a finite "
                             f"non-negative number, got {v!r}")
        out[k] = int(round(v)) if k in _INT_FIELDS else float(v)
    return out


def write_calibration(path: str, measured: dict,
                      meta: Optional[dict] = None) -> dict:
    """Validate ``measured`` and write the calibration JSON; returns the
    document written."""
    doc = {"schema": SCHEMA, "meta": dict(meta or {}),
           "measured": _validate(measured)}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return doc


def write_calibration_doc(path: str, doc: dict) -> dict:
    """Persist an already-built calibration document (e.g. from
    :func:`calibration_from_replay`) — one place for the
    extract-measured/meta-and-write step every CLI shares."""
    return write_calibration(path, doc["measured"], meta=doc.get("meta"))


def load_calibration(path: str) -> dict:
    """Read + validate a calibration JSON; returns the ``measured`` dict
    (field -> value)."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("schema") != SCHEMA:
        raise ValueError(f"{path}: not a {SCHEMA} document "
                         f"(schema={doc.get('schema') if isinstance(doc, dict) else None!r})")
    return _validate(doc.get("measured", {}))


# live-replay wall-cost names (gateway CalibrationProbe) -> the SimParams
# field each one calibrates. Boot cost lands TWICE: a dry-pool cold start
# charges it inline (hydra_runtime_cold_s) and a claimed slot's background
# re-warm takes one boot as well (pool_refill_s).
_REPLAY_COST_FIELDS = {
    "runtime_boot_s": ("hydra_runtime_cold_s", "pool_refill_s"),
    "pool_claim_s": ("pool_claim_s",),
    "restore_s": ("snapshot_restore_s",),
    "register_s": ("fn_register_s",),
    "arena.alloc_s": ("isolate_cold_s",),
}


def calibration_from_replay(result, extras: dict,
                            meta: Optional[dict] = None,
                            include_memory: bool = False) -> dict:
    """Turn one live gateway replay into a ``hydra-calibration/v1``
    overlay for ``SimParams`` — the gateway -> calibration -> sim round
    trip (``gateway/validate.py --round-trip``).

    ``result`` is the replay's ``SimResult``; ``extras`` must carry the
    ``CalibrationProbe`` payload under ``"probe"`` (``replay_trace``
    records it whenever ``ReplayConfig.probe`` is on). Probe costs are
    measured in *wall* seconds, but live replays record latencies in
    *trace* seconds (wall x compress) — real startup does not compress
    with the replay clock — so every cost is scaled by the probe's
    ``compress`` factor: the calibrated simulator then predicts the
    trace-time behaviour the live stack actually exhibits at that
    compression. ``vm_boot_s`` is zeroed because the measured boot
    already covers the whole live cold-start path (there is no microVM
    under it).

    ``include_memory=True`` additionally maps the probe's measured
    per-runtime RSS onto ``hydra_runtime_base``. Off by default: live
    arenas are ``mem_scale``'d while process RSS is not, so a raw RSS
    figure distorts the simulator's packing ratios; the measurement is
    always reported in the returned ``meta`` either way.

    Returns the full calibration document (validated, same shape
    ``write_calibration`` produces); pass ``doc["measured"]`` to
    :func:`apply_calibration`.
    """
    probe = extras.get("probe")
    if not probe:
        raise ValueError(
            "replay carried no calibration probe (extras['probe'] is "
            "missing/empty); run replay_trace with ReplayConfig(probe=True)")
    compress = float(probe["compress"])
    if not math.isfinite(compress) or compress <= 0:
        raise ValueError(f"probe compress must be positive, got {compress!r}")
    measured: dict = {}
    for cost_name, fields in _REPLAY_COST_FIELDS.items():
        sample = probe.get("wall_costs", {}).get(cost_name)
        if not sample or not sample.get("count"):
            continue
        for f in fields:
            measured[f] = float(sample["mean"]) * compress
    if "hydra_runtime_cold_s" in measured:
        # the measured boot IS the whole live cold start; don't let the
        # paper's Firecracker constant double-charge it
        measured["vm_boot_s"] = 0.0
    rss_per_runtime = probe.get("rss", {}).get("per_runtime_bytes")
    if include_memory and rss_per_runtime:
        measured["hydra_runtime_base"] = int(round(rss_per_runtime))
    if not measured:
        raise ValueError("calibration probe measured no startup costs "
                         "(no boots, claims, restores, or installs "
                         "happened during the replay window)")
    doc_meta = {"source": "gateway-replay", "model": result.model,
                "compress": compress,
                "requests": len(result.latencies),
                "rss_per_runtime_bytes": rss_per_runtime,
                # compile-cache provenance: with the persistent caches
                # warm, register_s excludes XLA time, so the overlay's
                # fn_register_s reflects a deploy against a warm code
                # cache — record the counters so a calibration file says
                # WHICH regime it measured
                "exe_cache": extras.get("exe_cache"),
                "request_overhead_ms": extras.get("request_overhead_ms")}
    doc_meta.update(meta or {})
    return {"schema": SCHEMA, "meta": doc_meta,
            "measured": _validate(measured)}


def apply_calibration(params: SimParams,
                      calibration: Union[str, dict]) -> SimParams:
    """Return a copy of ``params`` with measured constants overriding the
    paper defaults. ``calibration`` is a path to a calibration JSON or an
    already-loaded ``measured`` dict."""
    measured = load_calibration(calibration) \
        if isinstance(calibration, str) else _validate(calibration)
    return dataclasses.replace(params, **measured)
