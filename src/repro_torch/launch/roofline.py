"""Roofline analysis of one counted run of a step: a port of
``repro/launch/roofline.py``.

Three terms per (arch x shape x mesh), all in seconds (per device):

  compute    = flops_per_device / PEAK_BF16_FLOPS
  memory     = bytes_per_device / HBM_BW
  collective = wire_bytes_per_device / ICI_BW

The reference reads XLA's cost analysis of a compiled executable. The
port has no executable: ``StepCounter``, a ``TorchDispatchMode``, watches
one eager run of the step (on the ``meta`` device in the dry-run) and
counts, per op that runs on this rank's tensors:

* flops: matmul / bmm / addmm / baddbmm / convolution / SDPA, by the
  formulas of ``torch.utils.flop_counter``;
* bytes: every tensor input read once and every output written once, op
  by op (views move nothing). Eager PyTorch runs op by op, so this is the
  port's "bytes accessed"; it is not XLA's figure for fused code, where
  an elementwise chain reads its inputs and writes its result once;
* collectives: the ``_c10d_functional`` ops DTensor issues (all-gather,
  reduce-scatter, all-reduce, all-to-all, permute), their wire bytes by
  ``wire_bytes`` from the size of the group they run on.

Counts are per device, as the reference's are: an op on DTensors is not
counted itself (its arithmetic is the logical, whole-mesh product); the
counter lets DTensor run it and counts the ops DTensor then runs on the
local shards, and the collectives it issues to redistribute them.
DTensor's sharding propagation runs ops on fake tensors of the global
shapes; those are not counted either.

The reference also undoes its CPU host's bf16 legalization
(``cpu_artifact_correction``). The port has no CPU legalization to undo:
``raw_bytes_per_device`` equals ``bytes_per_device`` and
``corrected_ops`` is 0.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten

from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_BF16_FLOPS

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

# functional collective op name (either namespace) -> kind; wait_tensor
# and the autograd wrappers move nothing
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "permute_tensor": "collective-permute",
    "broadcast": "collective-permute",
}
_FUNCOL_NS = ("_c10d_functional", "c10d_functional")
# in-place ops that overwrite their first argument without reading it
_WRITE_ONLY_FIRST = ("zero_", "fill_", "copy_", "normal_", "uniform_")


def wire_bytes(op: str, out_bytes: float, group: int) -> float:
    """Ring-collective bytes one device sends for ``op`` (a kind of
    ``KINDS``) whose output holds ``out_bytes``, over a group of
    ``group`` devices:

      all-gather         out_bytes * (g-1)/g
      reduce-scatter     out_bytes * (g-1)          (input = out*g)
      all-reduce         2 * out_bytes * (g-1)/g    (reduce-scatter + all-gather)
      all-to-all         out_bytes * (g-1)/g
      collective-permute out_bytes
    """
    g = group
    if op == "all-gather":
        return out_bytes * (g - 1) / g
    if op == "all-reduce":
        return 2 * out_bytes * (g - 1) / g
    if op == "reduce-scatter":
        return out_bytes * (g - 1)
    if op == "all-to-all":
        return out_bytes * (g - 1) / g
    if op == "collective-permute":
        return out_bytes
    raise ValueError(f"wire_bytes: unknown collective {op!r}")


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _group_size(name: str, args) -> int:
    """The size of the group a functional collective runs on: its
    ``group_size`` argument where it has one, else its group's size."""
    for a in reversed(args):                    # the name comes last
        if isinstance(a, str):
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            return _resolve_process_group(a).size()
    raise ValueError(f"{name}: no group in its arguments")


def _under_fake_mode() -> bool:
    from torch._subclasses.fake_tensor import FakeTensorMode
    return any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack())


def _any_fake(out) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(t, FakeTensor) for t in tree_flatten(out)[0])


@dataclass
class Counts:
    flops: float = 0.0
    bytes: float = 0.0
    collectives: dict = field(default_factory=lambda: {
        **{k: 0.0 for k in KINDS}, "count": 0})
    peak_live_bytes: int = 0
    ops: int = 0

    @property
    def wire(self) -> float:
        return sum(self.collectives[k] for k in KINDS)


class StepCounter(TorchDispatchMode):
    """Counts the flops, bytes and collectives of the ops run under it,
    on this rank's tensors (module docstring), and the peak of the bytes
    held by the storages those ops wrote while they were alive."""

    SWEEP = 64          # ops between sweeps of the live storages

    def __init__(self):
        super().__init__()
        self.counts = Counts()
        self._live: dict = {}          # storage key -> (weakref, nbytes)
        self._live_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor runs it; we see the shards
        out = func(*args, **kwargs)
        if _under_fake_mode() or _any_fake(out):
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry
        c = self.counts
        c.ops += 1
        packet = func._overloadpacket
        ns, name = func.namespace, packet.__name__
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if ns in _FUNCOL_NS:
            kind = _COLLECTIVES.get(name)
            if kind is None:
                return                  # wait_tensor and friends
            out_b = sum(_nbytes(t) for t in outs)
            c.collectives[kind] += wire_bytes(kind, out_b,
                                              _group_size(name, args))
            c.collectives["count"] += 1
        if packet in flop_registry:
            c.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.is_view or name.startswith(("empty", "new_empty")):
            return
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        held = {t.untyped_storage()._cdata for t in ins}
        if not name.endswith("_") and "out" not in kwargs and all(
                t.untyped_storage()._cdata in held for t in outs):
            return                      # a view by another name
        # what the op only writes is not read: an ``out=`` tensor, the
        # destination of a fill or a copy
        read = [t for t in tree_flatten(args)[0]
                if isinstance(t, torch.Tensor)]
        if name in _WRITE_ONLY_FIRST:
            read = read[1:]
        read += [t for k, t in kwargs.items()
                 if isinstance(t, torch.Tensor) and k != "out"]
        c.bytes += sum(_nbytes(t) for t in read) + sum(_nbytes(t)
                                                       for t in outs)
        self._track(outs, held)

    def _track(self, outs, held) -> None:
        """Note the storages the op allocated (not those it wrote in
        place, which its inputs already held)."""
        from torch.multiprocessing.reductions import StorageWeakRef
        for t in outs:
            s = t.untyped_storage()
            key = s._cdata
            if key in self._live or key in held:
                continue
            self._live[key] = (StorageWeakRef(s), s.nbytes())
            self._live_bytes += s.nbytes()
        if self.counts.ops % self.SWEEP == 0:
            self.sweep()

    def sweep(self) -> None:
        """Drop the storages that died; record the peak of the living."""
        self.counts.peak_live_bytes = max(self.counts.peak_live_bytes,
                                          self._live_bytes)
        for key in [k for k, (ref, _) in self._live.items() if ref.expired()]:
            self._live_bytes -= self._live.pop(key)[1]

    def __exit__(self, *exc):
        self.sweep()
        return super().__exit__(*exc)


@dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    collectives: dict
    n_devices: int
    raw_bytes_per_device: float = 0.0
    ideal_bytes_per_device: float = 0.0
    corrected_ops: int = 0

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_BF16_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.wire_bytes_per_device / ICI_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline-model step time (no overlap assumption = max term)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def summary(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "raw_bytes_per_device": self.raw_bytes_per_device,
            "ideal_bytes_per_device": self.ideal_bytes_per_device,
            "cpu_artifact_ops_corrected": self.corrected_ops,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "n_collectives": self.collectives.get("count", 0),
            "collectives": {k: v for k, v in self.collectives.items()
                            if k not in ("count", "total")},
        }


def analyze(counts: Counts, n_devices: int, *,
            scale: float = 1.0) -> Roofline:
    """Roofline terms from a ``StepCounter``'s counts.

    ``scale`` multiplies all three terms (used to scale one counted
    microbatch step to the full gradient-accumulation step). The
    reference's floor, ``ideal_bytes_per_device`` (outputs written once
    under its corrected bytes), stays 0: no correction lowers the port's
    op-by-op bytes, which count every output written.
    """
    colls = dict(counts.collectives)
    colls["total"] = counts.wire
    nbytes = counts.bytes * scale
    return Roofline(flops_per_device=counts.flops * scale,
                    bytes_per_device=nbytes,
                    wire_bytes_per_device=counts.wire * scale,
                    collectives=colls, n_devices=n_devices,
                    raw_bytes_per_device=nbytes,
                    corrected_ops=0)
