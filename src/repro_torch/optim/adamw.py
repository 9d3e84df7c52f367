"""AdamW with global-norm clipping (fp32 moments), a port of
``repro/optim/adamw.py``.

The reference's train step donates its params and optimizer state
(``donate_argnums=(0, 1)`` in ``repro/launch/train.py``); here ``update``
works in place instead. The moments, the step counter and the params are
updated where they lie, the grads are scaled in chunks, and every
temporary is one chunk of one leaf (``CHUNK`` elements), so a step never
holds a second copy of the model's state: at full width (qwen2.5-3b,
13.6 GB of fp32 masters) params, grads, m and v already fill 54 GB of
the card's 80. The arithmetic keeps the reference's order and fp32
rounding points.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.device import local, reduce_shards

CHUNK = 1 << 24           # elements per in-place slice of a leaf


# (core.arena has a tree_leaves too, but importing repro_torch.core from
# here would cycle: core's runtime imports models.programs, which uses
# these)
def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (the params' structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def chunks(*ts):
    """Matching flat slices of up to CHUNK elements of contiguous tensors
    of one shape: in-place ops on them write through to the tensors."""
    flat = []
    for t in ts:
        if not t.is_contiguous():
            raise ValueError("in-place optimizer update needs contiguous "
                             "leaves")
        flat.append(t.view(-1))
    n = flat[0].numel()
    for i in range(0, n, CHUNK):
        yield tuple(f[i:i + CHUNK] for f in flat)


def global_norm(tree) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf, in fp32, on the leaves'
    device (a reduction per leaf, no squared copy). A DTensor leaf's
    local sum is summed over the mesh dims it is split on, one reduction
    for each placement the leaves share."""
    by_layout = {}
    for x in tree_leaves(tree):
        sq = torch.linalg.vector_norm(local(x), dtype=torch.float32).square()
        key = (id(x.device_mesh), tuple(x.placements)) \
            if hasattr(x, "placements") else None
        by_layout.setdefault(key, (x, []))[1].append(sq)
    total = [reduce_shards(torch.stack(sqs).sum(), like)
             for like, sqs in by_layout.values()]
    return torch.sqrt(torch.stack(total).sum())


@dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]   # step -> learning rate
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        dev = tree_leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(self, grads, state, params):
        """One step, in place: ``params`` and ``state`` are updated where
        they lie and returned; ``grads`` are read only. Returns
        (params, state, {"grad_norm", "lr"}), the metrics as 0-d fp32
        tensors on the params' device."""
        step = state["step"]
        step.add_(1)
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        stepf = step.to(torch.float32)
        bc1 = 1 - self.b1 ** stepf
        bc2 = 1 - self.b2 ** stepf
        lr = self.lr(step)
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                              tree_leaves(state["v"]), tree_leaves(params)):
            self._leaf(local(g), local(m), local(v), local(p), scale, bc1,
                       bc2, lr)
        return params, state, {"grad_norm": gnorm, "lr": lr}

    def _leaf(self, g, m, v, p, scale, bc1, bc2, lr) -> None:
        b1, b2 = self.b1, self.b2
        for gc, mc, vc, pc in chunks(g, m, v, p):
            gs = gc.to(torch.float32) * scale
            mc.mul_(b1).add_(gs, alpha=1 - b1)
            vc.mul_(b2).addcmul_(gs, gs, value=1 - b2)
            den = torch.div(vc, bc2).sqrt_().add_(self.eps)
            delta = torch.div(mc, bc1, out=gs).div_(den)
            pf = pc.to(torch.float32)
            delta.add_(pf, alpha=self.weight_decay)
            if pc.dtype == torch.float32:
                pc.sub_(delta.mul_(lr))
            else:
                pc.copy_(pf - delta.mul_(lr))
