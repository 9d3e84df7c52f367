"""ModelProgram: the uniform ABI every architecture exposes to the Hydra
runtime and the launchers.

Entry points (weights are arguments, never closed over, so every tenant
of one architecture shares one program):
  init(seed, device)                 -> params (fp32 unless dtype given)
  loss_fn(params, batch)             -> (loss, {"ce", "aux"})
  make_train_step(opt, n_micro)      -> train_step(params, opt, batch)
                                        -> (params, opt, metrics) [in place]
  prefill(params, batch)             -> (last_logits, cache)
  decode_step(params, cache, batch)  -> (logits, cache)   [cache in place]
  cache_specs(batch, seq)            -> {name: TensorSpec} (no allocation)
  input_specs(shape)                 -> {name: TensorSpec} (no allocation)

A batch holds ``tokens`` (B,S) int32, and ``embeds`` where the family
takes them: a vlm's prefix (B,frontend_tokens,D), an audio model's frames
(B,S,D) in place of tokens. An moe model routes within
``n_route_groups`` groups: one per row in decode, one per 2048 tokens
otherwise. A training batch adds ``labels`` (B,S) int32, ``IGNORE``
where no loss is taken.

The train step is the reference's ``make_train_step`` (``jax.value_and_grad``
of ``loss_fn``, micro-batch accumulation, the optimizer) done in place,
as the reference's launcher donates params and optimizer state: one
preallocated fp32 gradient buffer is zeroed each step, every parameter
(each layer's slice of a stacked leaf on its own, so no layer's backward
materialises a whole stacked leaf) is a leaf whose ``.grad`` is its view
of the buffer, autograd accumulates into it across micro-batches, and
the optimizer updates params and state where they lie. On the card the
kernels' own backward kernels run (``kernels/ops``), for every family.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import is_dtensor, resolve_device, torch_dtype
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf
from repro_torch.models.moe import n_route_groups
from repro_torch.optim.adamw import tree_leaves, tree_map

AUX_WEIGHT = 0.01
IGNORE = -1


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore: int = IGNORE, mode: str = "gather") -> torch.Tensor:
    """logits (B,S,V) any dtype, labels (B,S) int with ``ignore`` masking;
    the mean over the unmasked positions, in fp32.

    mode="gather": take the label's logit by index.
    mode="onehot": compare against an iota and reduce (the reference's
    form for vocab-sharded logits; the same number here).
    """
    logits = logits.float()
    V = logits.shape[-1]
    logz = torch.logsumexp(logits, dim=-1)
    safe = labels.clamp(0, V - 1).long()
    if mode == "onehot":
        hit = torch.arange(V, device=logits.device) == safe[..., None]
        ll = torch.where(hit, logits, 0.0).sum(-1)
    elif mode == "gather":
        ll = _label_logit(logits, safe)
    else:
        raise ValueError(f"cross_entropy mode {mode!r}")
    mask = (labels != ignore).float()
    n = mask.sum().clamp(min=1.0)
    return ((logz - ll) * mask).sum() / n


def _label_logit(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]`` by a gather. On a DTensor whose vocab dim is
    sharded, each rank gathers from its own slice, masks the labels that
    lie outside it and the slices' results are summed (a partial sum over
    the vocab's mesh dims): DTensor's own gather over a sharded dim leaves
    a masked partial that it cannot reduce."""
    from torch.distributed.tensor import DTensor
    vd = logits.ndim - 1
    if not (isinstance(logits, DTensor)
            and any(p.is_shard(vd) for p in logits.placements)):
        return logits.gather(-1, labels[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh, pl = logits.device_mesh, tuple(logits.placements)
    vocab_dims = [i for i, p in enumerate(pl) if p.is_shard(vd)]

    def local(lg, lab):
        n = lg.shape[-1]
        coord = mesh.get_coordinate()
        slot = 0
        for i in vocab_dims:        # the slice's index, major dim first
            slot = slot * mesh.size(i) + coord[i]
        idx = lab.long() - slot * n
        inside = (idx >= 0) & (idx < n)
        got = lg.gather(-1, idx.clamp(0, n - 1)[..., None])[..., 0]
        return torch.where(inside, got, 0.0)

    return local_map(
        local, out_placements=[Partial() if p.is_shard(vd) else p
                               for p in pl],
        in_placements=(list(pl), [Replicate() if p.is_shard(vd) else p
                                  for p in pl]),
        device_mesh=mesh, redistribute_inputs=True)(logits, labels)


def _layout(t) -> tuple:
    """Where a leaf lies: its device, and its mesh and placements if it
    is a DTensor."""
    if is_dtensor(t):
        return (t.device, t.device_mesh, tuple(t.placements))
    return (t.device,)


def _grad_leaves(params, grads):
    """A tree like ``params`` whose leaves require grad and alias the
    params' storage, each with ``.grad`` set to its view of ``grads``; a
    stacked per-layer leaf (under "layers") becomes the list of its layer
    slices, which ``transformer._layer`` indexes like the stacked leaf."""
    def leaf(p, g):
        t = p.detach().requires_grad_()
        t.grad = g
        return t

    def stacked(p, g):
        return [leaf(p[i], g[i]) for i in range(p.shape[0])]

    out = {k: tree_map(leaf, v, grads[k]) for k, v in params.items()
           if k != "layers"}
    if "layers" in params:
        out["layers"] = tree_map(stacked, params["layers"], grads["layers"])
    return out


def _micro_batches(batch: dict, n: int) -> list:
    """Rows [i B/n, (i+1) B/n) of every leaf, as the reference's reshape
    to (n, B/n, ...) splits them."""
    B = next(iter(batch.values())).shape[0]
    if B % n:
        raise ValueError(f"batch of {B} rows does not split into {n} "
                         f"micro-batches")
    m = B // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


class TensorSpec(NamedTuple):
    """Shape/dtype stand-in for a buffer that is not allocated."""
    shape: tuple
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n * self.dtype.itemsize


class ModelProgram:
    def __init__(self, cfg: ArchConfig, *, remat=True, ce_mode: str = "gather"):
        self.cfg = cfg
        self.remat = remat
        self.ce_mode = ce_mode

    # ------------------------------------------------------------------
    def init(self, seed: int = 0, device=None, dtype=torch.float32):
        """Random weights from a ``torch.Generator`` seeded with ``seed``
        on ``device`` (CUDA unless the caller passes another). On ``meta``
        the tree's shapes and dtypes with no data, drawn from a CPU
        generator, since no generator lives on ``meta``."""
        dev = resolve_device(device)
        gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
        return tf.init_params(gen.manual_seed(seed), self.cfg, dtype=dtype,
                              device=dev)

    def _n_groups(self, batch) -> int:
        if self.cfg.moe is None:
            return 1
        tokens = batch["tokens"] if "tokens" in batch else batch["embeds"]
        B, S = tokens.shape[0], tokens.shape[1]
        if self.cfg.family == "vlm":
            S = S + self.cfg.frontend_tokens
        kind = "decode" if S == 1 else "other"
        return n_route_groups(B * S, kind, B)

    # ------------------------------------------------------------------
    def loss_fn(self, params, batch):
        logits, aux = tf.forward(params, self.cfg, tokens=batch.get("tokens"),
                                 embeds=batch.get("embeds"),
                                 remat=self.remat,
                                 n_groups=self._n_groups(batch))
        ce = cross_entropy(logits, batch["labels"], mode=self.ce_mode)
        loss = ce + AUX_WEIGHT * aux
        return loss, {"ce": ce, "aux": aux}

    def make_train_step(self, optimizer, n_micro: int = 1):
        """The train step with gradient accumulation over ``n_micro``
        micro-batches; params and optimizer state are updated in place
        (module docstring) and returned."""
        grads = {}     # the fp32 gradient buffer, made at first use and
        # again when the params come in another layout (placed on a mesh)

        def backward(leaves, batch):
            with torch.enable_grad():
                loss, _ = self.loss_fn(leaves, batch)
                loss.backward()
            loss = loss.detach()
            return loss.full_tensor() if is_dtensor(loss) else loss

        def train_step(params, opt_state, batch):
            if not grads or _layout(tree_leaves(grads)[0]) != _layout(
                    tree_leaves(params)[0]):
                grads.clear()
                grads.update(tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.float32), params))
            else:
                for g in tree_leaves(grads):
                    g.zero_()
            leaves = _grad_leaves(params, grads)
            if n_micro == 1:
                loss = backward(leaves, batch)
            else:
                loss = sum(backward(leaves, mb)
                           for mb in _micro_batches(batch, n_micro)) / n_micro
                with torch.no_grad():
                    for g in tree_leaves(grads):
                        g.div_(n_micro)
            del leaves
            params, opt_state, omets = optimizer.update(grads, opt_state,
                                                        params)
            return params, opt_state, {"loss": loss, **omets}
        return train_step

    # ------------------------------------------------------------------
    def prefill(self, params, batch):
        return tf.prefill(params, self.cfg, tokens=batch.get("tokens"),
                          embeds=batch.get("embeds"),
                          n_groups=self._n_groups(batch))

    def decode_step(self, params, cache, batch):
        return tf.decode_step(params, self.cfg, cache,
                              tokens=batch.get("tokens"),
                              embeds=batch.get("embeds"),
                              n_groups=self._n_groups(batch))

    # ------------------------------------------------------------------
    # Shape stand-ins (arena sizing) — never allocate.
    # ------------------------------------------------------------------
    def cache_specs(self, batch: int, seq: int) -> dict:
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        specs = {}
        if cfg.family in ("ssm", "hybrid"):
            specs["conv"] = TensorSpec((cfg.n_layers, batch, cfg.ssm_conv - 1,
                                        ssm_mod.conv_dim(cfg)), dt)
            specs["state"] = TensorSpec((cfg.n_layers, batch, cfg.ssm_heads,
                                         cfg.ssm_head_dim, cfg.ssm_state),
                                        torch.float32)
        if cfg.family != "ssm":
            n_kv = tf.hybrid_groups(cfg) if cfg.family == "hybrid" \
                else cfg.n_layers
            specs["k"] = specs["v"] = TensorSpec(
                (n_kv, batch, seq, cfg.n_kv_heads, cfg.resolved_head_dim), dt)
        specs["length"] = TensorSpec((batch,), torch.int32)
        return specs

    def cache_bytes(self, batch: int, seq: int) -> int:
        return sum(s.nbytes for s in self.cache_specs(batch, seq).values())

    def input_specs(self, shape) -> dict:
        """Stand-ins for the batch of the entry point ``shape.kind`` names
        (a ``ShapeConfig``):

        train  -> {tokens?, embeds?, labels}
        prefill-> {tokens?, embeds?}
        decode -> {tokens?/embeds?} (the cache comes from cache_specs)
        """
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        dt = torch_dtype(cfg.dtype)
        if shape.kind == "decode":
            if cfg.family == "audio":
                return {"embeds": TensorSpec((B, 1, cfg.d_model), dt)}
            return {"tokens": TensorSpec((B, 1), torch.int32)}
        batch = {}
        if cfg.family == "audio":
            batch["embeds"] = TensorSpec((B, S, cfg.d_model), dt)
        elif cfg.family == "vlm":
            ft = cfg.frontend_tokens
            batch["embeds"] = TensorSpec((B, ft, cfg.d_model), dt)
            batch["tokens"] = TensorSpec((B, S - ft), torch.int32)
        else:
            batch["tokens"] = TensorSpec((B, S), torch.int32)
        if shape.kind == "train":
            batch["labels"] = TensorSpec((B, S), torch.int32)
        return batch
