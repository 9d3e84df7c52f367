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
kernels' own backward kernels run (``kernels/ops``); an ssm or hybrid
model, whose ``ssd_scan`` has no backward kernel yet, is refused before
the step runs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.kernels import ops
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
        ll = logits.gather(-1, safe[..., None])[..., 0]
    else:
        raise ValueError(f"cross_entropy mode {mode!r}")
    mask = (labels != ignore).float()
    n = mask.sum().clamp(min=1.0)
    return ((logz - ll) * mask).sum() / n


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
        on ``device`` (CUDA unless the caller passes another)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return tf.init_params(gen, self.cfg, dtype=dtype)

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

    def check_trainable(self, device) -> None:
        """Raises the missing backward kernel's ``NotImplementedError`` where
        a train step on ``device`` would reach a kernel that has none: an
        ssm or hybrid model (``ssd_scan``) on the card."""
        if self.cfg.family in ("ssm", "hybrid") and \
                torch.device(device).type == "cuda" and \
                ops.kernel_mode() != "ref":
            raise ops.missing_backward("ssd_scan")

    def make_train_step(self, optimizer, n_micro: int = 1):
        """The train step with gradient accumulation over ``n_micro``
        micro-batches; params and optimizer state are updated in place
        (module docstring) and returned."""
        grads = {}                 # the fp32 gradient buffer, at first use

        def backward(leaves, batch):
            with torch.enable_grad():
                loss, _ = self.loss_fn(leaves, batch)
                loss.backward()
            return loss.detach()

        def train_step(params, opt_state, batch):
            self.check_trainable(tree_leaves(params)[0].device)
            if not grads:
                grads.update(tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params))
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
