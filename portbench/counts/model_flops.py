"""Model flops of the ``ssm`` family, from a configuration's sizes: 2
flops a multiply-add of every weight a token passes through (the conv
taps, the output head where logits are taken; not the embedding, which is
a lookup), plus the SSD scan's products.

  applied_params(cfg): weights one token passes through in the body
  prefill(cfg, S): one prompt of S positions, logits of the last one
  decode(cfg, ctx): one generated token whose position sees ``ctx`` keys
    (the same for any ``ctx``: the state does not grow with the context)
"""
from __future__ import annotations

from portbench.counts import ssd_scan


def _sizes(cfg: dict) -> tuple:
    D = cfg["d_model"]
    din = cfg["ssm_expand"] * D
    N, P = cfg["ssm_state"], cfg["ssm_head_dim"]
    return D, din, N, P, din // P


def applied_params(cfg: dict) -> int:
    D, din, N, P, H = _sizes(cfg)
    mamba = D * (2 * din + 2 * N + H) + cfg["ssm_conv"] * (din + 2 * N) \
        + din * D
    return cfg["n_layers"] * mamba


def head_params(cfg: dict) -> int:
    return cfg["d_model"] * cfg["vocab_size"]


def prefill(cfg: dict, S: int) -> float:
    D, din, N, P, H = _sizes(cfg)
    chunk = min(cfg["ssm_chunk"], S)
    scan = ssd_scan.cost(1, S, H, P, N, chunk)[1] * cfg["n_layers"]
    return 2.0 * applied_params(cfg) * S + 2.0 * head_params(cfg) + scan


def decode(cfg: dict, ctx: int) -> float:
    D, din, N, P, H = _sizes(cfg)
    scan = 4.0 * H * P * N * cfg["n_layers"]      # state update and read
    return 2.0 * (applied_params(cfg) + head_params(cfg)) + scan
