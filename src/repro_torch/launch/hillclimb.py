"""Hillclimbing driver: runs tagged variants of the three chosen cells
through the port's dry-run and prints the roofline terms per iteration:
a port of ``benchmarks/hillclimb.py``, writing under
``experiments/hillclimb_torch/``.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell qwen_train --it 1
"""
from __future__ import annotations

import argparse
import dataclasses
import json

OUT = "experiments/hillclimb_torch"


def _fsdp256(mesh):
    """Pure FSDP/DP over all 256 ranks, no TP."""
    from repro_torch.launch.sharding import default_rules
    return dataclasses.replace(
        default_rules(mesh, fsdp=True),
        batch=("data", "model"), fsdp=("data", "model"),
        heads=None, ff=None, vocab=None, experts=None)


def run(cell: str, iteration: int):
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.sharding import default_rules

    mesh = make_production_mesh()

    if cell == "qwen_train":
        if iteration == 1:
            # H1: TP-16 activation all-reduces dominate. Pure FSDP/DP-256
            # (no TP) removes them; params gather instead.
            # B=256 global over 256-way DP -> 1 seq/device, n_micro=1
            return run_cell("qwen2.5-3b", "train_4k",
                            rules_override=_fsdp256(mesh),
                            tag="hc1_fsdp256", n_micro_override=1,
                            out_dir=OUT)
        if iteration == 2:
            # H2: fp32 param gathers waste 2x wire; cast to bf16 pre-gather.
            return run_cell("qwen2.5-3b", "train_4k",
                            rules_override=_fsdp256(mesh),
                            tag="hc2_fsdp256_bf16", cast_bf16=True,
                            n_micro_override=1, out_dir=OUT)
        if iteration == 3:
            # H3: gradient reduce-scatters still move fp32; differentiate
            # wrt bf16 params so grad collectives are bf16.
            return run_cell("qwen2.5-3b", "train_4k",
                            rules_override=_fsdp256(mesh),
                            tag="hc3_fsdp256_bf16grads", cast_bf16=True,
                            grads_bf16=True, n_micro_override=1,
                            out_dir=OUT)
        if iteration == 4:
            # H4: full remat recomputes every matmul in the backward;
            # saving the matmul outputs cuts that compute.
            return run_cell("qwen2.5-3b", "train_4k",
                            rules_override=_fsdp256(mesh),
                            tag="hc4_fsdp256_dots", cast_bf16=True,
                            grads_bf16=True, n_micro_override=1,
                            remat="dots", out_dir=OUT)
        if iteration == 5:
            # H5: the CE gather over vocab-parallel logits; one-hot
            # contraction keeps it local (+tiny psum).
            return run_cell("qwen2.5-3b", "train_4k",
                            rules_override=_fsdp256(mesh),
                            tag="hc5_fsdp256_onehot_ce", cast_bf16=True,
                            grads_bf16=True, n_micro_override=1,
                            remat="dots", ce_onehot=True, out_dir=OUT)

    if cell == "dbrx_decode":
        if iteration == 1:
            # H1: per-step FSDP weight gathers dominate decode. 2D expert
            # sharding (E over model, F over data) keeps every weight
            # resident and local; only small activation reduces remain.
            rules = dataclasses.replace(
                default_rules(mesh, fsdp=True),
                fsdp="data", moe_ff="data", kv_seq=("model",))
            return run_cell("dbrx-132b", "decode_32k", rules_override=rules,
                            tag="hc1_2dep", out_dir=OUT)
        if iteration == 2:
            # H2: the remaining wire is FSDP gathers of attn/embed params;
            # TP already shards them 16-way over `model`, so drop fsdp.
            rules = dataclasses.replace(
                default_rules(mesh, fsdp=False), moe_ff="data",
                kv_seq=("model",))
            return run_cell("dbrx-132b", "decode_32k", rules_override=rules,
                            tag="hc2_2dep_tponly", out_dir=OUT)
        if iteration == 3:
            # H3: same as H2 + KV cache sequence sharded over `model`
            # (flash-decode): sharding S also parallelizes the reads.
            rules = dataclasses.replace(
                default_rules(mesh, fsdp=False), moe_ff="data",
                kv_seq=("model",))
            return run_cell("dbrx-132b", "decode_32k", rules_override=rules,
                            tag="hc3_2dep_tponly_kvseq", out_dir=OUT)

    if cell == "gemma_decode":
        if iteration == 0:
            # BEFORE: every layer global, so decode reads the full 32k
            # cache in every layer (windows applied after the fact)
            import repro_torch.configs.gemma3_1b as G
            cfg = G.CONFIG
            G.CONFIG = dataclasses.replace(cfg, sliding_window=None,
                                           global_every=None)
            try:
                return run_cell("gemma3-1b", "decode_32k",
                                tag="hc0_fullreads", out_dir=OUT)
            finally:
                G.CONFIG = cfg
        if iteration == 1:
            # H1: windowed layers (local layers attend to 512 of 32768)
            return run_cell("gemma3-1b", "decode_32k", tag="hc1_windowed",
                            out_dir=OUT)

    raise SystemExit(f"unknown cell/iteration {cell}/{iteration}")


def bonus_gemma_train():
    """Bonus cell: gemma3-1b train, whose 262k vocab makes the CE gather
    over vocab-parallel logits its largest collective; one-hot CE."""
    from repro_torch.launch.dryrun import run_cell
    return run_cell("gemma3-1b", "train_4k", ce_onehot=True,
                    tag="bonus_onehot_ce", out_dir=OUT)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True,
                    help="hillclimb cell name (arch/mesh pair) to run")
    ap.add_argument("--it", type=int, required=True,
                    help="iteration index within the cell's schedule")
    args = ap.parse_args(argv)
    rec = run(args.cell, args.it)
    r = rec["roofline"]
    print(json.dumps({k: r[k] for k in
                      ("t_compute_s", "t_memory_s", "t_collective_s",
                       "bottleneck")}, indent=1))
    return rec


if __name__ == "__main__":
    main()
