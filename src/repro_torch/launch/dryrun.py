"""Multi-pod dry-run: count every (arch x shape x mesh) cell on the
``meta`` device: a port of ``repro/launch/dryrun.py``.

For each cell this:
  1. builds the production mesh (16x16 single-pod / 2x16x16 multi-pod) on
     the ``fake`` process group (``launch/mesh.make_fake_mesh``),
  2. derives parameter/cache/input shardings from the sharding policy and
     places ``meta`` tensors on them as DTensors: no allocation,
  3. runs the step once eagerly under ``launch/roofline.StepCounter``,
     which counts this rank's flops, bytes and collectives,
  4. records the peak of the live bytes it saw + the collective schedule,
  5. emits the roofline terms to a JSON file under
     ``experiments/dryrun_torch/``, apart from the reference's
     ``experiments/dryrun/`` so the two tables never mix.

Train cells count TWO programs: one gradient-accumulation microbatch
(forward + ``backward()``, scaled x n_micro in the roofline, the
gradients reduced onto their parameters' placements) and the port's
AdamW update. The port's layer loop is Python, so every count is exact
(``roofline_exact``); the reference must unroll its scans for that.

Where the port differs from the reference:
* The step runs under ``kernels.ops.set_kernel_mode("ref")`` (restored
  after): the hand-written kernels take CUDA tensors, and the dry-run
  counts work and runs nothing, as the reference's CPU dry-run lowers its
  oracles. Each record says ``"kernel_route": "plain"``.
* Plain tensors a model makes (positions, masks) join DTensors as
  replicated (``implicit_replication``).
* ``hbm_fit_bytes`` is the placed leaves' local bytes (params, and the
  optimizer state for train) plus the peak of the live bytes of what the
  counted ops wrote. XLA's ``memory_analysis`` plans buffer reuse and
  liveness over a compiled program; this follows eager PyTorch's
  allocation as the caching allocator would see it, op by op.
* ``roofline_frac`` divides by the H100's ``PEAK_BF16_FLOPS``.

Ops that DTensor cannot shard as written, and what the port does about
them (each shows up in the counts as the collectives it issues):
* the cross-entropy's gather of the label's logit from vocab-sharded
  logits: a ``local_map`` gathers from each rank's slice and leaves a
  partial sum (``models/programs._label_logit``), reduced by an
  all-reduce of (B, S);
* the embedding's rows from a vocab-sharded table: a masked partial
  sum, reduced at once by an all-reduce (``models/layers.embed_lookup``);
* the view of k and v into heads where the KV heads do not divide the
  model axis (qwen's 2, gemma3's 1 ...): ``launch/sharding
  .ReshardFallback`` all-gathers them over the model axis first, as the
  reference replicates those heads;
* decode's in-place write of the new KV row (``index_put_``) into a
  cache split by batch and sequence: the fallback replicates the cache
  for it, and the attention's local shards take a sequence-split cache
  whole (the port has no split softmax merge), so a decode cell's
  collectives are mostly these all-gathers of the cache and are not
  comparable with the reference's flash-decode layout;
* the attention and norms run on their exact shards (``kernels/ops``:
  rows, batch, heads), k and v repeated to one head per q head where q's
  heads are split and theirs cannot be.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import (SHAPES, ShapeConfig, applicable_shapes,
                                 get_config, list_archs)
from repro_torch.launch.mesh import (PEAK_BF16_FLOPS, make_fake_mesh,
                                     make_production_mesh, mesh_shape)
from repro_torch.launch.sharding import (NamedSharding, default_rules,
                                         named_sharding_tree, on_mesh, place,
                                         spec_placements, use_rules)
# the batch's shardings live beside the params' (the launcher reads them
# too), under the reference's names here
from repro_torch.launch.sharding import batch_axes  # noqa: F401
from repro_torch.launch.sharding import batch_sharding as _batch_sharding
from repro_torch.models.programs import ModelProgram, _grad_leaves
from repro_torch.optim import AdamW, constant
from repro_torch.optim.adamw import tree_leaves, tree_map

OUT = "experiments/dryrun_torch"


def n_micro_for(cfg, shape) -> int:
    """Gradient-accumulation depth: keep per-device microbatch ~1-4 seqs."""
    if shape.kind != "train":
        return 1
    if cfg.d_model >= 4096:
        return 16
    if cfg.d_model >= 2048:
        return 4
    return 1


def _cache_sharding(mesh, cache_specs, rules):
    """KV caches follow the same logical rules the model constraints use:
    batch on (pod,data); seq on rules.kv_seq; heads on rules.kv_heads."""
    sizes = mesh_shape(mesh)
    ba = tuple(a for a in rules.batch if a)
    nb = 1
    for a in ba:
        nb *= sizes[a]

    def _axes_size(ax):
        axes = ax if isinstance(ax, tuple) else (ax,)
        n = 1
        for a in axes:
            n *= sizes[a]
        return n

    def leaf(name, s):
        if name == "length":
            return NamedSharding(mesh, spec_placements(mesh, ()))
        # stacked caches: (L, B, ...) — shard batch if divisible
        dims = [None] * len(s.shape)
        if (len(s.shape) >= 2 and ba and s.shape[1] % nb == 0
                and s.shape[1] >= nb):
            dims[1] = ba
        if name in ("k", "v") and len(s.shape) == 5:
            if rules.kv_seq and s.shape[2] % _axes_size(rules.kv_seq) == 0:
                dims[2] = rules.kv_seq
            if rules.kv_heads and s.shape[3] % _axes_size(rules.kv_heads) == 0:
                dims[3] = rules.kv_heads
        return NamedSharding(mesh, spec_placements(mesh, tuple(dims)))
    return {name: leaf(name, s) for name, s in cache_specs.items()}


def _abstract_params(prog: ModelProgram, dtype=None):
    """The params' tree on ``meta`` (fp32 masters, or ``dtype``)."""
    return prog.init(0, device="meta", dtype=dtype or torch.float32)


def _meta(specs):
    """``TensorSpec`` stand-ins as ``meta`` tensors."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), specs)


def model_flops(cfg, shape) -> float:
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: 1 token/seq


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of a tree of DTensors (or tensors)."""
    from torch.distributed.tensor import DTensor
    return sum((t.to_local() if isinstance(t, DTensor) else t).nbytes
               for t in tree_leaves(tree))


def run_cell(arch: str, shape_name, *, multi_pod: bool = False,
             out_dir: str = OUT, verbose: bool = True,
             rules_override=None, tag: str = "",
             n_micro_override=None, cast_bf16: bool = False,
             grads_bf16: bool = False, ce_onehot: bool = False,
             mesh_axes=None, remat=None) -> dict:
    """Count one cell. ``shape_name`` names an entry of ``SHAPES`` or is
    a ``ShapeConfig``; ``mesh_axes`` ((sizes, names)) replaces the
    production mesh; ``remat`` (False, True or ``"dots"``, the reference's
    ``remat_dots``) overrides the train cells' full remat.
    The reference's ``unroll`` has no counterpart: the port's layer loop
    is Python, so every count is exact."""
    from repro_torch.kernels import ops

    cfg = get_config(arch)
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else SHAPES[shape_name])
    if mesh_axes is not None:
        mesh = make_fake_mesh(*mesh_axes)
        mesh_tag = "x".join(str(n) for n in mesh_axes[0])
    else:
        mesh = make_production_mesh(multi_pod=multi_pod)
        mesh_tag = "2x16x16" if multi_pod else "16x16"
    n_dev = mesh.size()
    if remat is None:
        remat = shape.kind == "train"
    prog = ModelProgram(cfg, remat=remat,
                        ce_mode="onehot" if ce_onehot else "gather")

    fsdp = shape.kind == "train" or cfg.serve_param_sharding == "fsdp"
    kv_seq = shape.name == "long_500k"
    rules = rules_override or default_rules(mesh, fsdp=fsdp, kv_seq=kv_seq)
    rules = dataclasses.replace(rules, mesh=mesh)
    if rules_override is None and shape.kind != "train":
        # KV-cache layout: shard heads over model when GQA heads divide the
        # TP degree; otherwise shard the cache SEQUENCE over model
        # (flash-decode style) — replicated caches do not fit HBM for
        # kv%16 != 0 archs at these shapes.
        sizes = mesh_shape(mesh)
        tp = sizes.get("model", 1)
        kv_heads = "model" if (cfg.n_kv_heads and cfg.n_kv_heads % tp == 0) \
            else None
        nd = 1
        for a in ("pod", "data"):
            nd *= sizes.get(a, 1)
        cache_gb_per_shard = prog.cache_bytes(
            shape.global_batch, shape.seq_len) / max(nd, 1) / 2**30
        # replicated-over-model caches are FINE when small (and required
        # for windowed local reads); shard S over model only to fit HBM
        need_seq = kv_heads is None and cache_gb_per_shard > 4.0
        seq_axes = tuple((["data"] if kv_seq else [])
                         + (["model"] if need_seq else []))
        rules = dataclasses.replace(
            rules, kv_heads=kv_heads,
            kv_seq=(seq_axes if seq_axes else None))

    record = {
        "arch": arch, "shape": shape.name,
        "mesh": mesh_tag,
        "kind": shape.kind, "n_devices": n_dev,
        "roofline_exact": True,
        "kernel_route": "plain",
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "model_flops": model_flops(cfg, shape),
        "tag": tag,
    }
    t0 = time.perf_counter()
    prev_mode = ops._mode_override
    ops.set_kernel_mode("ref")
    try:
        with use_rules(rules):
            if shape.kind == "train":
                record.update(_run_train(prog, cfg, shape, mesh, rules,
                                         n_micro_override, cast_bf16,
                                         grads_bf16))
            else:
                record.update(_run_serve(prog, cfg, shape, mesh, rules))
    finally:
        ops.set_kernel_mode(prev_mode)
    record["compile_s"] = time.perf_counter() - t0

    r = record["roofline"]
    total_flops = r["flops_per_device"] * n_dev
    record["useful_flops_frac"] = (record["model_flops"] / total_flops
                                   if total_flops else 0.0)
    record["roofline_frac"] = (
        (record["model_flops"] / n_dev / PEAK_BF16_FLOPS) / r["t_bound"]
        if r["t_bound"] else 0.0)

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        sfx = f"__{tag}" if tag else ""
        path = os.path.join(
            out_dir, f"{record['mesh']}__{arch}__{shape.name}{sfx}.json")
        with open(path, "w") as f:
            json.dump(record, f, indent=1, default=str)
    if verbose:
        print(f"[dryrun] {arch} x {shape.name} x {record['mesh']}: "
              f"bottleneck={r['bottleneck']} "
              f"t=(c {r['t_compute_s']:.4f}, m {r['t_memory_s']:.4f}, "
              f"n {r['t_collective_s']:.4f})s "
              f"useful={record['useful_flops_frac']:.2f} "
              f"roofline={record['roofline_frac']:.2f} "
              f"count={record['compile_s']:.0f}s", flush=True)
    return record


def _mem_stats(counter, args_bytes: int) -> dict:
    """The reference's memory fields from what the counter saw:
    arguments are the placed leaves' local bytes, temps the peak of the
    live bytes the counted ops wrote."""
    return {"argument_size_in_bytes": args_bytes,
            "temp_size_in_bytes": counter.counts.peak_live_bytes,
            "n_ops": counter.counts.ops}


def _run_train(prog, cfg, shape, mesh, rules, n_micro_override=None,
               cast_bf16: bool = False, grads_bf16: bool = False) -> dict:
    from repro_torch.launch.roofline import StepCounter, analyze
    n_micro = n_micro_override or n_micro_for(cfg, shape)
    micro_b = shape.global_batch // n_micro
    micro_shape = dataclasses.replace(shape, global_batch=micro_b)

    params_abs = _abstract_params(prog)                 # fp32 masters
    params = place(params_abs, named_sharding_tree(params_abs, rules, cfg))
    del params_abs
    batch_abs = prog.input_specs(micro_shape)
    batch = place(_meta(batch_abs), _batch_sharding(mesh, batch_abs))
    # the train step's fp32 gradient buffer, on the params' placements;
    # with grads_bf16 the backward writes a bf16 one
    grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)

    def cast(p):
        # cast fp32 masters to bf16 while still SHARDED, so FSDP
        # all-gathers move bf16 (half the wire bytes); a stacked leaf of
        # the train step's tree is a list of its layers' slices
        if isinstance(p, dict):
            return {k: cast(v) for k, v in p.items()}
        if isinstance(p, list):
            return [cast(v) for v in p]
        return p.to(torch.bfloat16) if p.dtype == torch.float32 else p

    # one micro step as the port's train step runs it: each layer's slice
    # a leaf whose .grad is its view of the buffer, which the backward
    # accumulates into (reduced onto the params' placements as it lands)
    micro = StepCounter()
    with micro, on_mesh():
        if grads_bf16:
            # differentiate wrt the bf16 copies: gradient reduce-scatters
            # move bf16 on the wire; fp32 accumulation happens outside
            pb = cast(params)              # not leaves: cast_bf16 is set
            gb = tree_map(torch.zeros_like, pb)
            loss, _ = prog.loss_fn(_grad_leaves(pb, gb), batch)
            loss.backward()
            tree_map(lambda g, b: g.add_(b), grads, gb)
            del gb, pb
        else:
            leaves = _grad_leaves(params, grads)
            loss, _ = prog.loss_fn(cast(leaves) if cast_bf16 else leaves,
                                   batch)
            loss.backward()
            del leaves
    micro_mem = _mem_stats(micro, _local_bytes(params) + _local_bytes(grads))
    roof_micro = analyze(micro.counts, mesh.size(), scale=n_micro)

    # optimizer apply (runs once per step, with the buffer's zeroing)
    opt = AdamW(lr=constant(3e-4))
    opt_state = opt.init(params)
    apply = StepCounter()
    with apply, on_mesh():
        opt.update(grads, opt_state, params)
        for g in tree_leaves(grads):
            g.zero_()
    state_bytes = (_local_bytes(params) + _local_bytes(grads)
                   + _local_bytes(opt_state))
    apply_mem = _mem_stats(apply, state_bytes)
    roof_apply = analyze(apply.counts, mesh.size())

    combined = dataclasses.replace(
        roof_micro,
        flops_per_device=roof_micro.flops_per_device
        + roof_apply.flops_per_device,
        bytes_per_device=roof_micro.bytes_per_device
        + roof_apply.bytes_per_device,
        raw_bytes_per_device=roof_micro.raw_bytes_per_device
        + roof_apply.raw_bytes_per_device,
        wire_bytes_per_device=roof_micro.wire_bytes_per_device
        + roof_apply.wire_bytes_per_device,
    )
    summary = combined.summary()
    summary["t_bound"] = combined.t_bound
    return {
        "n_micro": n_micro,
        "memory": {"micro_step": micro_mem, "apply_step": apply_mem},
        # params, grads and optimizer state, plus the larger of the two
        # steps' live temporaries
        "hbm_fit_bytes": state_bytes + max(micro_mem["temp_size_in_bytes"],
                                           apply_mem["temp_size_in_bytes"]),
        "roofline": summary,
    }


def _run_serve(prog, cfg, shape, mesh, rules) -> dict:
    from repro_torch.device import torch_dtype
    from repro_torch.launch.roofline import StepCounter, analyze
    dt = torch_dtype(cfg.dtype)
    params_abs = _abstract_params(prog, dtype=dt)       # bf16 serving weights
    params = place(params_abs, named_sharding_tree(params_abs, rules, cfg))
    del params_abs
    batch_abs = prog.input_specs(shape)
    batch = place(_meta(batch_abs), _batch_sharding(mesh, batch_abs))
    args_bytes = _local_bytes(params)
    counter = StepCounter()
    if shape.kind == "prefill":
        with torch.no_grad(), counter, on_mesh():
            prog.prefill(params, batch)
    else:
        cache_abs = prog.cache_specs(shape.global_batch, shape.seq_len)
        cache = place(_meta(cache_abs),
                      _cache_sharding(mesh, cache_abs, rules))
        args_bytes += _local_bytes(cache)
        with torch.no_grad(), counter, on_mesh():
            prog.decode_step(params, cache, batch)
    mem = _mem_stats(counter, args_bytes)
    roof = analyze(counter.counts, mesh.size())
    summary = roof.summary()
    summary["t_bound"] = roof.t_bound
    return {
        "memory": {"step": mem},
        "hbm_fit_bytes": args_bytes + mem["temp_size_in_bytes"],
        "roofline": summary,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="model architecture to dry-run (see --all)")
    ap.add_argument("--shape", default=None,
                    help="input shape name to dry-run (see SHAPES)")
    ap.add_argument("--all", action="store_true",
                    help="dry-run every arch x applicable shape")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the multi-pod (2x16x16) mesh")
    ap.add_argument("--both-meshes", action="store_true",
                    help="emit both the 16x16 and the 2x16x16 mesh per cell")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip cells whose output JSON already exists")
    ap.add_argument("--out", default=OUT,
                    help="output directory for per-cell JSON reports")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in list_archs():
            for shape in applicable_shapes(get_config(arch)):
                cells.append((arch, shape.name))
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    failures = []
    for multi_pod in meshes:
        for arch, shape in cells:
            mesh_tag = "2x16x16" if multi_pod else "16x16"
            path = os.path.join(args.out, f"{mesh_tag}__{arch}__{shape}.json")
            if args.skip_existing and os.path.exists(path):
                print(f"[dryrun] skip {arch} x {shape} x {mesh_tag}")
                continue
            try:
                run_cell(arch, shape, multi_pod=multi_pod, out_dir=args.out)
            except Exception as e:    # a failed cell is reported; the rest run
                failures.append((arch, shape, mesh_tag, repr(e)))
                print(f"[dryrun] FAIL {arch} x {shape} x {mesh_tag}: {e}")
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nALL DRY-RUN CELLS PASSED")


if __name__ == "__main__":
    main()
