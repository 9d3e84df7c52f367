"""Quickstart on the PyTorch/CUDA port: one Hydra runtime, many functions,
many languages-worth of architectures.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

It runs on the GPU unless ``--device cpu`` is given; with no GPU and no
``--device`` it raises rather than falling back to the CPU.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import HydraRuntime, LMSpec  # noqa: E402
from repro_torch.functions import catalog, example_args  # noqa: E402
from repro_torch.models.programs import ModelProgram  # noqa: E402

BUDGET = 4 << 30


def run(device, cfg, budget_bytes: int, params=None, *,
        catalog_params=None, beside=None) -> dict:
    """The quickstart's flow in one ``HydraRuntime`` on ``device``: two
    Table 1 functions, an LM of ``cfg`` (``params``, or the port's seeded
    init cast to bf16) generating 8 tokens from ``range(12)``, and the
    runtime's stats. ``catalog_params`` replaces the catalog's seeded
    params; ``beside`` ({fid: spec}) is registered first, in the same
    runtime. Returns what it prints, and the LM's registration and
    generate seconds."""
    # ONE runtime instance hosts every function (the paper's density story)
    rt = HydraRuntime(device=device, memory_budget_bytes=budget_bytes)
    try:
        for fid, spec in (beside or {}).items():
            rt.register_function(fid, spec, tenant=fid.split("/")[0])

        # 1. register a couple of classic serverless functions
        specs = catalog(rt.device, params=catalog_params)
        rt.register_function("tenantA/hash", specs["jv/filehashing"],
                             tenant="A")
        rt.register_function("tenantB/thumb", specs["py/thumbnail"],
                             tenant="B")

        out = rt.invoke("tenantA/hash", example_args(specs["jv/filehashing"]))
        hashed = {k: tuple(v.shape) for k, v in out.items()}
        print("filehashing ->", hashed)
        out = rt.invoke("tenantB/thumb", example_args(specs["py/thumbnail"]))
        thumb = tuple(out["thumb"].shape)
        print("thumbnail   ->", thumb)

        # 2. register an LM serving function (an assigned architecture)
        if params is None:
            params = ModelProgram(cfg).init(0, device=rt.device,
                                            dtype=torch.bfloat16)
        t0 = time.perf_counter()
        rt.register_function("tenantA/lm",
                             LMSpec(cfg=cfg, params=params, max_seq=64,
                                    slots=1), tenant="A")
        register_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        toks = rt.generate("tenantA/lm", list(range(12)), max_new_tokens=8)
        generate_s = time.perf_counter() - t0
        print("lm generate ->", toks)

        # 3. density accounting: cold vs warm, shared executables, arenas
        print("\nruntime stats:")
        s = rt.stats()
        print("  functions:", s["functions"])
        print("  exe cache:", s["exe_cache"])
        print("  arenas:   ", s["arena"])
        print("  budget:    %.1f / %.1f MB" % (s["budget_used"] / 2**20,
                                               rt.budget.capacity / 2**20))
        return dict(filehashing=hashed, thumbnail=thumb, tokens=toks,
                    stats=s, register_s=register_s, generate_s=generate_s)
    finally:
        rt.shutdown()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to run on (default cuda)")
    args = ap.parse_args(argv)
    return run(args.device, get_config("qwen2.5-3b").reduced(), BUDGET)


if __name__ == "__main__":
    main()
