"""Serving: a model registered as an ``LMSpec`` in a ``HydraRuntime``, its
requests driven through ``ContinuousBatcher`` (``submit`` then ``step``,
which admits and prefills into the arena slab, then decodes every slot
through the cache), under the closed loop of ``generator``'s callers.

Set-up: the kernels built or loaded, the weights made on the card from
the seed (bf16, the type they are served in), the function registered,
one warm request at each of the shortest, middle and longest prompt
lengths of the mix, and the callers' first wave run to its end, so the
window opens on a loop in its steady state.

The window runs whole steps from its start until ``seconds`` have passed;
it ends with the last step. A request's send is when its caller sent it;
it is admitted at the end of the step that prefilled it and done at the
end of the step that gave its last token. After the window the requests
in flight are served to their end, and a sample of the requests finished
in the window, drawn from the seed with the longest among them, goes to
the plain reference: for each served token, how far its logit lies below
the reference's best at that position.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from portbench import generator, weights
from portbench.program import (arch_config, build_kernels, host_delta,
                               host_sample, peak_bytes, release, settle,
                               sync)
from portbench.record import Record
from portbench.trace import DeviceTrace

DRAIN_S = 60.0


class Loop:
    """The requests in flight through one ``ContinuousBatcher``."""

    def __init__(self, batcher, requests, clock):
        self.b, self.reqs, self.clock = batcher, requests, clock
        self.next_rid = 0
        self.inflight: list = []            # records, in submit order
        self.waiting = collections.deque()  # not admitted yet, FIFO
        self.records: list = []

    def send(self, t: float) -> dict:
        r = self.reqs.get(self.next_rid)
        self.next_rid += 1
        rec = dict(rid=r.rid, prompt=len(r.prompt), n_out=r.n_out, send=t,
                   admitted=None, done=None, emitted=0, tokens=None,
                   ids=r.prompt,
                   fut=self.b.submit(r.prompt.tolist(), r.n_out))
        self.inflight.append(rec)
        self.waiting.append(rec)
        self.records.append(rec)
        return rec

    def step(self) -> tuple:
        """One ``ContinuousBatcher.step()``: (step record, records done)."""
        decoding = [r for r in self.inflight if r["admitted"] is not None]
        before = len(self.b.pending)
        t0 = self.clock()
        self.b.step()
        t1 = self.clock()
        admitted = [self.waiting.popleft()
                    for _ in range(before - len(self.b.pending))]
        for r in admitted:
            r["admitted"], r["emitted"] = t1, 1
        decoding += admitted
        ctx = [r["prompt"] + r["emitted"] for r in decoding]
        for r in decoding:
            r["emitted"] += 1
        done = [r for r in decoding if r["fut"].done()]
        for r in done:
            r["done"], r["tokens"] = t1, list(r["fut"].result())
            self.inflight.remove(r)
        step = dict(t0=t0, t1=t1, admitted=[r["prompt"] for r in admitted],
                    prefill_tokens=sum(r["prompt"] for r in admitted),
                    gen=len(admitted) + len(decoding), ctx=ctx)
        return step, done


def _warm_prompt(seed: int, n: int, vocab: int) -> list:
    rng = np.random.default_rng([seed, 6, n])
    return rng.integers(0, vocab, n).tolist()


def run(ctx) -> Record:
    from repro_torch.core.registry import LMSpec
    from repro_torch.core.runtime import HydraRuntime
    from repro_torch.core.scheduler import ContinuousBatcher

    cfg, mix, dev, clock = ctx.cfg, ctx.mix, ctx.device, time.perf_counter
    rec = Record(cfg=cfg, mix=mix, registry=ctx.registry)
    parts = rec.setup_parts
    t = clock()
    parts["start_and_imports"] = t - ctx.t_start

    def part(name):
        nonlocal t
        now = clock()
        parts[name] = now - t
        t = now

    build_kernels(dev)
    part("kernels")
    params = weights.make(ctx.registry, cfg, ctx.seed, torch.bfloat16,
                          dev)
    sync(dev)
    part("weights")
    rt = HydraRuntime(device=dev, n_workers=0, janitor=False,
                      memory_budget_bytes=1 << 50)
    rt.register_function("fn", LMSpec(cfg=arch_config(cfg), params=params,
                                      max_seq=mix["max_seq"],
                                      slots=mix["slots"]))
    b = ContinuousBatcher(rt, "fn")
    part("register")
    reqs = generator.Requests(mix, ctx.seed, cfg["vocab_size"])
    grid = reqs.lengths()
    for n in sorted({grid[0], grid[len(grid) // 2], grid[-1]}):
        b.submit(_warm_prompt(ctx.seed, n, cfg["vocab_size"]), 2)
        b.run_until_done()
    sync(dev)
    part("warm")
    loop = Loop(b, reqs, clock)
    first = [loop.send(clock()) for _ in range(mix["callers"])]
    while any(r["done"] is None for r in first):
        _, done = loop.step()
        for r in done:
            loop.send(r["done"])
    part("first_wave")
    settle()
    trace = DeviceTrace(ctx.trace, dev)
    trace.start()
    rec.setup_s = clock() - ctx.t_start

    h0 = host_sample()
    t0 = clock()
    deadline = t0 + ctx.seconds
    steps = []
    while clock() < deadline:
        step, done = loop.step()
        steps.append(step)
        for r in done:
            loop.send(r["done"])
    t1 = clock()
    rec.host = host_delta(h0, host_sample())
    trace.stop()
    rec.t0, rec.t1, rec.steps = t0, t1, steps
    rec.kernels = trace.kernels
    rec.spans = [(s["t0"], s["t1"],
                  "admit_steps" if s["admitted"] else "decode_steps")
                 for s in steps]
    rec.peak_mem_bytes = peak_bytes(dev)

    give_up = clock() + DRAIN_S
    while loop.inflight and clock() < give_up:
        loop.step()
    in_window = [r for r in loop.records if t0 <= r["send"] <= t1
                 or (r["done"] is not None and t0 < r["done"] <= t1)]
    rec.requests = [{k: r[k] for k in ("rid", "send", "admitted", "done",
                                       "prompt", "n_out")}
                    for r in in_window]
    rec.attempted = len(in_window)
    wrong = [r for r in in_window if r["tokens"] is None
             or len(r["tokens"]) != r["n_out"]
             or not all(0 <= x < cfg["vocab_size"] for x in r["tokens"])]
    rec.failed = len(wrong)
    bad = {r["rid"] for r in wrong}
    finished = [r for r in in_window if r["rid"] not in bad
                and r["done"] <= t1]
    sample = choose_sample(finished, ctx.seed, mix["check"]["tokens"])
    b.close()
    rt.shutdown()
    del b, rt
    release(dev)
    t_check = clock()
    gap = token_gaps(ctx.registry, cfg, params, sample, dev)
    rec.check_s = clock() - t_check
    rec.extra = {"sample": sample}
    lim = ctx.limits["numbers"]
    rec.checks = {
        "token_gap": {"value": gap, "limit": lim["token_gap"]["limit"]},
        "wrong_replies": {"value": len(wrong), "limit": 0},
        "sample_tokens_short": {
            "value": max(0, mix["check"]["tokens"]
                         - sum(r["n_out"] for r in sample)), "limit": 0},
    }
    return rec


def choose_sample(finished: list, seed: int, tokens: int) -> list:
    """The longest finished request, then others in an order drawn from
    the seed, until they hold ``tokens`` served tokens."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: (r["prompt"] + r["n_out"],
                                           r["rid"]))
    rest = [r for r in finished if r is not longest]
    order = np.random.default_rng([seed, 5]).permutation(len(rest))
    out = [longest]
    for i in order:
        if sum(r["n_out"] for r in out) >= tokens:
            break
        out.append(rest[i])
    return out


def reference_logits(registry, cfg, params, r, device, precision="fp32"):
    """The reference's float32 logits at the positions that chose each of
    ``r``'s served tokens: the prompt and the served tokens but the last,
    as one sequence."""
    from portbench.reference.layers import fp32_mode
    model = registry.reference(cfg)
    seq = np.concatenate([r["ids"], np.asarray(r["tokens"][:-1], np.int32)])
    toks = torch.as_tensor(seq, device=device)[None]
    rows = slice(r["prompt"] - 1, r["prompt"] - 1 + r["n_out"])
    with torch.no_grad(), fp32_mode():
        return model.logits(params, cfg, toks, rows=rows,
                            precision=precision)[0]


def gaps_of(logits: torch.Tensor, chosen) -> torch.Tensor:
    """How far each chosen token's logit lies below the row's best."""
    idx = torch.as_tensor(chosen, device=logits.device).long()[:, None]
    return logits.max(-1).values - logits.gather(-1, idx)[:, 0]


def token_gaps(registry, cfg, params, sample, device) -> float:
    """The widest gap of a served token below the reference's best, over
    every token of the sample (inf when the sample is empty)."""
    worst = float("inf") if not sample else 0.0
    for r in sample:
        lg = reference_logits(registry, cfg, params, r, device)
        worst = max(worst, float(gaps_of(lg, r["tokens"]).max()))
        del lg
    return worst
