"""repro_torch runtime behaviour: the port's counterparts of
tests/test_runtime.py (registration, invocation, code-cache sharing, slab
arenas, budgets, generate, continuous batching), greedy-token parity with
the reference runtime on converted weights, and a serve smoke. All on the
CPU, which the tests ask for explicitly (``device="cpu"``).
"""
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import HydraRuntime as JRuntime
from repro.core import LMSpec as JLMSpec
from repro.models.programs import ModelProgram as JProgram
from port_tests import bind, port_tests
from repro_torch.configs import get_config
from repro_torch.core import (CallableSpec, ContinuousBatcher, ExecutableCache,
                              FunctionNotRegisteredError, HydraOOMError,
                              HydraRuntime, LMSpec, MemoryBudget, TokenBucket)
from repro_torch.core.arena import ArenaPool
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.programs import ModelProgram


def make_rt(**kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("memory_budget_bytes", 1 << 30)
    kw.setdefault("janitor", False)
    return HydraRuntime(**kw)


def simple_spec(name="affine"):
    def fn(params, args):
        return {"y": args["x"] * params["w"] + 1.0}
    return CallableSpec(name=name, fn=fn,
                        example_args={"x": torch.ones(64)},
                        params={"w": torch.full((64,), 2.0)})


def lm_spec(slots=1, max_seq=64, seed=0, dtype=None):
    cfg = get_config("qwen2.5-3b").reduced()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    params = ModelProgram(cfg).init(seed, device="cpu",
                                    dtype=torch.bfloat16 if dtype is None
                                    else torch.float32)
    return LMSpec(cfg=cfg, params=params, max_seq=max_seq, slots=slots)


# ---------------------------------------------------------------------------
def test_runtime_without_gpu_or_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        HydraRuntime(janitor=False)
    with pytest.raises(RuntimeError):
        HydraRuntime(device="cuda", janitor=False)
    with pytest.raises(RuntimeError):
        ModelProgram(get_config("qwen2.5-3b").reduced()).init(0)


def test_register_invoke_deregister():
    rt = make_rt()
    try:
        assert rt.register_function("f1", simple_spec())
        out = rt.invoke("f1", {"x": torch.full((64,), 3.0)})
        assert float(out["y"][0]) == 7.0
        assert not rt.register_function("f1", simple_spec())   # duplicate
        assert rt.deregister_function("f1")
        with pytest.raises(FunctionNotRegisteredError):
            rt.invoke("f1", {"x": torch.ones(64)})
        assert not rt.deregister_function("f1")
    finally:
        rt.shutdown()


def test_executable_cache_shared_across_tenants():
    """Two tenants registering the same program build it ONCE. The
    reference holds 2 entries here (program + arena zeroer); the port's
    scrub is an in-place zero_() with no program, so it holds 1."""
    rt = make_rt()
    try:
        rt.register_function("a/f", simple_spec(), tenant="a")
        rt.register_function("b/f", simple_spec(), tenant="b")
        stats = rt.exe_cache.stats()
        assert stats["entries"] == 1
        assert stats["hits"] == 1
        assert stats["compiles"] == 1
    finally:
        rt.shutdown()


def test_executable_cache_unshared_baseline():
    """shared=False builds per fid: 2 program entries (the reference's 3
    include its always-shared arena zeroer, which the port has no need of)."""
    rt = make_rt(executable_cache=ExecutableCache(shared=False))
    try:
        rt.register_function("a/f", simple_spec(), tenant="a")
        rt.register_function("b/f", simple_spec(), tenant="b")
        assert rt.exe_cache.stats()["entries"] == 2
    finally:
        rt.shutdown()


def test_executable_cache_persistence_not_ported(tmp_path):
    """jax's persistent compilation cache has no counterpart; program
    records under ``persist_dir`` are ported (tests/test_torch_platform.py
    and tests/test_torch_cross_process.py hold their contract)."""
    with pytest.raises(NotImplementedError):
        ExecutableCache(xla_cache_dir="/nonexistent")
    cache = ExecutableCache(persist_dir=str(tmp_path / "exe"))
    assert (tmp_path / "exe").is_dir()
    assert cache.stats()["xla_cache_enabled"] is False


def test_lm_programs_shared_across_tenants():
    rt = make_rt()
    try:
        rt.register_function("a/lm", lm_spec(seed=0))
        rt.register_function("b/lm", lm_spec(seed=1))
        assert rt.exe_cache.stats()["entries"] == 1     # one decode program
        a = rt.generate("a/lm", list(range(6)), max_new_tokens=3)
        b = rt.generate("b/lm", list(range(6)), max_new_tokens=3)
        # one shared prefill program per prompt length
        assert rt.exe_cache.stats()["entries"] == 2
        assert len(a) == len(b) == 3
    finally:
        rt.shutdown()


def test_slab_isolation_cross_owner_zeroed_same_owner_donated():
    pool = ArenaPool(ttl_s=1e9)
    sig = ("slab", 4096)
    buf_storage = []

    def factory():
        t = torch.zeros(1024)
        buf_storage.append(t.data_ptr())
        return {"buf": t}

    pool.register_signature(sig, factory)
    a = pool.acquire(sig, owner="fn-a")
    try:
        a.buffers["buf"].add_(7.0)                   # fn-a dirties the slab
    finally:
        pool.release(a)

    b = pool.acquire(sig, owner="fn-a")              # donor reclaims it
    assert b is a
    assert float(b.buffers["buf"][0]) == 7.0         # contents preserved
    pool.release(b)

    c = pool.acquire(sig, owner="fn-b")              # cross-owner handover
    try:
        assert c is a
        assert float(c.buffers["buf"].abs().max()) == 0.0        # scrubbed
        assert c.buffers["buf"].data_ptr() == buf_storage[0]     # in place
    finally:
        pool.release(c)

    counters = pool.metrics.counters
    assert counters["arena.cold"] == 1
    assert counters["arena.reuse"] == 1
    assert counters["arena.zeroed"] == 1


def test_prealloc_pretouches_slabs_off_the_clock():
    pool = ArenaPool(ttl_s=1e9)
    calls = []

    def factory():
        calls.append(1)
        return {"buf": torch.zeros(256)}

    pool.prealloc(("sig",), factory, 3, owner="fn")
    assert len(calls) == 3
    assert pool.idle_count == 3
    cold = pool.metrics.counters["arena.cold"]
    reuse = pool.metrics.counters.get("arena.reuse", 0)
    arenas = [pool.acquire(("sig",), owner="fn") for _ in range(3)]
    assert len(calls) == 3
    assert pool.metrics.counters["arena.cold"] == cold
    assert pool.metrics.counters["arena.reuse"] == reuse + 3
    for a in arenas:
        pool.release(a)


def test_shutdown_does_not_wait_out_the_janitor_period():
    """A platform shuts an emptied runtime down inline (evict, migrate):
    the janitor wakes on shutdown instead of finishing its 1 s sleep."""
    rt = make_rt(janitor=True, arena_ttl_s=10.0)     # janitor period 1 s
    t0 = time.perf_counter()
    rt.shutdown()
    assert time.perf_counter() - t0 < 0.6
    assert not rt._janitor.is_alive()


def test_arena_pool_warm_and_ttl():
    pool = ArenaPool(ttl_s=0.2)
    factory = lambda: {"buf": torch.zeros(1024)}
    a = pool.acquire(("sig",), factory)
    pool.release(a)
    b = pool.acquire(("sig",), factory)
    assert b is a
    pool.release(b)
    assert pool.metrics.counters["arena.warm"] == 1
    assert a.nbytes == 4096
    time.sleep(0.3)
    assert pool.evict_idle() == a.nbytes
    assert pool.idle_count == 0
    assert pool.metrics.counters["arena.evicted"] == 1


def test_budget_oom():
    b = MemoryBudget(1000)
    b.reserve(800)
    with pytest.raises(HydraOOMError):
        b.reserve(300)
    b.release(500)
    b.reserve(300)
    assert b.used == 600
    assert b.peak == 800


def test_runtime_budget_admission():
    rt = make_rt(memory_budget_bytes=4 << 20)
    try:
        with pytest.raises(HydraOOMError):
            rt.register_function("big", simple_spec(), mem_budget=16 << 20)
    finally:
        rt.shutdown()


def test_lm_registration_reserves_params_and_cache():
    rt = make_rt()
    try:
        spec = lm_spec(slots=2, max_seq=32)
        rt.register_function("lm", spec)
        prog = ModelProgram(spec.cfg)
        params = sum(t.numel() * t.element_size() for t in (
            jax.tree.leaves(spec.params)))
        assert rt.budget.used == params + prog.cache_bytes(2, 32)
    finally:
        rt.shutdown()


def test_lm_generate_deterministic_and_warm():
    rt = make_rt()
    try:
        rt.register_function("lm", lm_spec())
        t1 = rt.generate("lm", list(range(8)), max_new_tokens=6)
        cold = rt.metrics.counters["arena.cold"]
        t2 = rt.generate("lm", list(range(8)), max_new_tokens=6)
        assert t1 == t2
        assert rt.metrics.counters["arena.cold"] == cold
        assert rt.metrics.counters["arena.warm"] >= 1
    finally:
        rt.shutdown()


def test_prompt_longer_than_max_seq_raises():
    rt = make_rt()
    try:
        rt.register_function("lm", lm_spec(max_seq=8))
        with pytest.raises(ValueError, match="max_seq"):
            rt.generate("lm", list(range(9)), max_new_tokens=2)
    finally:
        rt.shutdown()


def test_continuous_batcher_matches_single_path():
    rt = make_rt()
    try:
        rt.register_function("lm", lm_spec(slots=3))
        single = rt.generate("lm", list(range(8)), max_new_tokens=5)
        b = ContinuousBatcher(rt, "lm")
        futs = [b.submit(list(range(8)), 5) for _ in range(5)]
        b.run_until_done()
        outs = [f.result() for f in futs]
        assert all(o == single for o in outs)
        assert b.steps < 5 * 5           # 5 requests over 3 slots share steps
        b.close()
    finally:
        rt.shutdown()


def test_batcher_free_slots_decode_past_max_seq():
    """Free slots keep decoding (as in the reference), so their length runs
    past max_seq; the clamped cache write keeps that harmless."""
    rt = make_rt()
    try:
        rt.register_function("lm", lm_spec(slots=2, max_seq=12))
        single = rt.generate("lm", [5, 6, 7], max_new_tokens=4)
        b = ContinuousBatcher(rt, "lm")
        long_fut = b.submit([1, 2, 3, 4], 8)      # slot 0 reaches 12 rows
        b.run_until_done()
        fut = b.submit([5, 6, 7], 4)
        b.run_until_done()                 # slot 1's length is now > 12
        assert int(b.cache["length"].max()) > 12
        assert len(long_fut.result()) == 8
        assert fut.result() == single
        b.close()
    finally:
        rt.shutdown()


def test_invoke_latency_metrics_populated():
    rt = make_rt()
    try:
        rt.register_function("f", simple_spec())
        for _ in range(5):
            rt.invoke("f", {"x": torch.ones(64)})
        snap = rt.metrics.snapshot()
        assert snap["hists"]["invoke_latency_s"]["count"] == 5
        assert snap["hists"]["register_s"]["count"] == 1
    finally:
        rt.shutdown()


def test_token_bucket_burst_then_empty():
    tb = TokenBucket(rate=0.0, burst=5.0)
    assert [tb.try_take() for _ in range(8)] == [True] * 5 + [False] * 3


# the reference's TokenBucket tests (tests/test_scheduler.py), run against
# the port's copy: the gateway's admission control rests on the bucket.
# The batcher tests there need the reference's lm_runtime fixture.
bind(globals(), port_tests("test_scheduler", include=(
    "test_burst_then_empty", "test_refill_caps_at_burst",
    "test_fractional_take_and_refill_rate",
    "test_contention_grants_exactly_burst_with_no_refill",
    "test_contention_with_refill_never_exceeds_budget")))


# ---------------------------------------------------------------------------
def test_generate_tokens_equal_reference_runtime():
    """Greedy tokens from the port's runtime equal the reference runtime's
    on the same (converted) weights, fp32 config."""
    jcfg = dataclasses.replace(jget_config("qwen2.5-3b").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                               dtype="float32")
    jparams = JProgram(jcfg).init(jax.random.PRNGKey(7))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    prompt = np.random.default_rng(7).integers(0, 256, 10).tolist()
    jrt = JRuntime(memory_budget_bytes=1 << 30, janitor=False)
    try:
        jrt.register_function("lm", JLMSpec(cfg=jcfg, params=jparams,
                                            max_seq=32, slots=2))
        want = jrt.generate("lm", prompt, max_new_tokens=8)
    finally:
        jrt.shutdown()
    rt = make_rt()
    try:
        rt.register_function("lm", LMSpec(cfg=tcfg, params=tparams,
                                          max_seq=32, slots=2))
        got = rt.generate("lm", prompt, max_new_tokens=8)
    finally:
        rt.shutdown()
    assert got == want


# ---------------------------------------------------------------------------
def test_serve_closed_loop_on_cpu():
    stats = serve.main(["--device", "cpu", "--pool", "0", "--tenants", "2",
                        "--requests", "4", "--max-new", "4",
                        "--prompt-len", "6"])
    assert stats["tokens"] == 4 * 4
    assert stats["exe_cache"]["entries"] == 2     # decode + one prefill length
    assert stats["arena"]["arena.cold"] == 2      # one slab per batcher


@pytest.mark.parametrize("flags", [["--round-trip", "--pool", "2"],
                                   ["--trace-file", "x.csv", "--nodes", "2"],
                                   ["--attribute"]])
def test_serve_gateway_only_flags_require_gateway(flags, capsys):
    # every mode is ported (the gateway's tests are in
    # test_torch_gateway.py); a gateway-only flag without --gateway
    # exits 2, as in the reference
    with pytest.raises(SystemExit) as e:
        serve.main(["--device", "cpu", *flags])
    assert e.value.code == 2
    assert "require(s) --gateway" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# The callable's argument contract: what the reference's executable,
# lowered on example_args' shapes and dtypes, does with each payload for
# "x". Every payload dict is built with its keys in the other order than
# example_args ({"x", "s"}): jax matches dict leaves by sorted key
PAYLOADS = {
    "numpy_f32": lambda: np.full((64,), 3.0, np.float32),
    "shape_1": lambda: np.full((1,), 3.0, np.float32),
    "numpy_f64": lambda: np.full((64,), 3.0, np.float64),
    "numpy_i64": lambda: np.full((64,), 3, np.int64),
    "wrong_dtype_i32": lambda: np.full((64,), 3, np.int32),
    "wrong_dtype_f16": lambda: np.full((64,), 3.0, np.float16),
    "python_float": lambda: 3.0,
    "python_list": lambda: [3.0] * 64,
}
# the second leaf, of the same shape and dtype as "x": were leaves matched
# by insertion order, "x" and "s" would swap silently
S = np.arange(64, dtype=np.float32) % 5


def _affine(params, args):
    return {"y": args["x"] * params["w"] + params["b"] + args["s"]}


def _outcome(invoke):
    try:
        y = invoke()["y"]
    except Exception as e:          # the exception type is the outcome
        return type(e)
    return np.asarray(y)


@pytest.mark.parametrize("name", sorted(PAYLOADS) + ["missing_key"])
def test_callable_payload_matches_reference(name):
    import jax.numpy as jnp
    from repro.core import CallableSpec as JCallableSpec
    # dyadic weights: x * w + b + s is exact, whether XLA fuses it into an
    # FMA or torch rounds the product first, so the results compare
    # bit-equal
    w = np.arange(-16, 48, dtype=np.float32) / 4
    b = np.arange(64, dtype=np.float32) % 7

    def payload():
        if name == "missing_key":
            return {"x": np.full((64,), 3.0, np.float32)}
        return {"s": S.copy(), "x": PAYLOADS[name]()}
    jrt = JRuntime(memory_budget_bytes=1 << 30, janitor=False)
    rt = make_rt()
    try:
        jrt.register_function("f", JCallableSpec(
            name="affine", fn=_affine,
            example_args={"x": jnp.ones((64,), jnp.float32),
                          "s": jnp.ones((64,), jnp.float32)},
            params={"w": jnp.asarray(w), "b": jnp.asarray(b)}))
        rt.register_function("f", CallableSpec(
            name="affine", fn=_affine,
            example_args={"x": torch.ones(64), "s": torch.ones(64)},
            params={"w": torch.from_numpy(w), "b": torch.from_numpy(b)}))
        want = _outcome(lambda: jrt.invoke("f", payload()))
        got = _outcome(lambda: rt.invoke("f", payload()))
    finally:
        jrt.shutdown()
        rt.shutdown()
    if isinstance(want, type):
        assert got is want is TypeError
    else:
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape and np.array_equal(got, want)


def test_callable_matching_tensor_is_passed_uncopied():
    rt = make_rt()
    seen = []

    def fn(params, args):
        seen.append(args["x"])
        return {"y": args["x"] * params["w"]}
    try:
        rt.register_function("f", CallableSpec(
            name="probe", fn=fn, example_args={"x": torch.ones(64)},
            params={"w": torch.full((64,), 2.0)}))
        x = torch.full((64,), 3.0)
        rt.invoke("f", {"x": x})
        assert seen[-1] is x
        rt.invoke("f", {"x": np.ones(64, np.float32)})
        assert seen[-1] is not x and seen[-1].device == x.device
    finally:
        rt.shutdown()
