"""The batcher's decode graph (``core/scheduler``), on the CPU.

On CUDA a ``ContinuousBatcher`` captures its decode step into a
``torch.cuda.CUDAGraph`` and replays it. Here ``torch.cuda.CUDAGraph``,
``torch.cuda.Stream``, ``torch.cuda.stream``,
``torch.cuda.graph_pool_handle`` and ``torch.cuda.synchronize`` are
replaced by stand-ins (``torch.cuda.graph`` and ``torch.cuda.empty_cache`` by a
failure) and the scheduler's ``_graphs_on`` answers yes for the CPU, so
the batcher takes its graph path on CPU tensors:

- ``RecordingGraph`` records, between ``capture_begin`` and
  ``capture_end``, the aten ops the step dispatches; at ``capture_end`` it
  puts back every storage they wrote and poisons every tensor they made,
  as a CUDA capture runs nothing and leaves its outputs unset; ``replay``
  runs the recorded ops again, in order, each result written where the
  capture's went. A host read inside the capture raises, as it does on
  the card. ``Pools`` keeps the allocator's rule that a pool nothing
  holds is retired and takes no capture again.

Checked: the first decode is eager, the second a capture and one replay,
the rest replays, with the runtime's counters and the ``graph`` attribute
of ``decode.forward`` to match; tokens equal to an eager batcher's over
30 and more steps with admissions between, for an ssm, a hybrid, a
transformer (with a window) and an moe reduced config; a replaced cache
or param leaf captures again; ``close()`` drops the graph before the slab
goes back; a CPU runtime never builds one; one capture stream and one
graph memory pool a device, which a batcher that comes after the others
closed still captures into, and no capture empties the allocator's cache;
the kernel wrappers' ``launches`` count a replay's kernels and not the
capture's.
"""
import contextlib
import dataclasses
import gc
import itertools
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import get_config
from repro_torch.core import ContinuousBatcher, HydraRuntime, LMSpec
from repro_torch.core import scheduler
from repro_torch.core.tracing import MODEL_SPANS, Tracer
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import rotary
from repro_torch.models.programs import ModelProgram

ARCHS = ("mamba2-780m", "zamba2-2.7b", "qwen2.5-3b", "gemma3-1b",
         "granite-moe-1b-a400m")
_HOST_READ = torch.ops.aten._local_scalar_dense.default


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _written(func, args, kwargs) -> list:
    """The tensors an op writes, by its schema's ``(a!)`` arguments."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is not None and a.alias_info.is_write:
            v = args[i] if i < len(args) else kwargs.get(a.name)
            out += _tensors(v)
    return out


def _poison(t: torch.Tensor) -> None:
    if t.is_floating_point():
        t.fill_(float("nan"))
    elif t.dtype == torch.bool:
        t.fill_(True)
    else:
        t.fill_(-7)


class _Recorder(TorchDispatchMode):
    def __init__(self, graph):
        super().__init__()
        self.graph = graph

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _HOST_READ:
            raise RuntimeError("a host read inside a CUDA graph capture")
        g = self.graph
        writes = _written(func, args, kwargs)
        for t in writes:        # each written storage once, as it was
            st = t.untyped_storage()
            g.saved.setdefault(st.data_ptr(), (st, st.clone()))
        out = func(*args, **kwargs)
        if writes:
            g.ops.append(("write", func, args, kwargs, None))
            return out
        ins = {t.untyped_storage().data_ptr()
               for t in _tensors((args, kwargs))} - {0}
        view = any(t.untyped_storage().data_ptr() in ins
                   for t in _tensors(out))
        g.ops.append(("view" if view else "fresh", func, args, kwargs, out))
        return out


class Pools:
    """The device and host allocators' rule for graph memory pools: a pool
    is made by the first capture that names it and held by each graph
    captured into it; once no graph holds it, it is retired and takes no
    capture again."""
    holders: dict = {}
    ids = itertools.count(1)

    @classmethod
    def hold(cls, owner, pool) -> None:
        if cls.holders.get(pool, 1) <= 0:
            raise RuntimeError("it->second->use_count > 0 INTERNAL ASSERT "
                               "FAILED: a capture into a retired pool")
        cls.holders[pool] = cls.holders.get(pool, 0) + 1
        weakref.finalize(owner, cls.release, cls.holders, pool)

    @staticmethod
    def release(holders: dict, pool) -> None:
        holders[pool] -= 1


class RecordingGraph:
    """Stand-in for ``torch.cuda.CUDAGraph`` (module docstring). ``made``
    lists the graphs replayed, by their first replay: the decode graphs,
    not the device's pool anchor, which is never replayed."""
    made: list = []

    def __init__(self):
        self.ops, self.saved = [], {}
        self.error_mode = self.stream = self._pool = None
        self.replays = 0
        self._mode = None

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.error_mode = capture_error_mode
        self._pool = (0, next(Pools.ids)) if pool is None else pool
        Pools.hold(self, self._pool)
        self.stream = FakeStream.current
        self._mode = _Recorder(self)
        self._mode.__enter__()

    def capture_end(self):
        self._mode.__exit__(None, None, None)
        for st, before in self.saved.values():
            st.copy_(before)
        for kind, *_, out in self.ops:
            if kind == "fresh":
                for t in _tensors(out):
                    _poison(t)

    def pool(self):
        return self._pool

    def replay(self):
        if not self.replays:
            RecordingGraph.made.append(self)
        with torch.no_grad():
            for kind, func, args, kwargs, out in self.ops:
                if kind == "view":
                    continue
                res = func(*args, **kwargs)
                if kind == "fresh":
                    for dst, src in zip(_tensors(out), _tensors(res)):
                        dst.copy_(src)
        self.replays += 1


class FakeStream:
    """Stand-in for ``torch.cuda.Stream``; ``current`` is the one that
    ``torch.cuda.stream``'s stand-in has made current."""
    current = None

    def __init__(self, device=None):
        self.device = device


@contextlib.contextmanager
def fake_stream(stream):
    prev, FakeStream.current = FakeStream.current, stream
    try:
        yield
    finally:
        FakeStream.current = prev


def _empties_the_cache(*args, **kwargs):
    raise AssertionError("a capture emptied the allocator's cache (as "
                         "torch.cuda.graph does), under every tenant")


def _stand_ins(monkeypatch) -> list:
    made = []
    monkeypatch.setattr(RecordingGraph, "made", made)
    monkeypatch.setattr(Pools, "holders", {})
    monkeypatch.setattr(torch.cuda, "CUDAGraph", RecordingGraph)
    monkeypatch.setattr(torch.cuda, "graph", _empties_the_cache)
    monkeypatch.setattr(torch.cuda, "empty_cache", _empties_the_cache)
    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "stream", fake_stream)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: (0, next(Pools.ids)))
    monkeypatch.setattr(scheduler, "_capture_sides", {})
    return made


@pytest.fixture
def graphs(monkeypatch):
    """The stand-ins, with the batcher's graph path on for the CPU: the
    list of graphs made."""
    made = _stand_ins(monkeypatch)
    monkeypatch.setattr(scheduler, "_graphs_on", lambda device: True)
    return made


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the reduced models are small, and the suite
    runs files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make(arch, slots=3, max_seq=64, tracer=None, workers=0):
    """A CPU runtime serving reduced ``arch`` in fp32 (the path, not the
    precision, is under test) and a batcher over it."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    rt = HydraRuntime(device="cpu", n_workers=workers, janitor=False)
    params = ModelProgram(cfg).init(0, device="cpu")
    rt.register_function("fn", LMSpec(cfg=cfg, params=params,
                                      max_seq=max_seq, slots=slots))
    return rt, ContinuousBatcher(rt, "fn", tracer=tracer), params


def schedule(n=14, seed=0) -> list:
    """(step, prompt, max_new) of ``n`` requests sent over the run."""
    rng = np.random.default_rng(seed)
    return [(2 * i, rng.integers(2, 100, int(rng.integers(3, 20))).tolist(),
             int(rng.integers(4, 10))) for i in range(n)]


def drive(b, sched, at=None) -> list:
    """Send ``sched``'s requests at their steps and step ``b`` until all
    are done, calling ``at[step](b)`` before a step: their tokens."""
    sched, at, futs, step = list(sched), at or {}, [], 0
    while sched or b.active or b.pending:
        while sched and sched[0][0] <= step:
            _, prompt, n = sched.pop(0)
            futs.append(b.submit(prompt, n))
        if step in at:
            at[step](b)
        b.step()
        step += 1
    return [f.result() for f in futs]


def counters(rt) -> tuple:
    c = rt.metrics.counters
    return c["decode_graph.captures"], c["decode_graph.replays"]


def decode_forward(tracer) -> list:
    """Per recorded step with a decode: (its ``graph`` attribute, the
    model spans inside its ``decode.forward``)."""
    out = []
    for _, spans in tracer.steps():
        fwd = [s for s in spans if s[0] == "decode.forward"]
        if fwd:
            _, t0, t1, attrs = fwd[0]
            inner = [s[0] for s in spans if s[0] in MODEL_SPANS
                     and t0 <= s[1] and s[2] <= t1]
            out.append(((attrs or {}).get("graph"), inner))
    return out


def test_first_decode_eager_second_captured_then_replays(graphs):
    tracer = Tracer()
    rt, b, _ = make("mamba2-780m", slots=2, tracer=tracer)
    try:
        b.submit([5, 6, 7], 2)
        b.step()                        # admit, one eager decode: done
        assert counters(rt) == (0, 0) and graphs == []
        b.submit([1, 2, 3, 4], 5)
        b.step()                        # admit, capture, one replay
        assert counters(rt) == (1, 1) and len(graphs) == 1
        g = graphs[0]
        assert g.replays == 1 and g.ops
        assert g.error_mode == "thread_local"
        assert isinstance(g.stream, FakeStream)
        for n in range(2, 5):           # replays only
            b.step()
            assert counters(rt) == (1, n) and g.replays == n
        assert not b.active and len(graphs) == 1
        assert rt.exe_cache.compiles == 3      # decode + two prefills
        seen = decode_forward(tracer)
        assert [s[0] for s in seen] == ["eager", "capture"] + \
            ["replay"] * 3
        assert seen[0][1] and seen[1][1]       # recorded while run or
        assert all(not inner for _, inner in seen[2:])  # captured only
    finally:
        b.close()
        rt.shutdown()


@pytest.mark.parametrize("arch", ARCHS)
def test_graph_tokens_equal_the_eager_batchers(arch, monkeypatch):
    """The eager batcher's tokens are the single path's (``generate``),
    and the graph batcher's are the eager batcher's."""
    rt0, eager, _ = make(arch, workers=1)
    try:
        want = drive(eager, schedule())
        assert eager.steps >= 30
        for i, (_, prompt, n) in enumerate(schedule()[:3]):
            assert rt0.generate("fn", prompt, n) == want[i]
    finally:
        eager.close()
        rt0.shutdown()
    graphs = _stand_ins(monkeypatch)
    monkeypatch.setattr(scheduler, "_graphs_on", lambda device: True)
    rt, b, _ = make(arch)
    try:
        got = drive(b, schedule())
        assert got == want
        assert b.steps == eager.steps
        assert counters(rt) == (1, b.steps - 1) and len(graphs) == 1
    finally:
        b.close()
        rt.shutdown()


def _replace_state(b):
    b.cache["state"] = b.cache["state"].clone()


def _replace_kv(b):
    b.cache["k"] = b.cache["k"].clone()


@pytest.mark.parametrize("arch,leaf", [("mamba2-780m", _replace_state),
                                       ("qwen2.5-3b", _replace_kv)])
def test_a_replaced_leaf_captures_again(arch, leaf, monkeypatch):
    """A cache leaf moved at step 8, a param leaf (new weights, on both
    sides) at step 16: each is a new capture, and the tokens still equal
    the eager batcher's, which a graph bound to the old addresses would
    not give."""
    def new_weights(b):
        p = b.spec.params
        p["final_norm"] = p["final_norm"] + 0.25

    rt0, eager, _ = make(arch)
    try:
        want = drive(eager, schedule(), {16: new_weights})
    finally:
        eager.close()
        rt0.shutdown()
    graphs = _stand_ins(monkeypatch)
    monkeypatch.setattr(scheduler, "_graphs_on", lambda device: True)
    rt, b, _ = make(arch)
    try:
        got = drive(b, schedule(), {8: leaf, 16: new_weights})
        assert got == want
        assert counters(rt) == (3, b.steps - 1) and len(graphs) == 3
    finally:
        b.close()
        rt.shutdown()


def test_close_drops_the_graph_before_the_slab_goes_back(graphs):
    rt, b, _ = make("mamba2-780m", slots=2)
    b.submit([5, 6, 7], 4)
    b.run_until_done()
    assert len(graphs) == 1
    ref = weakref.ref(graphs.pop())
    alive_at_release = []
    release = rt.arena_pool.release

    def spy(arena):
        gc.collect()
        alive_at_release.append(ref() is not None)
        release(arena)

    rt.arena_pool.release = spy
    try:
        b.close()
        assert alive_at_release == [False]
    finally:
        rt.shutdown()


def test_a_cpu_runtime_never_builds_a_graph(monkeypatch):
    graphs = _stand_ins(monkeypatch)
    tracer = Tracer()
    rt, b, _ = make("qwen2.5-3b", tracer=tracer)
    try:
        drive(b, schedule(n=4))
        assert graphs == [] and counters(rt) == (0, 0)
        assert scheduler._capture_sides == {}
        seen = decode_forward(tracer)
        assert seen and all(g == "eager" and inner for g, inner in seen)
    finally:
        b.close()
        rt.shutdown()


def test_batchers_on_one_device_share_one_capture_stream_and_pool(graphs):
    made = []
    try:
        for arch in ("mamba2-780m", "qwen2.5-3b"):
            rt, b, _ = make(arch, slots=2)
            made.append((rt, b))
            b.submit([5, 6, 7], 3)
            b.run_until_done()
        assert len(graphs) == 2
        assert graphs[0].stream is graphs[1].stream
        assert graphs[0].pool() is not None
        assert graphs[0].pool() == graphs[1].pool()
        (stream, anchor), = scheduler._capture_sides.values()
        assert stream is graphs[0].stream
        assert anchor.pool() == graphs[0].pool() and not anchor.replays
    finally:
        for rt, b in made:
            b.close()
            rt.shutdown()


def test_a_batcher_after_the_others_closed_captures_into_the_pool(graphs):
    """Each batcher's graph is dropped at ``close()``; the device's pool
    outlives them, so the next batcher's capture has a pool to go to."""
    pools = []
    for arch in ("mamba2-780m", "qwen2.5-3b", "mamba2-780m"):
        rt, b, _ = make(arch, slots=2)
        try:
            b.submit([5, 6, 7], 4)
            b.run_until_done()
            assert counters(rt) == (1, 2)
        finally:
            b.close()
            rt.shutdown()
        pools.append(graphs.pop().pool())   # the last reference to it
        gc.collect()
    assert len(set(pools)) == 1
    assert Pools.holders[pools[0]] == 1             # the anchor alone


def test_launches_count_each_replays_kernels_not_the_captures(graphs,
                                                              monkeypatch):
    """The kernel wrappers count a call as a launch. A capture calls them
    and launches nothing; a replay launches the step's kernels and calls
    none. So each decode step, eager, captured (then replayed once) or
    replayed, adds the same launches: here a step that calls rmsnorm
    twice and decode_attention once, as the CUDA wrappers would count."""
    rt, b, _ = make("mamba2-780m", slots=2)
    decode = b.func.entry["decode"]

    def counted(params, cache, tokens):
        kernel_ops.add_launches({"rmsnorm": 2, "decode_attention": 1})
        return decode(params, cache, tokens)

    monkeypatch.setitem(b.func.entry, "decode", counted)
    try:
        b.submit([5, 6, 7], 5)
        seen = []
        for _ in range(4):          # eager, capture, replay, replay
            before = kernel_ops.launch_counts()
            b.step()
            after = kernel_ops.launch_counts()
            seen.append({k: n - before[k] for k, n in after.items() if
                         n != before[k]})
        assert counters(rt) == (1, 3)
        assert seen == [{"rmsnorm": 2, "decode_attention": 1}] * 4
    finally:
        b.close()
        rt.shutdown()


def test_a_host_read_in_the_step_fails_the_capture(graphs, monkeypatch):
    """The stand-in holds the step to what a CUDA capture allows: a step
    that reads a tensor on the host mid-way fails at its capture."""
    rt, b, _ = make("mamba2-780m", slots=2)
    decode = b.func.entry["decode"]

    def reads_host(params, cache, tokens):
        int(cache["length"][0])
        return decode(params, cache, tokens)

    monkeypatch.setitem(b.func.entry, "decode", reads_host)
    try:
        b.submit([5, 6, 7], 4)
        b.step()                                   # eager: allowed
        with pytest.raises(RuntimeError, match="host read"):
            b.step()
    finally:
        b.close()
        rt.shutdown()


@pytest.mark.parametrize("theta", [10000.0, 1e6, 500000.0, 123456.789])
def test_rotary_theta_fill_rounds_as_the_host_copy(theta):
    """rotary's theta is a fill on the device; it rounds to fp32 as the
    host copy it replaced did, so the embedding is bit for bit the same."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(3, 5, 4, 64, generator=gen).to(torch.bfloat16)
    pos = torch.randint(0, 4096, (3, 5), generator=gen)
    half = 32
    f32 = torch.float32
    freq = torch.exp(-torch.log(torch.tensor(theta, dtype=f32))
                     * torch.arange(0, half, dtype=f32) / half)
    ang = (pos.to(f32)[..., None] * freq)[..., None, :]
    x1, x2 = x[..., :half].to(f32), x[..., half:].to(f32)
    want = torch.cat([x1 * ang.cos() - x2 * ang.sin(),
                      x2 * ang.cos() + x1 * ang.sin()], dim=-1).to(x.dtype)
    assert torch.equal(rotary(x, pos, theta), want)
