"""The paper's Table 1 functions in the port (``repro_torch.functions``)
against the JAX catalog (``benchmarks/functions.py``) on the same numpy
inputs, made from a seed, with the JAX catalog's params carried across.

Tolerances: filehashing, helloworld and dynamic-html exact (the hash on
random bytes and on all-255 bytes, where every term wraps; dynamic-html
on integer-valued values with duplicate and negative slots, so that the
order of the sum over a slot cannot matter); thumbnail, video and
uploader fp32 2e-5; restapi and classify labels equal; compress
tie-aware (``check_compress``). Then the nine through both runtimes, on
numpy host payloads, and the port's executable cache: one build per
function, hits after that.
"""
import jax
import numpy as np
import pytest
import torch

from benchmarks import functions as jfunctions
from repro.core import HydraRuntime as JRuntime
from repro_torch import functions
from repro_torch.core import HydraRuntime

TOL = 2e-5
KEYS = ("js/helloworld", "jv/filehashing", "py/thumbnail", "py/compress",
        "py/video", "jv/restapi", "jv/classify", "js/uploader",
        "js/dynamic-html")


@pytest.fixture(scope="module")
def jcat():
    return jfunctions.catalog()


@pytest.fixture(scope="module")
def cat(jcat):
    carried = functions.catalog_params_from_numpy(
        {k: jax.tree.map(np.asarray, s.params) for k, s in jcat.items()
         if s.params is not None}, "cpu")
    return functions.catalog("cpu", params=carried)


# the float32 functions: argument name and shape
FLOAT_ARGS = {"js/helloworld": ("x", (8,)),
              "py/thumbnail": ("image", (256, 256, 3)),
              "py/compress": ("signal", (8192,)),
              "py/video": ("frames", (16, 64, 64)),
              "jv/restapi": ("query", (4, 64)),
              "jv/classify": ("features", (8, 128)),
              "js/uploader": ("payload", (65536,))}


def random_args(key: str, seed: int = 0) -> dict:
    """Seeded numpy inputs of the function's registered shapes."""
    rng = np.random.default_rng(seed)
    if key == "jv/filehashing":
        return {"data": rng.integers(0, 256, 4096).astype(np.uint8)}
    if key == "js/dynamic-html":
        slots = rng.integers(-6000, 6000, 64).astype(np.int32)
        slots[1::3] = slots[0::3][:len(slots[1::3])]   # duplicate slots
        slots[5] = slots[7] - 3 * functions.PAGE       # a slot two ways
        return {"slots": slots,
                "values": rng.integers(-8, 9, 64).astype(np.float32)}
    name, shape = FLOAT_ARGS[key]
    return {name: rng.standard_normal(shape).astype(np.float32)}


def check_compress(got, want, signal):
    """Tie-aware: which coefficients pass the 90th-percentile threshold
    depends on roundoff for those whose magnitude lies within roundoff of
    it. So the kept sets must match exactly outside a band of
    ``TOL x max |f|`` around the threshold (the float64 transform's), and
    the values where both keep a coefficient within ``TOL x max |f|``."""
    f64 = np.fft.rfft(np.asarray(signal, np.float64))
    mag = np.abs(f64)
    thresh = np.percentile(mag, 90)
    scale = TOL * mag.max()
    outside = np.abs(mag - thresh) > scale
    kg, kw = got != 0, want != 0
    np.testing.assert_array_equal(kg[outside], kw[outside])
    assert kg[outside].sum() > 0
    both = kg & kw
    assert np.abs(got[both] - want[both]).max() <= scale
    assert not np.any(got[~kg]) and not np.any(want[~kw])


def check(key: str, got: dict, want: dict, args: dict) -> None:
    """The port's output tree against the reference's, with the key's
    tolerance, dtypes equal."""
    assert set(got) == set(want)
    for name, w in want.items():
        w = np.asarray(w)
        g = got[name].cpu().numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (name, g.dtype,
                                                           w.dtype)
        if key == "py/compress":
            check_compress(g, w, args["signal"])
        elif key in ("py/thumbnail", "py/video", "js/uploader"):
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
        else:                  # exact: digest, msg, page, labels
            np.testing.assert_array_equal(g, w)


def run_port(spec, args: dict) -> dict:
    targs = {k: torch.from_numpy(np.array(v))
             for k, v in args.items()}
    with torch.no_grad():
        return spec.fn(spec.params, targs)


def run_ref(jspec, args: dict) -> dict:
    return jax.jit(jspec.fn)(jspec.params, args)


CASES = [(k, "example") for k in KEYS] + [(k, "random") for k in KEYS] + \
    [("jv/filehashing", "all-255")]


@pytest.mark.parametrize("key,inputs", CASES,
                         ids=[f"{k}-{i}" for k, i in CASES])
def test_function_matches_reference(cat, jcat, key, inputs):
    if inputs == "example":
        args = {k: np.asarray(v)
                for k, v in jfunctions.example_args(jcat[key]).items()}
        mine = functions.example_args(cat[key])
        for k, v in mine.items():
            np.testing.assert_array_equal(v.numpy(), args[k])
    elif inputs == "random":
        args = random_args(key)
    else:
        args = {"data": np.full(4096, 255, np.uint8)}
    check(key, run_port(cat[key], args), run_ref(jcat[key], args), args)


def test_hash_digest_values(cat):
    """The digest against Python integers, independent of both
    frameworks. The reference's powers are ``jnp.power(uint32(31),
    arange(4096))``, which takes the exponent's low 6 bits: 31**(i mod
    64) mod 2**32. So the digest is sum(b * 31**(i mod 64)) mod 2**32."""
    jpow = np.asarray(jax.numpy.power(jax.numpy.uint32(31),
                                      jax.numpy.arange(4096, dtype="uint32")))
    assert [int(p) for p in jpow] == [pow(31, i % 64, 1 << 32)
                                      for i in range(4096)]
    for data in (np.full(4096, 255, np.uint8), random_args(
            "jv/filehashing", 3)["data"]):
        want = sum(int(b) * pow(31, i % 64, 1 << 32)
                   for i, b in enumerate(data)) % (1 << 32)
        got = run_port(cat["jv/filehashing"], {"data": data})["digest"]
        assert got.dtype == torch.uint32 and got.shape == ()
        assert int(got) == want


def test_catalog_matches_reference_specs(cat, jcat):
    """The reference's keys, names, example shapes and dtypes, and params
    of the reference's shapes; the seeded draw is the same on every call
    and ``seed`` changes it."""
    assert list(cat) == list(jcat)
    for key, spec in cat.items():
        jspec = jcat[key]
        assert spec.name == jspec.name and spec.arena_bytes == \
            jspec.arena_bytes
        assert set(spec.example_args) == set(jspec.example_args)
        for k, v in spec.example_args.items():
            jv = jspec.example_args[k]
            assert tuple(v.shape) == jv.shape
            assert str(v.dtype).split(".")[1] == jv.dtype.name
            np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        assert (spec.params is None) == (jspec.params is None)
        if spec.params is not None:
            for k, v in spec.params.items():
                np.testing.assert_array_equal(
                    v.numpy(), np.asarray(jspec.params[k]))
    a, b = functions.catalog("cpu"), functions.catalog("cpu")
    c = functions.catalog("cpu", seed=7)
    for key in ("jv/restapi", "jv/classify"):
        for k in a[key].params:
            assert torch.equal(a[key].params[k], b[key].params[k])
            assert not torch.equal(a[key].params[k], c[key].params[k])
            assert a[key].params[k].dtype == torch.float32


def test_catalog_params_from_numpy_refuses_other_shapes():
    with pytest.raises(ValueError, match="float32"):
        functions.catalog_params_from_numpy(
            {"jv/restapi": {"table": np.zeros((64, 128), np.float32)}},
            "cpu")
    with pytest.raises(ValueError, match="draws no params"):
        functions.catalog_params_from_numpy(
            {"py/video": {"k": np.zeros(3, np.float32)}}, "cpu")


def test_catalog_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        functions.catalog()


@pytest.fixture(scope="module")
def runtimes(cat, jcat):
    """The nine registered in the port's runtime on the CPU and in the
    reference's, under one tenant each."""
    rt = HydraRuntime(device="cpu", memory_budget_bytes=1 << 30,
                      janitor=False)
    jrt = JRuntime(memory_budget_bytes=1 << 30, janitor=False)
    for key in KEYS:
        assert rt.register_function(key, cat[key], tenant=key.split("/")[0])
        assert jrt.register_function(key, jcat[key],
                                     tenant=key.split("/")[0])
    yield rt, jrt
    rt.shutdown()
    jrt.shutdown()


@pytest.mark.parametrize("key", KEYS)
def test_runtime_invoke_matches_reference_runtime(runtimes, key):
    rt, jrt = runtimes
    args = random_args(key, seed=1)
    got = rt.invoke(key, args)
    want = jax.tree.map(np.asarray, jrt.invoke(key, args))
    check(key, got, want, args)


def test_runtime_builds_each_function_once(cat):
    rt = HydraRuntime(device="cpu", memory_budget_bytes=1 << 30,
                      janitor=False)
    try:
        for key in KEYS:
            rt.register_function(key, cat[key])
        assert rt.exe_cache.stats()["compiles"] == len(KEYS)
        assert rt.exe_cache.stats()["hits"] == 0
        for key in KEYS:
            rt.invoke(key, functions.example_args(cat[key]))
            rt.register_function("again/" + key, cat[key], tenant="again")
        stats = rt.exe_cache.stats()
        assert stats["compiles"] == len(KEYS)
        assert stats["hits"] == len(KEYS)
        assert stats["entries"] == len(KEYS)
        assert rt.stats()["functions"] == 2 * len(KEYS)
    finally:
        rt.shutdown()
