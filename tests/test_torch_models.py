"""repro_torch models against the reference on the same weights.

The reference ``ModelProgram`` draws the weights; ``params_from_numpy``
converts them; both packages run the same numpy-drawn tokens on the CPU
(the reference through its jnp oracles, as its own tests run it).
fp32 configs are compared at the repo's fp32 tolerance, 2e-5 (the
frameworks differ only in summation order and transcendental rounding,
measured ~2e-6 on logits of magnitude ~3); bf16 configs at 5e-2 (bf16
rounds at other points in the two frameworks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as jtf
from repro.models.programs import ModelProgram as JProgram
from repro_torch.configs import get_config, list_archs
from repro_torch.models import transformer as tf
from repro_torch.models.attention import GLOBAL_WINDOW
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.programs import ModelProgram

ARCH = "qwen2.5-3b"
F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)


def configs(dtype: str):
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), dtype=dtype)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype)
    return jcfg, tcfg


def ref_params(jcfg, seed=0, cast_bf16=False):
    params = JProgram(jcfg).init(jax.random.PRNGKey(seed))
    if cast_bf16:
        params = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    return params


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def tokens(vocab, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bf16", [False, True])
def test_params_from_numpy_roundtrips_reference_init(bf16):
    jcfg, _ = configs("float32")
    jp = to_numpy(ref_params(jcfg, cast_bf16=bf16))
    tp = params_from_numpy(jp, "cpu")
    jl, jdef = jax.tree.flatten(jp)
    tl, tdef = jax.tree.flatten(tp)
    assert jdef == tdef
    for a, t in zip(jl, tl):
        assert tuple(t.shape) == a.shape
        assert t.dtype == (torch.bfloat16 if bf16 else torch.float32)
        if bf16:
            # bit-exact: the same 16-bit patterns on both sides
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))
        else:
            assert np.array_equal(t.numpy(), a)


def test_port_init_matches_reference_tree():
    """Same pytree, shapes and dtypes as the reference init; the values come
    from torch's generator (truncated normal cut at 2 std)."""
    jcfg, tcfg = configs("float32")
    jp = ref_params(jcfg)
    tp = ModelProgram(tcfg).init(0, device="cpu")
    jl, jdef = jax.tree.flatten(jax.tree.map(lambda x: x.shape, jp))
    tl, tdef = jax.tree.flatten(jax.tree.map(lambda x: tuple(x.shape), tp))
    assert jdef == tdef and jl == tl
    wq = tp["layers"]["attn"]["wq"]
    assert float(wq.abs().max()) <= 2.0 * tcfg.d_model ** -0.5 + 1e-6
    again = ModelProgram(tcfg).init(0, device="cpu")
    assert torch.equal(again["lm_head"], tp["lm_head"])          # seeded
    assert not torch.equal(ModelProgram(tcfg).init(1, device="cpu")[
        "lm_head"], tp["lm_head"])


def test_cache_specs_match_reference():
    jcfg, tcfg = configs("bfloat16")
    jprog, tprog = JProgram(jcfg), ModelProgram(tcfg)
    js, ts = jprog.cache_specs(3, 40), tprog.cache_specs(3, 40)
    assert set(js) == set(ts)
    for k in js:
        assert tuple(ts[k].shape) == js[k].shape
    assert tprog.cache_bytes(3, 40) == jprog.cache_bytes(3, 40)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_prefill_and_decode_match_reference(dtype, tol):
    jcfg, tcfg = configs(dtype)
    jparams = ref_params(jcfg)
    tparams = params_from_numpy(to_numpy(jparams), "cpu")
    jprog, tprog = JProgram(jcfg, remat=False), ModelProgram(tcfg)
    B, S = 2, 12
    toks = tokens(tcfg.vocab_size, B, S + 1)

    jl, jc = jprog.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])})
    tl, tc = tprog.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :S])})
    np.testing.assert_allclose(f32(tl), f32(jl), **tol)
    for k in ("k", "v"):
        np.testing.assert_allclose(f32(tc[k]), f32(jc[k]), **tol)
    assert tc["length"].tolist() == np.asarray(jc["length"]).tolist()

    # decode one token against a cache with room to grow
    pad = lambda x: np.concatenate(
        [x, np.zeros(x.shape[:2] + (4,) + x.shape[3:], x.dtype)], axis=2)
    jc = {"k": jnp.asarray(pad(np.asarray(jc["k"]))),
          "v": jnp.asarray(pad(np.asarray(jc["v"]))), "length": jc["length"]}
    tc = {"k": torch.cat([tc["k"], torch.zeros_like(tc["k"][:, :, :4])], 2),
          "v": torch.cat([tc["v"], torch.zeros_like(tc["v"][:, :, :4])], 2),
          "length": tc["length"]}
    jd, jc2 = jprog.decode_step(jparams, jc, {"tokens": jnp.asarray(
        toks[:, S:])})
    td, tc2 = tprog.decode_step(tparams, tc, {"tokens": torch.from_numpy(
        toks[:, S:])})
    np.testing.assert_allclose(f32(td), f32(jd), **tol)
    assert tc2 is tc                                      # updated in place
    np.testing.assert_allclose(f32(tc2["k"]), f32(jc2["k"]), **tol)
    assert tc2["length"].tolist() == [S + 1] * B


def test_prefill_decode_matches_reference_forward():
    """The tests/test_models.py invariant across packages: port prefill of S
    tokens then one decode step equals the reference's cacheless forward."""
    jcfg, tcfg = configs("float32")
    jparams = ref_params(jcfg, seed=3)
    tparams = params_from_numpy(to_numpy(jparams), "cpu")
    B, S = 2, 16
    toks = tokens(tcfg.vocab_size, B, S + 1, seed=3)
    full, _ = jtf.forward(jparams, jcfg, tokens=jnp.asarray(toks))
    prog = ModelProgram(tcfg)
    last, cache = prog.prefill(tparams, {"tokens": torch.from_numpy(
        toks[:, :S])})
    np.testing.assert_allclose(f32(last), f32(full[:, S - 1]), **F32_TOL)
    for k in ("k", "v"):
        cache[k] = torch.cat([cache[k], torch.zeros_like(cache[k][:, :, :4])],
                             2)
    dec, cache = prog.decode_step(tparams, cache, {"tokens": torch.from_numpy(
        toks[:, S:])})
    np.testing.assert_allclose(f32(dec), f32(full[:, -1]), **F32_TOL)
    assert cache["length"].tolist() == [S + 1] * B


def test_decode_past_max_seq_matches_reference_clamped_write():
    """A free batcher slot keeps decoding, so its length grows past the
    cache end. The reference's dynamic_update_slice clamps the write to
    row S-1; the port must write the same row (and not index past S)."""
    jcfg, tcfg = configs("float32")
    jparams = ref_params(jcfg, seed=4)
    tparams = params_from_numpy(to_numpy(jparams), "cpu")
    rng = np.random.default_rng(4)
    L, B, S = tcfg.n_layers, 3, 8
    kv = (L, B, S, tcfg.n_kv_heads, tcfg.resolved_head_dim)
    k0 = rng.standard_normal(kv).astype(np.float32)
    v0 = rng.standard_normal(kv).astype(np.float32)
    lengths = np.array([5, S, S + 3], np.int32)        # in range, at, past
    toks = tokens(tcfg.vocab_size, B, 1, seed=4)
    jd, jc = JProgram(jcfg).decode_step(
        jparams, {"k": jnp.asarray(k0), "v": jnp.asarray(v0),
                  "length": jnp.asarray(lengths)},
        {"tokens": jnp.asarray(toks)})
    tc = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy()),
          "length": torch.from_numpy(lengths.copy())}
    td, tc = ModelProgram(tcfg).decode_step(tparams, tc,
                                            {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(f32(td), f32(jd), **F32_TOL)
    np.testing.assert_allclose(f32(tc["k"]), f32(jc["k"]), **F32_TOL)
    np.testing.assert_allclose(f32(tc["v"]), f32(jc["v"]), **F32_TOL)
    # rows 1 and 2 both wrote row S-1; row 0 wrote row 5
    assert not np.allclose(f32(tc["k"])[:, 2, S - 1], k0[:, 2, S - 1])
    assert np.array_equal(f32(tc["k"])[:, 2, :S - 1], k0[:, 2, :S - 1])
    assert tc["length"].tolist() == (lengths + 1).tolist()


def test_layer_windows_match_reference():
    for arch in ("gemma3-1b", "qwen2.5-3b"):
        want = jtf.layer_windows(jget_config(arch), static=True).tolist()
        got = tf.layer_windows(get_config(arch))
        assert got == want
        assert all(isinstance(w, int) for w in got)
    assert GLOBAL_WINDOW == int(jnp.iinfo(jnp.int32).max // 2)


def family_batch(cfg, B, S, seed):
    """numpy inputs of a prefill of S positions and of one decode step:
    tokens; a vlm's prefix embeddings before S - frontend_tokens tokens;
    an audio model's frame embeddings in place of tokens."""
    rng = np.random.default_rng(seed)
    emb = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    if cfg.family == "audio":
        return {"embeds": emb(B, S, cfg.d_model)}, \
            {"embeds": emb(B, 1, cfg.d_model)}
    toks = tokens(cfg.vocab_size, B, S + 1, seed)
    ft = cfg.frontend_tokens if cfg.family == "vlm" else 0
    pre = {"tokens": toks[:, :S - ft]}
    if ft:
        pre["embeds"] = emb(B, ft, cfg.d_model)
    return pre, {"tokens": toks[:, S:]}


@pytest.mark.parametrize("arch", list_archs())
def test_every_arch_prefill_and_decode_match_reference(arch):
    """Every family's reduced config, fp32: prefill logits and cache, then
    one decode step's logits and cache, against the reference on the same
    weights and inputs (the vlm with its prefix, the audio model on
    frames)."""
    jcfg = dataclasses.replace(jget_config(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    jparams = ref_params(jcfg, seed=6)
    tparams = params_from_numpy(to_numpy(jparams), "cpu")
    jprog, tprog = JProgram(jcfg, remat=False), ModelProgram(tcfg)
    B, S = 2, 12
    pre, dec = family_batch(tcfg, B, S, seed=6)
    as_j = lambda b: {k: jnp.asarray(v) for k, v in b.items()}
    as_t = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}
    jl, jc = jprog.prefill(jparams, as_j(pre))
    tl, tc = tprog.prefill(tparams, as_t(pre))
    np.testing.assert_allclose(f32(tl), f32(jl), **F32_TOL)
    assert set(tc) == set(jc)
    for k in tc:
        np.testing.assert_allclose(f32(tc[k]), f32(jc[k]), **F32_TOL)
    assert tc["length"].tolist() == [S] * B

    # decode one position against caches grown by 4 rows (K/V only: the
    # SSM leaves have no sequence axis)
    grow = lambda c, z, cat: {
        k: cat([v, z(v[:, :, :4])], 2) if k in ("k", "v") else v
        for k, v in c.items()}
    jc = grow(jc, jnp.zeros_like, lambda xs, a: jnp.concatenate(xs, a))
    tc = grow(tc, torch.zeros_like, torch.cat)
    jd, jc = jprog.decode_step(jparams, jc, as_j(dec))
    td, tc = tprog.decode_step(tparams, tc, as_t(dec))
    np.testing.assert_allclose(f32(td), f32(jd), **F32_TOL)
    for k in tc:
        np.testing.assert_allclose(f32(tc[k]), f32(jc[k]), **F32_TOL)
    assert tc["length"].tolist() == [S + 1] * B


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "internvl2-76b",
                                  "musicgen-large"])
def test_new_family_cache_specs_match_reference(arch):
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    js = JProgram(jcfg).cache_specs(3, 40)
    ts = ModelProgram(tcfg).cache_specs(3, 40)
    assert {k: tuple(v.shape) for k, v in ts.items()} == \
        {k: v.shape for k, v in js.items()}
    assert ModelProgram(tcfg).cache_bytes(3, 40) == \
        JProgram(jcfg).cache_bytes(3, 40)


def test_route_groups_match_reference_for_every_batch_kind():
    """ModelProgram._n_groups: 1 for a model without experts, B for an moe
    decode, one per 2048 tokens otherwise; the vlm counts its prefix."""
    for arch in ("granite-moe-1b-a400m", "qwen2.5-3b", "internvl2-76b"):
        jprog = JProgram(jget_config(arch).reduced())
        tprog = ModelProgram(get_config(arch).reduced())
        for shape in [(4, 1), (1, 128), (2, 2048), (3, 2048)]:
            z = np.zeros(shape, np.int32)
            assert tprog._n_groups({"tokens": z}) == \
                jprog._n_groups({"tokens": z}), (arch, shape)


@pytest.mark.parametrize("arch", ["gemma3-1b", "nemotron-4-15b"])
def test_other_dense_archs_match_reference(arch):
    """Tied embeddings + GeGLU + sliding windows (gemma3), relu² without
    bias (nemotron): prefill logits against the reference, fp32."""
    jcfg = dataclasses.replace(jget_config(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    jparams = ref_params(jcfg, seed=5)
    tparams = params_from_numpy(to_numpy(jparams), "cpu")
    toks = tokens(tcfg.vocab_size, 2, 20, seed=5)
    jl, _ = JProgram(jcfg, remat=False).prefill(jparams, {
        "tokens": jnp.asarray(toks)})
    tl, _ = ModelProgram(tcfg).prefill(tparams, {"tokens": torch.from_numpy(
        toks)})
    np.testing.assert_allclose(f32(tl), f32(jl), **F32_TOL)
