"""The port's optimizer, compression and train step against the reference.

- ``AdamW``, the schedules and ``ErrorFeedbackCompression`` take the same
  numpy gradients in both packages and must leave the same params and
  state (fp32, 2e-5), updated in place in the port.
- ``n_micro`` 2 against 1 on the port, accumulating into one buffer.
- Twins of the reference's jnp-bound optimizer and compression tests
  (``tests/test_substrates.py``) and of ``test_smoke_forward_and_train_step``
  (``tests/test_models.py``), on the port.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ft.compression import ErrorFeedbackCompression as JEF
from repro.optim import AdamW as JAdamW
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch.configs import get_config, list_archs
from repro_torch.ft.compression import (ErrorFeedbackCompression, dequantize,
                                        quantize)
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.programs import ModelProgram
from repro_torch.optim import AdamW, constant, global_norm, warmup_cosine
from repro_torch.core.arena import tree_leaves

F32 = dict(rtol=2e-5, atol=2e-5)


def flat(tree, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = (
                v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))
    return out


def assert_trees_close(got, want, exempt=None, **tol) -> int:
    """Every leaf within ``tol`` of the reference's, except where
    ``exempt(key)`` (a boolean mask of the leaf, or None) is set; returns
    how many elements were exempt and differed."""
    g, w = flat(got), flat(want)
    assert set(g) == set(w)
    n_exempt = 0
    for k in w:
        mask = exempt(k) if exempt else None
        if mask is not None:
            off = ~np.isclose(g[k], w[k], rtol=tol["rtol"], atol=tol["atol"])
            assert not (off & ~mask).any(), \
                f"{k}: elements off the reference that no rounding " \
                f"boundary explains: {np.argwhere(off & ~mask)[:5]}"
            n_exempt += int((off & mask).sum())
            continue
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **tol)
    return n_exempt


def quantization_boundaries(grads: dict) -> dict:
    """{leaf: elements whose |g| / scale lies within 1e-3 of a
    half-integer}, for the int8 quantization of a first compressed step
    (the residual starts at zero, so it quantizes the gradient itself)."""
    out = {}
    for k, g in grads.items():
        scale = (np.abs(g).max() + 1e-12) / 127.0
        frac = np.abs(g / scale) % 1.0
        out[k] = np.abs(frac - 0.5) < 1e-3
    return out


def numpy_tree(seed: int, shapes: dict, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"a": (3, 5), "b": (7,), "c": (2, 4, 6)}


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("compress", [False, True])
def test_optimizer_update_matches_reference_in_place(compress):
    """Three updates from the same numpy gradients: params, m, v, step (and
    the residual) as the reference's; the port's tensors stay where they
    were (updated in place)."""
    params = numpy_tree(0, SHAPES)
    jopt = JAdamW(lr=jwarmup_cosine(1e-2, 2, 10))
    topt = AdamW(lr=warmup_cosine(1e-2, 2, 10))
    if compress:
        jopt, topt = JEF(jopt), ErrorFeedbackCompression(topt)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = params_from_numpy(params, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    ptrs = [t.data_ptr() for t in tree_leaves(tp) + tree_leaves(ts)]
    for i in range(3):
        grads = numpy_tree(10 + i, SHAPES, scale=3.0)
        jp, js, jm = jopt.update({k: jnp.asarray(v) for k, v in
                                  grads.items()}, js, jp)
        tp, ts, tm = topt.update(params_from_numpy(grads, "cpu"), ts, tp)
        assert_trees_close(tp, jp, **F32)
        assert_trees_close(ts, js, **F32)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **F32)
    assert ptrs == [t.data_ptr() for t in tree_leaves(tp) + tree_leaves(ts)]
    assert int(tree_leaves(ts)[-1] if not compress else
               ts["inner"]["step"]) == 3


@pytest.mark.parametrize("step", [0, 1, 2, 5, 9, 10, 30])
def test_schedules_match_reference(step):
    from repro.optim import constant as jconstant
    want = float(jwarmup_cosine(3e-4, 5, 20)(jnp.int32(step)))
    for s in (step, torch.tensor(step, dtype=torch.int32)):
        got = warmup_cosine(3e-4, 5, 20)(s)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-6)
    assert float(constant(0.5)(step)) == float(jconstant(0.5)(jnp.int32(step)))


def test_global_norm_is_fp32_over_every_leaf():
    tree = {"a": torch.ones(3, dtype=torch.bfloat16),
            "b": {"c": torch.full((4,), 2.0)}}
    n = global_norm(tree)
    assert n.dtype == torch.float32
    assert float(n) == pytest.approx((3 + 16) ** 0.5)


# ---------------------------------------------------------------------------
def _train_batch(cfg, B, S, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[:, 0] = -1
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32), "labels": labels}


def test_micro_batches_accumulate_into_one_gradient_buffer():
    """n_micro 2 sums the micro-batches' gradients into the step's one
    preallocated buffer: the same step as n_micro 1 on the same rows, up
    to fp32 summation order, and the buffer is reused across steps."""
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                              dtype="float32")
    prog = ModelProgram(cfg, remat=False)
    batch = {k: torch.from_numpy(v) for k, v in _train_batch(cfg, 4, 16)
             .items()}
    out = {}
    for n in (1, 2):
        params = prog.init(0, device="cpu")
        opt = AdamW(lr=constant(1e-3), eps=1e-3)
        state = opt.init(params)
        step = prog.make_train_step(opt, n_micro=n)
        _, _, m1 = step(params, state, batch)
        _, _, m2 = step(params, state, batch)
        out[n] = (params, float(m1["loss"]), float(m2["grad_norm"]))
    np.testing.assert_allclose(out[2][1], out[1][1], rtol=1e-5)
    np.testing.assert_allclose(out[2][2], out[1][2], rtol=1e-4)
    assert_trees_close(out[2][0], out[1][0], rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="micro-batches"):
        prog.make_train_step(AdamW(lr=constant(1e-3)), n_micro=3)(
            out[1][0], AdamW(lr=constant(1e-3)).init(out[1][0]), batch)


# ---------------------------------------------------------------------------
# twins of the reference's jnp-bound tests
def test_quantize_dequantize_bounded():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32)) * 5
    q, s = quantize(x)
    assert q.dtype == torch.int8
    err = (dequantize(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-6


def test_error_feedback_compression_converges():
    """EF-compressed AdamW still optimizes a quadratic."""
    opt = ErrorFeedbackCompression(AdamW(lr=constant(0.2), weight_decay=0.0))
    params = {"w": torch.full((8,), 5.0)}
    state = opt.init(params)
    for _ in range(80):
        g = {"w": 2 * params["w"]}
        params, state, _ = opt.update(g, state, params)
    assert float((params["w"] ** 2).sum()) < 0.5


def test_adamw_clip_and_schedule():
    opt = AdamW(lr=warmup_cosine(1e-2, 5, 50), clip_norm=1.0)
    params = {"w": torch.ones(4)}
    before = params["w"].clone()
    state = opt.init(params)
    huge = {"w": torch.full((4,), 1e6)}
    p2, state, mets = opt.update(huge, state, params)
    assert float(mets["grad_norm"]) > 1e5
    # clipped: update magnitude bounded by lr * O(1)
    assert float((p2["w"] - before).abs().max()) < 1e-2
    assert float(mets["lr"]) == pytest.approx(1e-2 / 5, rel=1e-3)


def _smoke_batch(cfg, B, S, seed=0) -> dict:
    """The reference test's batch shapes: audio embeds (B,S,D), vlm
    embeds (B,F,D) + tokens (B,S-F), else tokens; labels (B,S)."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, cfg.dtype)
    batch = {"labels": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}
    if cfg.family == "audio":
        batch["embeds"] = torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)).to(dt)
    elif cfg.family == "vlm":
        F = cfg.frontend_tokens
        batch["embeds"] = torch.from_numpy(rng.standard_normal(
            (B, F, cfg.d_model)).astype(np.float32)).to(dt)
        batch["tokens"] = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, S - F)).astype(np.int32))
    else:
        batch["tokens"] = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32))
    return batch


@pytest.mark.parametrize("arch", list_archs())
def test_smoke_forward_and_train_step(arch):
    cfg = get_config(arch).reduced()
    prog = ModelProgram(cfg, remat=True)
    params = prog.init(0, device="cpu")
    B, S = 2, 32
    batch = _smoke_batch(cfg, B, S)
    with torch.no_grad():
        logits, aux = tf.forward(params, cfg, tokens=batch.get("tokens"),
                                 embeds=batch.get("embeds"))
    assert logits.shape == (B, S, cfg.vocab_size), logits.shape
    assert not torch.isnan(logits.float()).any()
    assert aux.dtype == torch.float32 and aux.dim() == 0

    before = {k: v.copy() for k, v in flat(params).items()}
    opt = AdamW(lr=constant(1e-3))
    step = prog.make_train_step(opt, n_micro=2)
    params2, _, mets = step(params, opt.init(params), batch)
    assert np.isfinite(float(mets["loss"]))
    # params changed (in place: params2 is params)
    assert params2 is params
    delta = [float(np.abs(flat(params2)[k] - v).max())
             for k, v in before.items()]
    assert max(delta) > 0
