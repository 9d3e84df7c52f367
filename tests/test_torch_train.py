"""The port's training path against the reference on the same weights.

The reference ``ModelProgram`` draws the weights; ``params_from_numpy``
converts them; both packages take the same numpy-drawn batch on the CPU
(the reference through its jnp oracles, as its own tests run it; the port
through its plain versions under autograd). For every arch at its
reduced size, B 2, S 32: ``loss_fn``'s loss, ce and aux, and every
parameter's gradient, against ``jax.value_and_grad``'s. fp32 configs
agree within 2e-5, the repo's fp32 kernel tolerance; a gradient is
compared relative to its leaf's max |g|. The default configs (bf16
compute, fp32 masters) are in ``test_torch_train_bf16.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import programs as jprograms
from repro_torch.configs import get_config, list_archs
from repro_torch.models import programs
from repro_torch.models.convert import params_from_numpy
from repro_torch.core.arena import tree_leaves

B, S = 2, 32
TOL = {"float32": 2e-5, "bfloat16": 5e-2}


def configs(arch: str, dtype: str | None):
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        tcfg = dataclasses.replace(tcfg, dtype=dtype)
    return jcfg, tcfg


def make_batch(cfg, seed: int = 0, batch: int = B, seq: int = S) -> dict:
    """numpy tokens/labels (some labels IGNORE) and, where the family takes
    them, embeddings at the token table's scale."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    labels[:, :3] = programs.IGNORE
    out = {"labels": labels}
    n_tok = seq
    if cfg.family in ("audio", "vlm"):
        n_emb = seq if cfg.family == "audio" else cfg.frontend_tokens
        out["embeds"] = (rng.standard_normal((batch, n_emb, cfg.d_model))
                         * cfg.d_model ** -0.5).astype(np.float32)
        n_tok = seq - n_emb
    if n_tok:
        out["tokens"] = rng.integers(0, cfg.vocab_size,
                                     (batch, n_tok)).astype(np.int32)
    return out


def ref_params(jcfg, seed: int = 0):
    return jprograms.ModelProgram(jcfg).init(jax.random.PRNGKey(seed))


def ref_loss_and_grads(jcfg, jparams, batch):
    jprog = jprograms.ModelProgram(jcfg, remat=False)
    jb = {k: jnp.asarray(v) if k != "embeds"
          else jnp.asarray(v).astype(jnp.dtype(jcfg.dtype))
          for k, v in batch.items()}
    (loss, mets), grads = jax.value_and_grad(jprog.loss_fn, has_aux=True)(
        jparams, jb)
    return float(loss), {k: float(v) for k, v in mets.items()}, grads


def port_batch(tcfg, batch: dict) -> dict:
    from repro_torch.device import torch_dtype
    return {k: torch.from_numpy(v).to(torch_dtype(tcfg.dtype))
            if k == "embeds" else torch.from_numpy(v)
            for k, v in batch.items()}


def port_loss_and_grads(tcfg, params, batch, **kw):
    prog = programs.ModelProgram(tcfg, **kw)
    for p in tree_leaves(params):
        p.requires_grad_(True)
        p.grad = None
    loss, mets = prog.loss_fn(params, port_batch(tcfg, batch))
    loss.backward()
    loss = loss.detach()
    grads = {}

    def collect(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                collect(v, prefix + (k,))
            else:
                grads["/".join(prefix + (k,))] = v.grad.detach().clone()
    collect(params)
    return float(loss), {k: float(v) for k, v in mets.items()}, grads


def flat_ref(tree, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_ref(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float32)
    return out


def grad_errors(got: dict, want: dict) -> dict:
    """{leaf: max |got - want| / max |want|}."""
    assert set(got) == set(want)
    out = {}
    for key, w in want.items():
        g = got[key].float().numpy()
        assert g.shape == w.shape, key
        out[key] = float(np.abs(g - w).max()) / max(float(np.abs(w).max()),
                                                   1e-30)
    return out


def check_loss_and_grads(arch: str, dtype: str | None) -> tuple:
    """Loss, ce, aux within the dtype's tolerance of the reference's;
    returns (reference config, reference params, batch, the reference's
    gradients and the port's, each {leaf: array or tensor})."""
    jcfg, tcfg = configs(arch, dtype)
    tol = TOL[tcfg.dtype]
    jparams = ref_params(jcfg)
    batch = make_batch(tcfg)
    jl, jm, jg = ref_loss_and_grads(jcfg, jparams, batch)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tl, tm, tg = port_loss_and_grads(tcfg, params, batch, remat=False)
    assert np.isfinite(tl)
    np.testing.assert_allclose(tl, jl, rtol=tol, atol=tol)
    np.testing.assert_allclose(tm["ce"], jm["ce"], rtol=tol, atol=tol)
    np.testing.assert_allclose(tm["aux"], jm["aux"], rtol=tol, atol=tol)
    if tcfg.moe is not None:
        assert tm["aux"] > 0
    return jcfg, jparams, batch, flat_ref(jg), tg


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", list_archs())
def test_loss_and_grads_match_reference_fp32(arch):
    *_, jg, tg = check_loss_and_grads(arch, "float32")
    bad = {k: e for k, e in grad_errors(tg, jg).items()
           if e > TOL["float32"]}
    assert not bad, f"max |dg| / max |g| beyond 2e-5: {bad}"


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "granite-moe-1b-a400m",
                                  "zamba2-2.7b"])
def test_remat_gives_the_same_gradients(arch):
    _, tcfg = configs(arch, "float32")
    prog = programs.ModelProgram(tcfg)
    batch = make_batch(tcfg, seed=1)
    out = {}
    for remat in (False, True):
        params = prog.init(0, device="cpu")
        out[remat] = port_loss_and_grads(tcfg, params, batch, remat=remat)
    assert out[True][0] == out[False][0]
    for key, g in out[False][2].items():
        torch.testing.assert_close(out[True][2][key], g, rtol=0, atol=0)


def test_cross_entropy_gather_equals_onehot_and_masks_ignore():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((2, 5, 11))
                              .astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 11, (2, 5)).astype(np.int32))
    labels[0, :2] = programs.IGNORE
    g = programs.cross_entropy(logits, labels, mode="gather")
    o = programs.cross_entropy(logits, labels, mode="onehot")
    torch.testing.assert_close(g, o, rtol=1e-6, atol=1e-6)
    # IGNORE positions are masked: the mean over the other 8 positions
    lp = torch.log_softmax(logits, -1)
    keep = labels != programs.IGNORE
    want = -lp[keep].gather(-1, labels[keep].long()[:, None]).mean()
    torch.testing.assert_close(g, want, rtol=1e-6, atol=1e-6)
    # and agrees with the reference's
    jg = jprograms.cross_entropy(jnp.asarray(logits.numpy()),
                                 jnp.asarray(labels.numpy()))
    np.testing.assert_allclose(float(g), float(jg), rtol=2e-6)
    # all positions ignored: the denominator is clamped to 1, the loss is 0
    assert float(programs.cross_entropy(
        logits, torch.full_like(labels, programs.IGNORE))) == 0.0
    with pytest.raises(ValueError):
        programs.cross_entropy(logits, labels, mode="dense")
