"""One ``make_train_step`` step of the port against the reference's.

Dense, moe and hybrid at reduced size, fp32, B 4, S 16, with ``n_micro`` 1
and 2 and with ``ErrorFeedbackCompression``, from the reference's init
converted by ``params_from_numpy``: loss, grad norm, lr, the updated
params and the optimizer state, fp32 2e-5.

Both packages' AdamW take eps 1e-3 here. A first Adam step moves each
weight by lr * g / (|g| + eps), the sign of g when |g| >> eps, which
magnifies a gradient's rounding difference by up to lr / (4 eps) where
|g| is near eps; and some gradients are nearly zero (the components of
the key bias that the rotary embedding barely turns shift all of a
query's scores alike, which its softmax does not see), so with eps 1e-8
the two frameworks' rounding noise decides those updates. With
eps 1e-3 the step stays close to linear in the gradient, so it holds the
gradients themselves to the reference. The default eps is held by
``test_torch_optim.py``, on the same gradients in both packages.

With compression, an element whose gradient / scale lies within 1e-3 of
a half-integer can round to the other int8 level in the other framework
(a one-ulp difference in the gradient moves it across); such elements,
read off the reference's own gradient, are the only ones let differ,
and their count is printed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_optim import (F32, _train_batch, assert_trees_close, flat,
                              quantization_boundaries)
from repro.configs import get_config as jget_config
from repro.ft.compression import ErrorFeedbackCompression as JEF
from repro.models.programs import ModelProgram as JProgram
from repro.optim import AdamW as JAdamW
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch.configs import get_config
from repro_torch.ft.compression import ErrorFeedbackCompression
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.programs import ModelProgram
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.core.arena import tree_leaves


def _param_key(state_key: str) -> str:
    """The param leaf a state leaf belongs to ("inner/m/<p>",
    "residual/<p>", "m/<p>")."""
    parts = state_key.split("/")
    return "/".join(parts[2:] if parts[0] == "inner" else parts[1:])


@pytest.mark.parametrize("n_micro,compress", [(1, False), (2, False),
                                              (1, True)],
                         ids=["n_micro1", "n_micro2", "compress"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "granite-moe-1b-a400m",
                                  "zamba2-2.7b"])
def test_train_step_matches_reference(arch, n_micro, compress):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    jparams = JProgram(jcfg).init(jax.random.PRNGKey(0))
    batch = _train_batch(tcfg, 4, 16)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jopt = JAdamW(lr=jwarmup_cosine(1e-2, 2, 10), eps=1e-3)
    topt = AdamW(lr=warmup_cosine(1e-2, 2, 10), eps=1e-3)
    if compress:
        jopt, topt = JEF(jopt), ErrorFeedbackCompression(topt)
    jprog = JProgram(jcfg, remat=False)
    jp, js, jm = jprog.make_train_step(jopt, n_micro)(
        jparams, jopt.init(jparams), jb)

    tp = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tstep = ModelProgram(tcfg, remat=False).make_train_step(topt, n_micro)
    tp, ts, tm = tstep(tp, topt.init(tp),
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **F32)
    exempt = None
    if compress:
        jg = jax.grad(lambda p: jprog.loss_fn(p, jb)[0])(jparams)
        near = quantization_boundaries(flat(jg))
        exempt = lambda key: None if key.endswith("step") else \
            near[key if key in near else _param_key(key)]
    n = assert_trees_close(tp, jp, exempt, **F32)
    n += assert_trees_close(ts, js, exempt, **F32)
    if n:
        print(f"{arch}: {n} elements differ at an int8 rounding boundary")
    assert all(not p.requires_grad for p in tree_leaves(tp))
