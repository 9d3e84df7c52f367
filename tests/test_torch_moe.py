"""repro_torch's MoE layer against the reference, on the CPU.

The reference's ``init_moe`` draws the weights, ``params_from_numpy``
converts them, and both packages route the same numpy-drawn activations.
``apply_moe``'s output and aux loss are compared, and so is the routing:
the reference's top-k experts (read from its ``jax.lax.top_k`` call) must
equal the port's, and the port's kept mask must equal the capacity rule
applied, choice by choice in the reference's stable sorted order, to the
reference's experts. Cases: the ``reduced()`` config (fp32 and bf16), a
capacity factor of 1.25 with enough tokens that some drop, a group of more
than 64 tokens (capacity rounded up to a multiple of 4), 4096 tokens in two
route groups, and decode with one group per row.

Tolerances: fp32 2e-5 (summation order), bf16 5e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import params_from_numpy

ARCH = "granite-moe-1b-a400m"
F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)


def configs(dtype="float32", **moe):
    """The reference's and the port's reduced granite-moe config, with
    ``moe`` overriding fields of its MoEConfig."""
    out = []
    for get in (jget_config, get_config):
        cfg = get(ARCH).reduced()
        out.append(dataclasses.replace(
            cfg, dtype=dtype, moe=dataclasses.replace(cfg.moe, **moe)))
    return out


def weights(jcfg, seed=0, dtype=jnp.float32):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    jp = jax.tree.map(lambda x: x.astype(dtype), jp)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def activations(B, S, D, seed, skew=0.0):
    """Standard normal rows plus ``skew`` times one shared random
    direction, which favours some experts over others, as the common
    component of real hidden states does."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)) + skew * rng.standard_normal(D)
    return x.astype(np.float32)


def reference_moe(jp, x, jcfg, G, monkeypatch):
    """(out, aux, gate_idx) of the reference's apply_moe; gate_idx is what
    its ``jax.lax.top_k`` call returned."""
    seen = {}
    top_k = jax.lax.top_k

    def spy(operand, k):
        vals, idx = top_k(operand, k)
        seen["gate_idx"] = np.asarray(idx)
        return vals, idx

    with monkeypatch.context() as m:
        m.setattr(jax.lax, "top_k", spy)
        out, aux = jmoe.apply_moe(jp, x, jcfg, G)
    return np.asarray(out, np.float32), float(aux), seen["gate_idx"]


def kept_by_capacity(gate_idx: np.ndarray, C: int) -> np.ndarray:
    """The capacity rule, one choice at a time: within each group, the
    choices of expert e in (token, choice) order take e's slots 0..C-1,
    and the rest are dropped."""
    G, Tg, K = gate_idx.shape
    kept = np.zeros(gate_idx.shape, bool)
    for g in range(G):
        used = {}
        for t in range(Tg):
            for k in range(K):
                e = int(gate_idx[g, t, k])
                kept[g, t, k] = used.get(e, 0) < C
                used[e] = used.get(e, 0) + 1
    return kept


def check_moe(jcfg, tcfg, x, G, monkeypatch, tol, seed=0):
    jdt = jnp.bfloat16 if tcfg.dtype == "bfloat16" else jnp.float32
    jp, tp = weights(jcfg, seed, jdt)
    want, want_aux, want_idx = reference_moe(
        jp, jnp.asarray(x).astype(jdt), jcfg, G, monkeypatch)
    tx = torch.from_numpy(x)
    if tcfg.dtype == "bfloat16":
        tx = tx.to(torch.bfloat16)
    got, aux = tmoe.apply_moe(tp, tx, tcfg, G)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    np.testing.assert_allclose(float(aux), want_aux, **F32_TOL)

    B, S, D = x.shape
    Tg = B * S // G
    C = tmoe._capacity(Tg, tcfg)
    assert C == jmoe._capacity(Tg, jcfg)
    r = tmoe.route(tp, tx.reshape(G, Tg, D), tcfg, C)
    np.testing.assert_array_equal(r.gate_idx.numpy(), want_idx)
    E = tcfg.moe.num_experts
    kept = (r.choice_slot < E * C).numpy()
    np.testing.assert_array_equal(kept, kept_by_capacity(want_idx, C))
    return kept, C


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_moe_matches_reference_at_reduced(dtype, monkeypatch):
    jcfg, tcfg = configs(dtype)
    x = activations(2, 12, tcfg.d_model, seed=1)
    kept, _ = check_moe(jcfg, tcfg, x, 1, monkeypatch,
                        BF16_TOL if dtype == "bfloat16" else F32_TOL)
    assert kept.all()                  # capacity 4.0: nothing drops


def test_apply_moe_drops_at_capacity_as_reference(monkeypatch):
    """granite-moe's own routing (32 experts, top-8, capacity factor 1.25)
    at a 128-token prefill: C = 40 against a mean load of 32, so with
    activations that favour some experts, those overflow and drop
    choices."""
    jcfg, tcfg = configs(num_experts=32, top_k=8, capacity_factor=1.25)
    x = activations(1, 128, tcfg.d_model, seed=2, skew=1.0)
    kept, C = check_moe(jcfg, tcfg, x, 1, monkeypatch, F32_TOL)
    assert C == 40
    assert 0 < (~kept).sum() < kept.size          # the drop path ran


def test_apply_moe_rounds_capacity_of_large_groups(monkeypatch):
    """A group of more than 64 tokens rounds its capacity up to a multiple
    of 4: 70 tokens x 2 / 4 experts x 1.25 = 43 -> 44."""
    jcfg, tcfg = configs(capacity_factor=1.25)
    x = activations(2, 35, tcfg.d_model, seed=3)
    _, C = check_moe(jcfg, tcfg, x, 1, monkeypatch, F32_TOL)
    assert C == 44


def test_apply_moe_two_route_groups(monkeypatch):
    """4096 tokens route in two groups of 2048, each with its own
    capacity and sort."""
    jcfg, tcfg = configs(capacity_factor=1.25)
    B, S = 2, 2048
    G = tmoe.n_route_groups(B * S, "other", B)
    assert G == jmoe.n_route_groups(B * S, "other", B) == 2
    x = activations(B, S, tcfg.d_model, seed=4)
    check_moe(jcfg, tcfg, x, G, monkeypatch, F32_TOL)


def test_apply_moe_decode_routes_each_row_alone(monkeypatch):
    """Decode: one group per row (G = B), capacity max(4, .) = 4, so no
    choice drops and one row's routing cannot depend on another's."""
    jcfg, tcfg = configs(num_experts=32, top_k=8, capacity_factor=1.25)
    B = 4
    G = tmoe.n_route_groups(B, "decode", B)
    assert G == B
    x = activations(B, 1, tcfg.d_model, seed=5)
    kept, C = check_moe(jcfg, tcfg, x, G, monkeypatch, F32_TOL)
    assert C == 4 and kept.all()
    _, tp = weights(jcfg)
    tx = torch.from_numpy(x)
    full = tmoe.route(tp, tx.reshape(B, 1, -1), tcfg, C)
    alone = tmoe.route(tp, tx[2:3].reshape(1, 1, -1), tcfg, C)
    for a, b in zip(full, alone):
        if a.dtype == torch.int64:                 # the routing decisions
            assert torch.equal(a[2:3], b)
        elif a.dim():                              # gates: summation order
            np.testing.assert_allclose(a[2:3].numpy(), b.numpy(), **F32_TOL)
    np.testing.assert_allclose(
        tmoe.apply_moe(tp, tx, tcfg, G)[0][2:3].numpy(),
        tmoe.apply_moe(tp, tx[2:3], tcfg, 1)[0].numpy(), **F32_TOL)


def test_group_count_and_capacity_match_reference():
    _, tcfg = configs(num_experts=32, top_k=8, capacity_factor=1.25)
    jcfg, _ = configs(num_experts=32, top_k=8, capacity_factor=1.25)
    for n, kind, b in [(128, "other", 1), (2048, "other", 1),
                       (4096, "other", 2), (6144, "other", 3),
                       (4, "decode", 4), (1, "decode", 1)]:
        assert tmoe.n_route_groups(n, kind, b) == \
            jmoe.n_route_groups(n, kind, b)
    for tg in (1, 4, 63, 64, 65, 128, 500, 2048):
        assert tmoe._capacity(tg, tcfg) == jmoe._capacity(tg, jcfg)
    with pytest.raises(AssertionError):            # not a whole group count
        tmoe.n_route_groups(3000, "other", 1)


def test_top_k_ties_put_the_lower_expert_first(monkeypatch):
    """A zero router gives every expert the same probability: the
    reference's lax.top_k then picks experts 0..K-1 in order, and so must
    the port."""
    jcfg, tcfg = configs()
    jp, tp = weights(jcfg)
    jp["router"] = jnp.zeros_like(jp["router"])
    tp["router"] = torch.zeros_like(tp["router"])
    x = activations(1, 6, tcfg.d_model, seed=6)
    want, _, want_idx = reference_moe(jp, x, jcfg, 1, monkeypatch)
    K = tcfg.moe.top_k
    assert (want_idx == np.arange(K)).all()
    r = tmoe.route(tp, torch.from_numpy(x), tcfg, 8)
    assert (r.gate_idx.numpy() == np.arange(K)).all()
    got, _ = tmoe.apply_moe(tp, torch.from_numpy(x), tcfg, 1)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_combine_equals_a_scatter_add_and_is_repeatable():
    """The gather combine against the reference's formulation, a
    scatter-add of the gated slots onto their tokens (in float64 here),
    with drops; and two calls are bit-equal."""
    _, tcfg = configs(num_experts=32, top_k=8, capacity_factor=1.25)
    jcfg, _ = configs(num_experts=32, top_k=8, capacity_factor=1.25)
    _, tp = weights(jcfg, seed=7)
    x = torch.from_numpy(activations(1, 128, tcfg.d_model, seed=7,
                                     skew=1.0))
    out, _ = tmoe.apply_moe(tp, x, tcfg, 1)
    assert torch.equal(out, tmoe.apply_moe(tp, x, tcfg, 1)[0])

    E, C, D = 32, tmoe._capacity(128, tcfg), tcfg.d_model
    r = tmoe.route(tp, x.reshape(1, 128, D), tcfg, C)
    p64 = {k: v.double() for k, v in tp.items()}
    x_pad = torch.cat([x[0].double(), torch.zeros(1, D, dtype=torch.float64)])
    ex_in = x_pad[r.slot_tok[0]].view(E, C, D)
    h = torch.nn.functional.silu(torch.einsum("ecd,edf->ecf", ex_in,
                                              p64["w_gate"])) * \
        torch.einsum("ecd,edf->ecf", ex_in, p64["w_up"])
    ex_out = torch.einsum("ecf,efd->ecd", h, p64["w_down"]).reshape(E * C, D)
    want = torch.zeros(129, D, dtype=torch.float64).index_add_(
        0, r.slot_tok[0], ex_out * r.slot_gate[0, :, None].double())[:128]
    assert (r.choice_slot == E * C).any()          # some choices dropped
    np.testing.assert_allclose(out[0].numpy(), want.numpy(), **F32_TOL)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "dbrx-132b",
                                  "musicgen-large"])
def test_init_params_tree_matches_reference(arch):
    """The moe family holds "moe" in place of "mlp"; audio has no "embed"
    table and always an "lm_head"."""
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = ttf.init_params(torch.Generator().manual_seed(0), tcfg)
    jl, jdef = jax.tree.flatten(jax.tree.map(lambda x: x.shape, jp))
    tl, tdef = jax.tree.flatten(jax.tree.map(lambda x: tuple(x.shape), tp))
    assert jdef == tdef and jl == tl
    if tcfg.family == "moe":
        assert "moe" in tp["layers"] and "mlp" not in tp["layers"]
        assert set(tp["layers"]["moe"]) == {"router", "w_up", "w_gate",
                                            "w_down"}
    else:
        assert "embed" not in tp and "lm_head" in tp

