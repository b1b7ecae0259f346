"""(b) ofb_tpu_torch/ops/gates.py against ofb_tpu/ops/gates.py: values, and
gradients with respect to alpha and score, including ties (dead channels
at -inf, all-ones scores), killed cells and finished modules.

Tolerance: fp32 on both sides; the two frameworks sum in other orders, so
values agree to a few ulp (rtol 1e-5, atol 1e-6). Integer-valued results
(ranks through the gather) must be equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofb_tpu.models.search_space import AttnSpace, DimSpace
from ofb_tpu.ops import gates as JG
from ofb_tpu_torch.ops import gates as G

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6


def t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a.detach() if torch.is_tensor(a)
                                          else a), np.asarray(b),
                               rtol=kw.get("rtol", RTOL),
                               atol=kw.get("atol", ATOL))


def dim_case(kind, rng):
    """(score, alpha, switch, bank, hard_mask, w_p, finished) of a 1-D
    width of 48 channels."""
    space = DimSpace(48, tuple(i / 48 for i in range(12, 49, 6)))
    K = space.num_cells
    score = rng.normal(0, 0.2, 48).astype(np.float32)
    alpha = rng.uniform(0, 1, K).astype(np.float32)
    switch = np.ones(K, bool)
    hard = np.ones(48, np.float32)
    finished = False
    if kind == "ties":              # a non-searchable score: all ones
        score = np.ones(48, np.float32)
    elif kind == "pruned":          # killed cells, dead channels, ties
        switch[[0, 3]] = False
        hard[-7:] = 0.0
        score[5:9] = score[4]
    elif kind == "finished":
        finished = True
        score = np.where(hard > 0, rng.uniform(0.2, 1, 48), 0).astype(np.float32)
    return (score, alpha, switch, space.mask_bank, hard,
            np.float32(0.7), np.bool_(finished))


def attn_case(kind, rng, H=4, d=16):
    space = AttnSpace.build(H, d)
    kh, kc = space.num_cells
    shape = {"head": (H, 1), "chan": (1, d)}.get(kind, (H, d))
    score = rng.normal(0, 0.2, shape).astype(np.float32)
    alpha = rng.uniform(0, 1, (kh, kc)).astype(np.float32)
    switch = np.ones((kh, kc), bool)
    hard = np.ones((H, d), np.float32)
    finished = False
    if kind == "ties":
        score = np.ones((H, d), np.float32)
    elif kind == "pruned":
        switch[0, :2] = False
        hard[2, :] = 0.0            # a whole dead head
        hard[1, -5:] = 0.0
        score[0, 3:6] = score[0, 2]
    elif kind == "finished":
        finished = True
    return (score, alpha, switch, space.mask_bank, hard, np.float32(0.3),
            np.bool_(finished))


def test_masked_softmax_matches():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 5)).astype(np.float32)
    sw = rng.uniform(size=(3, 5)) > 0.3
    close(G.masked_softmax(t(a), t(sw)), JG.masked_softmax(a, sw))
    assert float(G.masked_softmax(t(a), t(sw))[~t(sw)].abs().sum()) == 0.0


@pytest.mark.parametrize("kind", ["plain", "ties", "pruned", "finished"])
def test_gate_1d_values_and_grads(kind):
    rng = np.random.default_rng(1)
    score, alpha, switch, bank, hard, w_p, fin = dim_case(kind, rng)
    cot = rng.normal(size=48).astype(np.float32)

    wm = JG.weighted_mask_1d(alpha, switch, bank)
    close(G.weighted_mask_1d(t(alpha), t(switch), t(bank)), wm)
    np.testing.assert_array_equal(
        G.rank_restore_1d(t(np.arange(48, dtype=np.float32)), t(score),
                          t(hard)).numpy(),
        JG.rank_restore_1d(jnp.arange(48.0), score, hard))

    def jloss(s, a):
        g, r = JG.bimask_gate_1d(s, a, switch, bank, hard, w_p, fin)
        return jnp.sum(g * cot) + jnp.sum(r * cot[::-1])

    ts, ta = t(score, True), t(alpha, True)
    g, r = G.bimask_gate_1d(ts, ta, t(switch), t(bank), t(hard), t(w_p),
                            t(fin))
    jg, jr = JG.bimask_gate_1d(score, alpha, switch, bank, hard, w_p, fin)
    close(g, jg)
    close(r, jr)
    (g * t(cot)).sum().add((r * t(cot[::-1].copy())).sum()).backward()
    gs, ga = jax.grad(jloss, argnums=(0, 1))(score, alpha)
    close(ts.grad, gs)
    close(ta.grad, ga)


@pytest.mark.parametrize("kind", ["plain", "head", "chan", "ties", "pruned",
                                  "finished"])
def test_gate_attn_values_and_grads(kind):
    rng = np.random.default_rng(2)
    score, alpha, switch, bank, hard, w_p, fin = attn_case(kind, rng)
    cot = rng.normal(size=hard.shape).astype(np.float32)

    close(G.weighted_mask_attn(t(alpha), t(switch), t(bank)),
          JG.weighted_mask_attn(alpha, switch, bank))
    vals = np.arange(hard.size, dtype=np.float32).reshape(hard.shape)
    np.testing.assert_array_equal(
        G.rank_restore_attn(t(vals), t(score), t(hard)).numpy(),
        JG.rank_restore_attn(vals, score, hard))

    def jloss(s, a):
        g, r = JG.bimask_gate_attn(s, a, switch, bank, hard, w_p, fin)
        return jnp.sum(g * cot) + jnp.sum(r * cot ** 2)

    ts, ta = t(score, True), t(alpha, True)
    g, r = G.bimask_gate_attn(ts, ta, t(switch), t(bank), t(hard), t(w_p),
                              t(fin))
    jg, jr = JG.bimask_gate_attn(score, alpha, switch, bank, hard, w_p, fin)
    close(g, jg)
    close(r, jr)
    ((g * t(cot)).sum() + (r * t(cot ** 2)).sum()).backward()
    gs, ga = jax.grad(jloss, argnums=(0, 1))(score, alpha)
    close(ts.grad, gs)
    close(ta.grad, ga)


@pytest.mark.parametrize("passthrough", ["zero", "identity"])
@pytest.mark.parametrize("dead", [0, 5])
def test_masked_layer_norm_values_and_grads(passthrough, dead):
    rng = np.random.default_rng(3)
    x = rng.normal(1.0, 2.0, (2, 7, 24)).astype(np.float32)
    mask = rng.uniform(0.1, 1, 24).astype(np.float32)   # a soft support
    mask[:dead] = 0.0
    scale = rng.normal(1, 0.1, 24).astype(np.float32)
    bias = rng.normal(0, 0.1, 24).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)

    def jf(x, sc, b):
        return jnp.sum(JG.masked_layer_norm(x, mask, sc, b,
                                            passthrough=passthrough) * cot)

    tx, ts, tb = t(x, True), t(scale, True), t(bias, True)
    out = G.masked_layer_norm(tx, t(mask), ts, tb, passthrough=passthrough)
    close(out, JG.masked_layer_norm(x, mask, scale, bias,
                                    passthrough=passthrough), atol=1e-5)
    (out * t(cot)).sum().backward()
    for mine, theirs in zip((tx, ts, tb),
                            jax.grad(jf, argnums=(0, 1, 2))(x, scale, bias)):
        close(mine.grad, theirs, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError):
        G.masked_layer_norm(tx, t(mask), ts, tb, passthrough="other")


def test_layer_norm():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    s = rng.normal(size=16).astype(np.float32)
    b = rng.normal(size=16).astype(np.float32)
    close(G.layer_norm(t(x), t(s), t(b)), JG.layer_norm(x, s, b), atol=1e-5)


def test_gates_on_a_stack_equal_each_module():
    """The forward computes every block's gate at once on stacked tensors
    (models/mim_vit.py `block_gates`): the same values as one at a time,
    up to the last bit of the batched einsum's sums (atol 1e-7)."""
    rng = np.random.default_rng(5)
    cases = [attn_case(k, rng) for k in ("plain", "ties", "pruned", "finished")]
    stacked = [t(np.stack([c[i] for c in cases])) for i in (0, 1, 2, 4, 5, 6)]
    s, a, sw, hm, wp, fin = stacked
    g, r = G.bimask_gate_attn(s, a, sw, t(cases[0][3]), hm, wp, fin)
    for i, c in enumerate(cases):
        gi, ri = G.bimask_gate_attn(*map(t, c))
        close(g[i], gi, rtol=1e-6, atol=1e-7)
        close(r[i], ri, rtol=1e-6, atol=1e-7)
    cases = [dim_case(k, rng) for k in ("plain", "ties", "pruned", "finished")]
    s, a, sw, hm, wp, fin = [t(np.stack([c[i] for c in cases]))
                             for i in (0, 1, 2, 4, 5, 6)]
    g, r = G.bimask_gate_1d(s, a, sw, t(cases[0][3]), hm, wp, fin)
    for i, c in enumerate(cases):
        gi, ri = G.bimask_gate_1d(*map(t, c))
        close(g[i], gi, rtol=1e-6, atol=1e-7)
        close(r[i], ri, rtol=1e-6, atol=1e-7)
