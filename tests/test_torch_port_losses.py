"""(f) ofb_tpu_torch/ops/flops.py and core/losses.py against the JAX
package: FLOPs model, FLOPs loss and the OFB arch loss, in values and in
gradients with respect to the alphas (and the scores), for a fresh and a
pruned arch state; and the classification criteria.

Tolerance: fp32 on both sides. The arch loss is dominated by the
tan-variance term, whose slope near its asymptote magnifies input ulps:
rtol 1e-5 on values, 1e-4 on gradients, atol 1e-6 (gradients of a few
near-zero leaves).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofb_tpu.core import losses as JL
from ofb_tpu.ops import flops as JF
from ofb_tpu_torch.core import losses as L
from ofb_tpu_torch.models.from_jax import flatten_from_jax
from ofb_tpu_torch.ops import flops as F
from test_torch_port_from_jax import (TINY, jax_supernet, np_tree,
                                      port_supernet, pruned_arch)

torch.set_num_threads(1)


def setup(pruned):
    jcfg, jspace, jp, ja, jarch = jax_supernet(TINY, seed=3)
    if pruned:
        jarch = pruned_arch(jarch)
        jarch = jarch.replace(patch=jarch.patch.replace(
            switch=jarch.patch.switch.at[4].set(False),
            pruned_once=jnp.asarray(True)))
    return (jcfg, jspace, jp, ja, jarch), port_supernet(TINY, jp, ja, jarch)


def grads_close(module, jgrads, rtol=1e-4, atol=1e-6):
    want = flatten_from_jax(np_tree(jgrads))
    for name, p in module.named_parameters():
        got = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        np.testing.assert_allclose(got, want[name], rtol=rtol, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("pruned", [False, True])
def test_model_flops_and_flops_loss(pruned):
    (jcfg, jspace, jp, ja, jarch), (cfg, space, params, alphas, arch) = \
        setup(pruned)
    jt, js = JF.model_flops(ja, jarch, jspace, jcfg)
    t, s = F.model_flops(alphas, arch, space, cfg)
    assert t == pytest.approx(float(jt), rel=1e-6)
    assert s.item() == pytest.approx(float(js), rel=1e-5)

    def jloss(a):
        return JF.flops_loss(a, jarch, jspace, jcfg, 0.0002)[0]

    loss, searched = F.flops_loss(alphas, arch, space, cfg, 0.0002)
    assert loss.item() == pytest.approx(float(jloss(ja)), rel=1e-5)
    loss.backward()
    grads_close(alphas, jax.grad(jloss)(ja))

    jtp, jsp = JF.searched_params_count(ja, jarch, jspace, jcfg)
    tp, sp = F.searched_params_count(alphas, arch, space, cfg)
    assert tp == pytest.approx(float(jtp), rel=1e-6)
    assert sp.item() == pytest.approx(float(jsp), rel=1e-5)


@pytest.mark.parametrize("pruned", [False, True])
def test_ofb_arch_loss_values_and_grads(pruned):
    (jcfg, jspace, jp, ja, jarch), (cfg, space, params, alphas, arch) = \
        setup(pruned)
    kw = dict(target_flops=0.0002, w_head=0.5, w_mlp=0.5, w_patch=0.3,
              w_embedding=0.5, w_flops=5.0)

    def jloss(p, a):
        return JL.ofb_arch_loss(p, a, jarch, jspace, jcfg, **kw)

    (jl, jaux) = jloss(jp, ja)
    loss, aux = L.ofb_arch_loss(params, alphas, arch, space, cfg, **kw)
    assert loss.item() == pytest.approx(float(jl), rel=1e-5)
    for k, v in jaux.items():
        assert aux[k].item() == pytest.approx(float(v), rel=1e-5, abs=1e-7), k
    loss.backward()
    gp, ga = jax.grad(lambda p, a: jloss(p, a)[0], argnums=(0, 1))(jp, ja)
    grads_close(alphas, ga)
    grads_close(params, gp)       # the score-norm terms reach the scores


def test_classification_criteria():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(5, 7)).astype(np.float32) * 3
    labels = rng.integers(0, 7, 5)
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    assert float(L.cross_entropy(tl, tlab)) == pytest.approx(
        float(JL.cross_entropy(logits, labels)), rel=1e-6)
    assert float(L.label_smoothing_ce(tl, tlab, 0.1)) == pytest.approx(
        float(JL.label_smoothing_ce(logits, labels, 0.1)), rel=1e-6)
    soft = rng.dirichlet(np.ones(7), 5).astype(np.float32)
    assert float(L.soft_target_ce(tl, torch.from_numpy(soft))) == \
        pytest.approx(float(JL.soft_target_ce(logits, soft)), rel=1e-6)
    for smooth in (0.0, 0.1):
        assert float(L.base_criterion(tl, tlab, soft_labels=False,
                                      smoothing=smooth)) == pytest.approx(
            float(JL.base_criterion(logits, labels, soft_labels=False,
                                    smoothing=smooth)), rel=1e-6)


@pytest.mark.parametrize("kind", ["none", "soft", "hard"])
def test_distillation_loss_matches(kind):
    """Value and gradient in the student's logits; the teacher's logits
    get none. rel 1e-6 (fp32 log-softmax sums)."""
    rng = np.random.default_rng(1)
    s = rng.normal(size=(6, 9)).astype(np.float32) * 2
    t = rng.normal(size=(6, 9)).astype(np.float32) * 2
    base = np.float32(1.7)
    kw = dict(kind=kind, alpha=0.3, tau=2.5)
    want, jgrad = jax.value_and_grad(
        lambda s_: JL.distillation_loss(jnp.asarray(base), s_, jnp.asarray(t),
                                        **kw))(jnp.asarray(s))
    ts = torch.from_numpy(s).requires_grad_()
    tt = torch.from_numpy(t).requires_grad_()
    got = L.distillation_loss(torch.tensor(base), ts, tt, **kw)
    assert got.item() == pytest.approx(float(want), rel=1e-6)
    if kind != "none":
        got.backward()
        np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jgrad),
                                   rtol=1e-5, atol=1e-8)
        assert tt.grad is None
    assert float(L.distillation_loss(torch.tensor(base), ts, None, **kw)) \
        == pytest.approx(float(base))
    with pytest.raises(ValueError):
        L.distillation_loss(torch.tensor(base), ts, tt, kind="cosine",
                            alpha=0.5, tau=1.0)


@pytest.mark.parametrize("soft", [False, True])
def test_distilled_pair_loss_matches(soft):
    rng = np.random.default_rng(2)
    a = rng.normal(size=(5, 7)).astype(np.float32) * 3
    b = rng.normal(size=(5, 7)).astype(np.float32) * 3
    labels = rng.dirichlet(np.ones(7), 5).astype(np.float32) if soft \
        else rng.integers(0, 7, 5)
    kw = dict(soft_labels=soft, smoothing=0.1)
    want, (ga, gb) = jax.value_and_grad(
        lambda x, y: JL.distilled_pair_loss(x, y, jnp.asarray(labels), **kw),
        argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    got = L.distilled_pair_loss(ta, tb, torch.from_numpy(labels), **kw)
    assert got.item() == pytest.approx(float(want), rel=1e-6)
    got.backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), rtol=1e-5,
                               atol=1e-7)
